"""Offline place-recognition vocabulary training.

Port of the JAX repository's ``tools/train_vocab.py``. The reference loads
a pre-trained 1M-word ORBvoc (k=10, L=6) at startup; the shipped
``ygz_tpu_torch/data/orb_vocab.npz`` is its synthetic counterpart,
hierarchical k-medians over ORB descriptors of many rendered scenes
(default k=10, L=5, ~10^5 words). The descriptor corpus is extracted by the
port's ``OrbExtractor`` on the card (the FAST kernel included); the
training (``backend/bow.py::train_vocabulary``) is host numpy. The output
goes under ``build/`` by default and never overwrites the shipped copy
unless ``--out`` names it.

    python -m ygz_tpu_torch.tools.train_vocab [--device cpu]
        [--out build/ygz_tpu_torch/orb_vocab.npz] [--branching 10]
        [--depth 5] [--scenes 48] [--views 12]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from . import resolve_device
from ..utils.cuda_build import BUILD_DIR


def extract_corpus(scenes, views, device, log=print):
    """(descriptors [M, 256] 0/1, image ids [M]) of `views` random views of
    each of `scenes` synthetic scenes (plane, smooth and terraced relief in
    turn, seeds 100...)."""
    import torch

    from ..frontend.extractor import OrbExtractor
    from ..frontend.framestep import build_pyramid_stacked
    from ..geometry.lie import so3_exp
    from ..utils.synthetic import PlaneScene, SmoothScene, StepScene

    extractor = OrbExtractor(n_features=1024, n_levels=4, scale_factor=2.0,
                             fast_th=20.0, fast_th_min=7.0, mode="grid")
    descs, docs = [], []
    doc = 0
    kinds = [SmoothScene, StepScene, PlaneScene]
    for s in range(scenes):
        scene = kinds[s % len(kinds)](seed=100 + s, tex_size=1600)
        rng = np.random.default_rng(s)
        for _ in range(views):
            w = rng.normal(0, 0.05, 3).astype(np.float32)
            R = so3_exp(torch.as_tensor(w)).numpy()
            c = np.array([rng.uniform(-1, 1), rng.uniform(-0.7, 0.7),
                          rng.uniform(-0.5, 0.5)], np.float32)
            t = (-R @ c).astype(np.float32)
            img = torch.as_tensor(scene.render(R, t), device=device)
            feats = extractor(build_pyramid_stacked(img, None, 4))
            valid = feats.valid.cpu().numpy()
            d = feats.desc.cpu().numpy()[valid]
            descs.append(d)
            docs.append(np.full(len(d), doc, np.int64))
            doc += 1
        log(f"scene {s + 1}/{scenes}: {sum(len(d) for d in descs)} "
            f"descriptors")
    return np.concatenate(descs), np.concatenate(docs)


def train(desc, doc_ids, branching, depth, out, log=print):
    from ..backend.bow import save_vocabulary, train_vocabulary

    t0 = time.time()
    log(f"training k={branching} L={depth} on {len(desc)} descriptors ...")
    vocab = train_vocabulary(desc, branching=branching, depth=depth,
                             doc_ids=doc_ids)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_vocabulary(vocab, out)
    log(f"saved {vocab.n_words} words -> {out} "
        f"({os.path.getsize(out) / 1e6:.2f} MB) in {time.time() - t0:.0f}s")
    return vocab


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(BUILD_DIR / "orb_vocab.npz"))
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--scenes", type=int, default=48)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--desc-cache", default=str(BUILD_DIR /
                                                "vocab_corpus.npz"),
                    help="descriptor-corpus cache, reused by a retry with "
                         "the same --scenes and --views ('' for none)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    key = (args.scenes, args.views)
    if args.desc_cache and os.path.exists(args.desc_cache):
        z = np.load(args.desc_cache)
        if tuple(z["key"]) == key:
            print(f"descriptor corpus from cache: {len(z['desc'])}",
                  flush=True)
            return train(np.unpackbits(z["desc"], axis=1), z["doc_ids"],
                         args.branching, args.depth, args.out)
    desc, doc_ids = extract_corpus(args.scenes, args.views, device)
    if args.desc_cache:
        os.makedirs(os.path.dirname(os.path.abspath(args.desc_cache)),
                    exist_ok=True)
        np.savez_compressed(args.desc_cache, key=np.array(key),
                            desc=np.packbits(desc, axis=1), doc_ids=doc_ids)
    return train(desc, doc_ids, args.branching, args.depth, args.out)


if __name__ == "__main__":
    main()
