"""Parity of the torch port's place recognition with the JAX package:
vocabulary training and tree lookup (the shipped vocabulary included), the
sparse tf-idf keyframe index, the flat chunked word lookup, and the
FeatureVector group gate of the matcher. Same numpy inputs, made from a
seed, through both packages; everything here is compared exactly."""
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_tpu.backend import bow as jbow
from ygz_tpu.ops import matching as jmatch
from ygz_tpu_torch.backend import bow as tbow
from ygz_tpu_torch.frontend.extractor import OrbExtractor
from ygz_tpu_torch.frontend.framestep import build_pyramid_stacked
from ygz_tpu_torch.ops import matching as tmatch
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import t_


def _places(seed=0, n_kf=6, n_desc=120):
    rng = np.random.default_rng(seed)
    places = [rng.integers(0, 2, (n_desc, 256)).astype(np.uint8)
              for _ in range(n_kf)]
    return rng, places


def _noisy(rng, desc, flips=12):
    out = desc.copy()
    for i in range(len(out)):
        out[i, rng.choice(256, flips, replace=False)] ^= 1
    return out


def _assert_vocab_equal(a, b):
    for name in ("words", "groups", "idf", "tree_centers", "tree_child"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert (a.branching, a.depth, a.tree_root) == \
        (b.branching, b.depth, b.tree_root)


@pytest.mark.parametrize("branching,depth", [(8, 2), (6, 3)])
def test_train_vocabulary_matches_jax(branching, depth, tmp_path):
    """Equal vocabularies for the same seed, and one file format: each
    package loads what the other saved."""
    _, places = _places()
    train = np.concatenate(places)
    doc = np.repeat(np.arange(len(places)), len(places[0]))
    vj = jbow.train_vocabulary(train, branching=branching, depth=depth,
                               doc_ids=doc, seed=3)
    vt = tbow.train_vocabulary(train, branching=branching, depth=depth,
                               doc_ids=doc, seed=3)
    _assert_vocab_equal(vt, vj)
    tbow.save_vocabulary(vt, str(tmp_path / "t.npz"))
    jbow.save_vocabulary(vj, str(tmp_path / "j.npz"))
    _assert_vocab_equal(jbow.load_vocabulary(str(tmp_path / "t.npz")), vj)
    _assert_vocab_equal(tbow.load_vocabulary(str(tmp_path / "j.npz")), vt)


def test_shipped_vocabulary_words_match_jax():
    """The port ships its own copy of the JAX package's vocabulary (the
    same bytes, inside ygz_tpu_torch/); the tree lookup of a real frame's
    ORB descriptors (the port's extractor on a SmoothScene frame) gives
    the same word ids."""
    pt, pj = tbow.default_vocabulary_path(), jbow.default_vocabulary_path()
    port_root = os.path.dirname(os.path.dirname(os.path.abspath(
        tbow.__file__)))
    assert os.path.commonpath([os.path.abspath(pt), port_root]) == port_root
    assert not os.path.samefile(pt, pj)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert (hashlib.sha256(a.read()).digest()
                == hashlib.sha256(b.read()).digest())
    vt, vj = tbow.load_vocabulary(pt), jbow.load_vocabulary(pj)
    _assert_vocab_equal(vt, vj)
    assert vt.n_words == 99478 and (vt.branching, vt.depth) == (10, 5)
    scene = SmoothScene(seed=11)
    img = torch.as_tensor(scene.render_u8(np.eye(3, dtype=np.float32),
                                          np.zeros(3, np.float32)))
    f = OrbExtractor(n_features=512)(build_pyramid_stacked(img, None, 4))
    desc, valid = f.desc.numpy(), f.valid.numpy()
    assert valid.sum() > 300
    wt = tbow.assign_words_tree(desc, valid, vt)
    np.testing.assert_array_equal(wt, jbow.assign_words_tree(desc, valid, vj))
    assert (wt[valid] >= 0).all() and (wt[~valid] == -1).all()
    # index both ways; a frame's own bow ranks its keyframe first
    it = tbow.BowIndex(vt, max_kf=4, device="cpu")
    ij = jbow.BowIndex(vj, max_kf=4)
    (wq, bq), (wqj, bqj) = it.quantize(desc, valid), ij.quantize(desc, valid)
    np.testing.assert_array_equal(wq, wqj)
    np.testing.assert_array_equal(bq[0], bqj[0])
    np.testing.assert_array_equal(bq[1], bqj[1])
    it.add_keyframe(2, bq, feat_wid=wq)
    ij.add_keyframe(2, bqj, feat_wid=wqj)
    np.testing.assert_array_equal(it.feat_groups(2), ij.feat_groups(2))
    assert it.reloc_candidates(bq) == ij.reloc_candidates(bqj) == [2]


def _indexes():
    rng, places = _places()
    train = np.concatenate(places)
    doc = np.repeat(np.arange(len(places)), len(places[0]))
    vj = jbow.train_vocabulary(train, branching=8, depth=2, doc_ids=doc)
    vt = tbow.train_vocabulary(train, branching=8, depth=2, doc_ids=doc)
    ij = jbow.BowIndex(vj, max_kf=4)
    it = tbow.BowIndex(vt, max_kf=4, device="cpu")
    for k, d in enumerate(places):   # 6 KFs: the index grows past max_kf
        ones = np.ones(len(d), bool)
        wj, bj = ij.quantize(d, ones)
        wt, bt = it.quantize(d, ones)
        ij.add_keyframe(k, bj, feat_wid=wj)
        it.add_keyframe(k, bt, feat_wid=wt)
    return rng, places, ij, it


@pytest.mark.parametrize("culled", [False, True])
def test_bow_index_matches_jax(culled):
    rng, places, ij, it = _indexes()
    if culled:   # the tracker's sync after keyframe culling
        ij.kf_valid[3] = it.kf_valid[3] = False
    for name in ("kf_wid", "kf_w", "kf_feat_word", "kf_valid"):
        np.testing.assert_array_equal(getattr(it, name), getattr(ij, name))
    for k in range(len(places)):
        q = _noisy(rng, places[k])
        valid = rng.random(len(q)) > 0.1
        wj, bj = ij.quantize(q, valid)
        wt, bt = it.quantize(q, valid)
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(it.groups_of(wt), ij.groups_of(wj))
        np.testing.assert_array_equal(it.scores(bt), ij.scores(bj))
        np.testing.assert_array_equal(it.common_words(bt),
                                      ij.common_words(bj))
        rc = it.reloc_candidates(bt)
        assert rc == ij.reloc_candidates(bj)
        if culled:
            assert 3 not in rc
        if not (culled and k == 3):
            assert rc[0] == k
        for exclude in ({k}, {k, (k + 1) % len(places)}):
            assert (it.loop_candidates(bt, 0.0, exclude)
                    == ij.loop_candidates(bj, 0.0, exclude))
        np.testing.assert_array_equal(it.feat_groups(k), ij.feat_groups(k))


def test_flat_word_lookup_matches_jax():
    """The chunked running argmin over a flat vocabulary (no tree): 5,000
    words span two WORD_CHUNKs plus padding; descriptors that sit at equal
    distance from several words take the lowest id in both."""
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2, (5000, 256)).astype(np.uint8)
    desc = rng.integers(0, 2, (300, 256)).astype(np.uint8)
    desc[:40] = words[rng.choice(5000, 40)]
    desc[40:60] = _noisy(rng, words[4096:4116], flips=3)   # second chunk
    desc[60:64] = words[7]                                  # duplicates
    valid = rng.random(300) > 0.1
    got = tbow.WordLookup(words, device="cpu").assign(desc, valid)
    want = jbow.WordLookup(words).assign(desc, valid)
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == -1).all()
    # a BowIndex over the flat vocabulary quantizes through it
    voc = tbow.Vocabulary(words=words, groups=np.arange(5000) % 50,
                          idf=np.ones(5000, np.float32), branching=10,
                          depth=2)
    wid, _ = tbow.BowIndex(voc, max_kf=2, device="cpu").quantize(desc,
                                                                 valid)
    np.testing.assert_array_equal(wid, want)


@pytest.mark.parametrize("mode", ["gate", "gate+angles", "gate+window"])
def test_match_groups_gate_matches_jax(mode):
    """The FeatureVector gate of match_with_windows (C8): pairs match only
    within a group, or where either group is -1."""
    rng = np.random.default_rng(7)
    n1, n2 = 200, 220
    a = rng.integers(0, 2, (n1, 256)).astype(np.uint8)
    b = rng.integers(0, 2, (n2, 256)).astype(np.uint8)
    b[:150] = _noisy(rng, a[:150], flips=6)
    g1 = rng.integers(-1, 6, n1).astype(np.int32)
    g2 = rng.integers(-1, 6, n2).astype(np.int32)
    g2[:100] = g1[:100]                     # most true pairs share a group
    va, vb = rng.random(n1) > 0.05, rng.random(n2) > 0.05
    kw = dict(max_dist=jmatch.TH_LOW, ratio=0.75, mutual=True)
    jkw, tkw = {}, {}
    if "angles" in mode:
        a1 = rng.uniform(0, 2 * np.pi, n1).astype(np.float32)
        a2 = a1[np.arange(n2) % n1]
        jkw = dict(ang1=jnp.asarray(a1), ang2=jnp.asarray(a2))
        tkw = dict(ang1=t_(a1), ang2=t_(a2))
    if "window" in mode:
        u1 = rng.uniform(0, 640, (n1, 2)).astype(np.float32)
        u2 = u1[np.arange(n2) % n1] + rng.normal(0, 2, (n2, 2)).astype(
            np.float32)
        jkw = dict(uv_pred1=jnp.asarray(u1), uv2=jnp.asarray(u2),
                   radius=8.0)
        tkw = dict(uv_pred1=t_(u1), uv2=t_(u2), radius=8.0)
    ij, okj = jmatch.match_with_windows(
        jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
        groups1=jnp.asarray(g1), groups2=jnp.asarray(g2), **kw, **jkw)
    it, okt = tmatch.match_with_windows(
        t_(a), t_(va), t_(b), t_(vb), groups1=t_(g1), groups2=t_(g2), **kw,
        **tkw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.sum() > 50
    # the gate bites: every match shares a group or has a -1 side
    m = okt.numpy()
    gm = g2[it.numpy()[m]]
    assert ((g1[m] == gm) | (g1[m] < 0) | (gm < 0)).all()
