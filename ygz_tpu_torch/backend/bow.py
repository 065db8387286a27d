"""Binary bag-of-words place recognition.

Port of ``ygz_tpu/backend/bow.py``. The vocabulary (hierarchical k-medians
over BRIEF bits), its greedy tree lookup and the sparse tf-idf keyframe
database are host numpy in the JAX package and stay numpy here, as
``mapstate.py`` does: they run at keyframe rate, in packed-bit popcounts.
The one device part is ``WordLookup``, the chunked nearest-word argmin for
flat vocabularies saved without a tree.

The shipped vocabulary (k=10, L=5, 99,478 words) is read by path from the
JAX package's data directory (``default_vocabulary_path``); this package
neither imports ``ygz_tpu`` nor copies the file.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.matching import hamming_matrix


class Vocabulary(NamedTuple):
    words: np.ndarray      # [W,256] uint8 leaf centers (bits)
    groups: np.ndarray     # [W] int32 ancestor id at the grouping level
    idf: np.ndarray        # [W] float32
    branching: int
    depth: int
    # lookup tree: tree_centers [I,k,32] packed child centers of internal
    # node i; tree_child [I,k] >=0 internal child, <0 leaf word -(w+1);
    # None = flat vocabulary (WordLookup)
    tree_centers: Optional[np.ndarray] = None
    tree_child: Optional[np.ndarray] = None
    tree_root: int = 0

    @property
    def n_words(self):
        return len(self.words)


_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(axis=1).astype(np.uint8)


def _hamming_np(packed_a, packed_b, block=131072):
    """[M,32] x [K,32] packed-bit Hamming distances, row-blocked to bound
    the [block,K,32] intermediate."""
    M = len(packed_a)
    out = np.empty((M, len(packed_b)), np.int32)
    for i in range(0, M, block):
        x = np.bitwise_xor(packed_a[i: i + block, None, :],
                           packed_b[None, :, :])
        out[i: i + block] = _POPCOUNT[x].sum(axis=2, dtype=np.int32)
    return out


def _kmedians(desc, k, rng, iters=8):
    """Binary k-medians (majority-bit medians). desc [M,256] uint8 0/1."""
    M = len(desc)
    if M <= k:
        return desc.copy(), np.arange(M) % max(len(desc), 1)
    centers = desc[rng.choice(M, k, replace=False)].astype(np.uint8)
    assign = np.zeros(M, np.int64)
    packed = np.packbits(desc, axis=1)
    for _ in range(iters):
        d = _hamming_np(packed, np.packbits(centers, axis=1))
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = desc[assign == c]
            if len(sel):
                centers[c] = (sel.mean(axis=0) > 0.5).astype(np.uint8)
    return centers, assign


def train_vocabulary(desc, branching: int = 10, depth: int = 3,
                     seed: int = 0, doc_ids=None) -> Vocabulary:
    """Hierarchical k-medians over training descriptors [M,256] (0/1).
    doc_ids: optional [M] image ids for the idf statistics."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(desc, np.uint8)
    leaves = []
    group_of_leaf = []
    tree_centers = []
    tree_child = []
    # FeatureVector grouping: the ancestor node at depth 2 (DBoW2's
    # levelsup analog)
    gd = min(2, depth - 1) if depth > 1 else 0

    def add_leaf(bits, group):
        leaves.append(bits)
        group_of_leaf.append(group)
        return -(len(leaves) - 1) - 1   # leaf code

    def split(idx, level, group):
        """Returns the node's code: >=0 internal index, <0 leaf."""
        if level == depth or len(idx) <= branching:
            bits = ((desc[idx].mean(axis=0) > 0.5).astype(np.uint8)
                    if len(idx) else np.zeros(256, np.uint8))
            return add_leaf(bits, group)
        centers, assign = _kmedians(desc[idx], branching, rng)
        my = len(tree_centers)
        tree_centers.append(np.packbits(centers, axis=1))
        tree_child.append(np.zeros(branching, np.int32))
        for c in range(len(centers)):
            sub = idx[assign == c]
            g = group * branching + c if level < gd else group
            if len(sub) == 0:
                tree_child[my][c] = add_leaf(centers[c], g)
            else:
                tree_child[my][c] = split(sub, level + 1, g)
        return my

    tree_root = split(np.arange(len(desc)), 0, 0)
    words = np.stack(leaves)
    groups = np.array(group_of_leaf, np.int32)
    t_cent = (np.stack(tree_centers) if tree_centers
              else np.zeros((0, branching, 32), np.uint8))
    t_child = (np.stack(tree_child) if tree_child
               else np.zeros((0, branching), np.int32))

    # idf from the training assignment through the tree
    W = len(words)
    pre = Vocabulary(words=words, groups=groups,
                     idf=np.ones(W, np.float32), branching=branching,
                     depth=depth, tree_centers=t_cent, tree_child=t_child,
                     tree_root=int(tree_root))
    wa = assign_words_tree(desc, np.ones(len(desc), bool), pre)
    if doc_ids is None:
        doc_ids = np.zeros(len(desc), np.int64)
    n_docs = max(int(doc_ids.max()) + 1, 1)
    seen = np.zeros((n_docs, W), bool)
    seen[doc_ids, wa] = True
    df = seen.sum(axis=0)
    idf = np.log(n_docs / np.maximum(df, 1)).astype(np.float32) + 1.0
    return pre._replace(idf=idf)


def assign_words_tree(desc01, valid, vocab: Vocabulary):
    """Descriptor -> word by greedy tree descent (DBoW2 transform
    semantics): depth levels of k-way packed-bit Hamming argmin."""
    desc01 = np.asarray(desc01, np.uint8)
    valid = np.asarray(valid, bool)
    packed = np.packbits(desc01, axis=1)
    N = len(packed)
    code = np.full(N, vocab.tree_root, np.int64)
    for _ in range(vocab.depth):
        active = np.nonzero(code >= 0)[0]
        if len(active) == 0:
            break
        nodes = code[active].astype(np.int64)
        cent = vocab.tree_centers[nodes]               # [n,k,32]
        x = np.bitwise_xor(packed[active][:, None, :], cent)
        d = _POPCOUNT[x].sum(axis=2, dtype=np.int32)   # [n,k]
        c = d.argmin(axis=1)
        code[active] = vocab.tree_child[nodes, c]
    wid = np.where(code < 0, -code - 1, 0)
    return np.where(valid, wid, -1).astype(np.int64)


# ------------------------------------------------------------- persistence
def save_vocabulary(vocab: Vocabulary, path: str):
    """Persist a vocabulary, bits packed; the lookup tree when it has one."""
    tree = {}
    if vocab.tree_centers is not None and len(vocab.tree_centers):
        tree = dict(tree_centers=vocab.tree_centers,
                    tree_child=vocab.tree_child,
                    tree_root=np.int64(vocab.tree_root))
    np.savez_compressed(
        path, words_packed=np.packbits(vocab.words, axis=1),
        groups=vocab.groups, idf=vocab.idf,
        meta=np.array([vocab.branching, vocab.depth], np.int64), **tree)


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    words = np.unpackbits(z["words_packed"], axis=1)[:, :256].astype(np.uint8)
    tree = {}
    if "tree_centers" in z:
        tree = dict(tree_centers=np.array(z["tree_centers"]),
                    tree_child=np.array(z["tree_child"]),
                    tree_root=int(z["tree_root"]))
    return Vocabulary(words=words, groups=np.array(z["groups"]),
                      idf=np.array(z["idf"]), branching=int(z["meta"][0]),
                      depth=int(z["meta"][1]), **tree)


def default_vocabulary_path() -> str:
    """The shipped offline vocabulary, in the JAX package's data dir."""
    return os.path.normpath(os.path.join(
        os.path.dirname(__file__), "..", "..", "ygz_tpu", "data",
        "orb_vocab.npz"))


WORD_CHUNK = 4096   # words per chunk of the flat-argmin lookup
DESC_PAD = 2048     # descriptor batch bucket


def _assign_words_chunked(desc_bits, valid, words3, n_words: int):
    """Nearest word over a [C, WORD_CHUNK, 256] chunked word table by a
    running argmin over the chunks: never materializes the [N, W] distance
    matrix. Ties go to the lowest word id, as in the JAX scan."""
    N = desc_bits.shape[0]
    Wc = words3.shape[1]
    dev = desc_bits.device
    best_d = torch.full((N,), float("inf"), device=dev)
    best_i = torch.zeros(N, dtype=torch.int32, device=dev)
    ar = torch.arange(Wc, device=dev)
    for c in range(words3.shape[0]):
        base = c * Wc
        d = hamming_matrix(desc_bits, words3[c])                 # [N, Wc]
        # mask padding words past the true vocabulary size
        d = d + ((base + ar) >= n_words)[None, :] * 1e9
        dm, i = d.min(1)
        upd = dm < best_d
        best_i = torch.where(upd, (base + i).to(torch.int32), best_i)
        best_d = torch.minimum(best_d, dm)
    return torch.where(valid, best_i, torch.full_like(best_i, -1))


class WordLookup:
    """Device descriptor -> word assignment for flat vocabularies of any
    size (fixed-shape chunks)."""

    def __init__(self, words: np.ndarray, device="cuda"):
        self.n_words = len(words)
        self.device = torch.device(device)
        C = (self.n_words + WORD_CHUNK - 1) // WORD_CHUNK
        padded = np.zeros((C * WORD_CHUNK, 256), np.uint8)
        padded[: self.n_words] = words
        self._words3 = torch.as_tensor(padded.reshape(C, WORD_CHUNK, 256),
                                       device=self.device)

    def assign(self, desc_bits, valid):
        """[N,256] 0/1 -> word ids [N] (-1 where invalid), numpy."""
        n = len(desc_bits)
        out = np.empty(n, np.int32)
        for s in range(0, n, DESC_PAD):
            m = min(DESC_PAD, n - s)
            db = np.zeros((DESC_PAD, 256), np.uint8)
            vl = np.zeros(DESC_PAD, bool)
            db[:m] = desc_bits[s: s + m]
            vl[:m] = valid[s: s + m]
            wid = _assign_words_chunked(
                torch.as_tensor(db, device=self.device),
                torch.as_tensor(vl, device=self.device), self._words3,
                self.n_words)
            out[s: s + m] = wid.cpu().numpy()[:m]
        return out


class BowIndex:
    """Quantization + sparse tf-idf keyframe database (reference
    KeyFrameDatabase: DetectLoop / RelocalizationCandidates). Each keyframe
    stores only its own word ids + weights ([max_feat] padded)."""

    def __init__(self, vocab: Vocabulary, max_kf: int = 256,
                 max_feat: int = 1024, device="cuda"):
        self.vocab = vocab
        # tree descent when the vocabulary carries its hierarchy; the flat
        # device argmin only for vocabularies saved without one
        self._lookup = (None if (vocab.tree_centers is not None
                                 and len(vocab.tree_centers))
                        else WordLookup(vocab.words, device))
        self.F = max_feat
        self.kf_wid = np.full((max_kf, max_feat), -1, np.int32)
        self.kf_w = np.zeros((max_kf, max_feat), np.float32)
        # per-feature word ids (aligned with the KF's feature slots) for
        # FeatureVector-gated SearchByBoW
        self.kf_feat_word = np.full((max_kf, max_feat), -1, np.int32)
        self.kf_valid = np.zeros(max_kf, bool)

    def quantize(self, desc_bits, valid):
        """desc [N,256] 0/1 -> (word_ids [N], bow) with bow the sparse
        L1-normalized tf-idf pair (uids, weights)."""
        if self._lookup is None:
            wid = assign_words_tree(desc_bits, valid, self.vocab)
        else:
            wid = self._lookup.assign(np.asarray(desc_bits),
                                      np.asarray(valid))
        ids = wid[wid >= 0]
        uids, counts = np.unique(ids, return_counts=True)
        w = counts.astype(np.float32) * self.vocab.idf[uids]
        n = w.sum()
        if n > 0:
            w /= n
        return wid, (uids.astype(np.int32), w)

    def add_keyframe(self, kf_id: int, bow, feat_wid=None):
        while kf_id >= len(self.kf_valid):   # grow with the map
            n = len(self.kf_valid)
            self.kf_wid = np.concatenate(
                [self.kf_wid, np.full((n, self.F), -1, np.int32)])
            self.kf_w = np.concatenate(
                [self.kf_w, np.zeros((n, self.F), np.float32)])
            self.kf_feat_word = np.concatenate(
                [self.kf_feat_word, np.full((n, self.F), -1, np.int32)])
            self.kf_valid = np.concatenate(
                [self.kf_valid, np.zeros(n, bool)])
        uids, w = bow
        m = min(len(uids), self.F)
        self.kf_wid[kf_id] = -1
        self.kf_w[kf_id] = 0.0
        self.kf_wid[kf_id, :m] = uids[:m]
        self.kf_w[kf_id, :m] = w[:m]
        if feat_wid is not None:
            fm = min(len(feat_wid), self.F)
            self.kf_feat_word[kf_id] = -1
            self.kf_feat_word[kf_id, :fm] = feat_wid[:fm]
        self.kf_valid[kf_id] = True

    def feat_groups(self, kf_id: int):
        """Per-feature-slot group ids of keyframe `kf_id` (-1 unquantized)."""
        fw = self.kf_feat_word[kf_id]
        return np.where(fw >= 0, self.vocab.groups[np.maximum(fw, 0)], -1)

    def groups_of(self, wid):
        """Word ids [N] -> group ids [N] (-1 passthrough)."""
        wid = np.asarray(wid)
        return np.where(wid >= 0, self.vocab.groups[np.maximum(wid, 0)], -1)

    def scores(self, bow):
        """DBoW2 L1 similarity s = 1 - 0.5|v-w|_1 of a query against all
        stored KFs, over word intersections only:
        s = sum_{i in both} (v_i + w_i - |v_i - w_i|) / 2."""
        uids, w = bow
        W = self.vocab.n_words
        q = np.zeros(W + 1, np.float32)     # [+1] slot for padding gathers
        q[uids] = w
        kw = self.kf_wid
        qv = q[np.where(kw >= 0, kw, W)]
        s = 0.5 * (self.kf_w + qv - np.abs(self.kf_w - qv)).sum(axis=1)
        s[~self.kf_valid] = 0.0
        return s

    def common_words(self, bow):
        uids, _ = bow
        W = self.vocab.n_words
        qm = np.zeros(W + 1, bool)
        qm[uids] = True
        kw = self.kf_wid
        return (qm[np.where(kw >= 0, kw, W)]).sum(axis=1)

    def reloc_candidates(self, bow, max_candidates: int = 5):
        """DetectRelocalizationCandidates: 0.5 * maxCommonWords gate, then
        score ranking."""
        cw = self.common_words(bow)
        if cw.max() == 0:
            return []
        th = 0.5 * cw.max()
        s = self.scores(bow)
        cand = np.nonzero((cw >= th) & self.kf_valid)[0]
        cand = cand[np.argsort(-s[cand])]
        return [int(c) for c in cand[:max_candidates]]

    def loop_candidates(self, bow, min_score: float, exclude,
                        max_candidates: int = 5):
        """DetectLoopCandidates: common words >= 0.8 * max, score >=
        min_score, excluding the query's covisible set."""
        cw = self.common_words(bow)
        mask = self.kf_valid.copy()
        mask[list(exclude)] = False
        cw = np.where(mask, cw, 0)
        if cw.max() == 0:
            return []
        s = self.scores(bow)
        ok = (cw >= 0.8 * cw.max()) & (s >= min_score) & mask
        cand = np.nonzero(ok)[0]
        cand = cand[np.argsort(-s[cand])]
        return [int(c) for c in cand[:max_candidates]]
