"""Descriptor matching: Hamming distances as a +-1 float32 matmul + gated
nearest-neighbour search.

Port of ``ygz_tpu/ops/matching.py``. With descriptors as +-1 vectors the
Hamming distance is (256 - <d1, d2>) / 2; the f32 product of integers up to
256 is exact, provided TF32 stays off (the package pins it off). Functions
accept leading batch dimensions where the JAX package vmapped them.
Constants follow the reference: TH_HIGH=100, TH_LOW=50.
"""
from __future__ import annotations

import math

import torch

from .select import topk_stable

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
N_BITS = 256
BIG = 1e9


def _pm1(bits):
    return bits.to(torch.float32) * 2.0 - 1.0


def hamming_matrix(bits1, bits2, valid1=None, valid2=None):
    """[..., N1, 256] x [..., N2, 256] 0/1 -> [..., N1, N2] float32 Hamming;
    invalid rows/cols get BIG."""
    d = 0.5 * (N_BITS - _pm1(bits1) @ _pm1(bits2).transpose(-1, -2))
    big = torch.full_like(d, BIG)
    if valid1 is not None:
        d = torch.where(valid1[..., :, None], d, big)
    if valid2 is not None:
        d = torch.where(valid2[..., None, :], d, big)
    return d


def nn_match(dist, max_dist=TH_LOW, ratio=1.0):
    """Row-wise nearest neighbour with the Lowe ratio test, over the last
    dim. Returns (idx int32 — match or -1, ok bool). The best index is the
    first minimum (lax.top_k's tie order); the second value is the minimum
    of the row without that entry."""
    idx = torch.argmin(dist, -1, keepdim=True)
    best = torch.gather(dist, -1, idx)[..., 0]
    second = dist.scatter(-1, idx, math.inf).amin(-1)
    ok = (best <= max_dist) & (best <= ratio * second)
    idx = idx[..., 0]
    return torch.where(ok, idx, torch.full_like(idx, -1)).to(torch.int32), ok


def mutual_filter(idx12, idx21):
    """Keep only mutual matches: idx21[idx12[i]] == i (batched)."""
    n1 = idx12.shape[-1]
    back = torch.gather(idx21, -1,
                        torch.clamp(idx12, 0, idx21.shape[-1] - 1).long())
    back = torch.where(idx12 >= 0, back, torch.full_like(back, -2))
    ok = back == torch.arange(n1, device=idx12.device)
    return torch.where(ok, idx12, torch.full_like(idx12, -1)), ok


def window_gate(uv1, uv2, radius):
    """Additive BIG penalty [..., N1, N2] outside a Chebyshev window."""
    d = (uv1[..., :, None, :] - uv2[..., None, :, :]).abs()
    inside = (d[..., 0] < radius) & (d[..., 1] < radius)
    return torch.where(inside, torch.zeros_like(d[..., 0]),
                       torch.full_like(d[..., 0], BIG))


def rotation_consistency(ang1, ang2, idx, ok):
    """ORB-SLAM rotation-histogram filter (30 bins, keep the top-3 bins,
    dropping bins below 0.1 x the largest). Returns the refined ok mask."""
    a2 = ang2[torch.clamp(idx, 0, ang2.shape[0] - 1).long()]
    rot = (ang1 - a2) * (180.0 / math.pi)
    rot = torch.where(rot < 0, rot + 360.0, rot)
    b = torch.clamp((rot / (360.0 / HISTO_LENGTH)).to(torch.int32), 0,
                    HISTO_LENGTH - 1).long()
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=ok.device)
    counts.index_add_(0, b, ok.to(torch.int32))
    top3 = topk_stable(counts, 3)[0]
    thresh = torch.maximum(top3[2], (0.1 * top3[0]).to(torch.int32))
    keep_bin = counts >= torch.clamp(thresh, min=1)
    return ok & keep_bin[b]


def match_with_windows(bits1, valid1, bits2, valid2, uv_pred1=None, uv2=None,
                       radius=None, max_dist=TH_LOW, ratio=0.9,
                       ang1=None, ang2=None, mutual=False):
    """Window-gated Hamming NN + ratio, optional rotation histogram and
    mutual check (ORBmatcher::SearchByProjection semantics). Leading batch
    dims are allowed when no angles are given."""
    d = hamming_matrix(bits1, bits2, valid1, valid2)
    if radius is not None:
        d = d + window_gate(uv_pred1, uv2, radius)
    idx, ok = nn_match(d, max_dist=max_dist, ratio=ratio)
    if ang1 is not None and ang2 is not None:
        ok = rotation_consistency(ang1, ang2, idx, ok)
        idx = torch.where(ok, idx, torch.full_like(idx, -1))
    if mutual:
        idx21, _ = nn_match(d.transpose(-1, -2), max_dist=max_dist,
                            ratio=ratio)
        idx, mok = mutual_filter(idx, idx21)
        ok = ok & mok
    return idx, ok


def match_with_windows_batch(bits1, valid1, bits2, valid2, uv1, uv2,
                             radius: float, max_dist: float = TH_LOW,
                             ratio: float = 0.9, mutual: bool = True):
    """match_with_windows over a leading target axis [T]: T independent
    window-gated matches as one batched computation. Returns (idx [T, N1],
    ok [T, N1])."""
    return match_with_windows(bits1, valid1, bits2, valid2, uv_pred1=uv1,
                              uv2=uv2, radius=radius, max_dist=max_dist,
                              ratio=ratio, mutual=mutual)


def distinctive_descriptors(desc_stack, valid):
    """Min-median-Hamming representative per point: desc_stack [N, B, 256]
    0/1, valid [N, B]. Returns (best [N] int32, desc [N, 256])."""
    s = _pm1(desc_stack)
    d = 0.5 * (N_BITS - s @ s.transpose(1, 2))                # [N, B, B]
    pair_ok = valid[:, None, :] & valid[:, :, None]
    d = torch.where(pair_ok, d, torch.full_like(d, BIG))
    ds = torch.sort(d, dim=-1).values
    k = valid.sum(-1)[:, None]
    mid = torch.clamp((k - 1) // 2, 0, d.shape[-1] - 1)
    med = torch.gather(ds, -1, mid[..., None].expand(-1, d.shape[1], 1))[..., 0]
    med = torch.where(valid, med, torch.full_like(med, BIG))
    best = torch.argmin(med, -1)
    desc = desc_stack[torch.arange(desc_stack.shape[0],
                                   device=desc_stack.device), best]
    return best.to(torch.int32), desc


def distinctive_descriptors_packed(packed_stack, valid):
    """distinctive_descriptors on a bit-packed [N, B, 32] uint8 stack
    (np.packbits layout, MSB first)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                          device=packed_stack.device)
    bits = (packed_stack[..., :, None] >> shifts) & 1
    stack = bits.reshape(packed_stack.shape[:-1] + (N_BITS,))
    return distinctive_descriptors(stack, valid)
