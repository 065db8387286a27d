"""Two-view relative geometry: batched H/F RANSAC + motion recovery.

Port of ``ygz_tpu/geometry/twoview.py`` (the monocular initializer). All
RANSAC sample sets are solved at once (batched 9x9 eigen-solves), every
model is scored against every match in one broadcast pass, and the 8 (H) +
4 (F) motion hypotheses are cheirality-checked as one batched
triangulation. The sample indices come from a ``torch.Generator`` (the JAX
package drew them with ``jax.random.choice``), so the two packages draw
different samples: compare them on injected samples or by outcome.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .triangulation import triangulate_dlt, triangulation_checks

CHI2_H = 5.991
CHI2_F = 3.841
TH_SCORE = 5.991


def _eye3(ref):
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def normalize_points(pts, mask):
    """Hartley normalization with mean-absolute-deviation scaling over the
    masked points. pts [..., N, 2] -> (pts_n, T [..., 3, 3])."""
    w = mask.to(pts.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)[..., None]
    mean = (pts * w[..., None]).sum(-2) / n
    mdev = ((pts - mean[..., None, :]).abs() * w[..., None]).sum(-2) / n
    s = 1.0 / torch.clamp(mdev, min=1e-8)
    pts_n = (pts - mean[..., None, :]) * s[..., None, :]
    z = torch.zeros_like(s[..., 0])
    o = torch.ones_like(z)
    T = torch.stack([
        torch.stack([s[..., 0], z, -mean[..., 0] * s[..., 0]], -1),
        torch.stack([z, s[..., 1], -mean[..., 1] * s[..., 1]], -1),
        torch.stack([z, z, o], -1)], -2)
    return pts_n, T


def _nullvec9(A):
    """Smallest right singular vector of A [..., m, 9] via eigh of A^T A."""
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0]


def fit_homography(p1, p2):
    """DLT homography from [..., k, 2] correspondences (p2 ~ H p1)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    h = _nullvec9(torch.cat([r1, r2], -2))
    return h.reshape(h.shape[:-1] + (3, 3))


def fit_fundamental(p1, p2):
    """8-point fundamental matrix, rank 2 enforced."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)
    f = _nullvec9(A)
    U, s, Vt = torch.linalg.svd(f.reshape(f.shape[:-1] + (3, 3)))
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return (U * s[..., None, :]) @ Vt


def _hom(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], -1)


def score_homography(H, p1, p2, mask, sigma2=1.0):
    """Symmetric-transfer chi2 score; H may carry leading batch dims.
    Returns (score [...], inliers [..., N])."""
    Hinv = torch.linalg.inv_ex(H).inverse

    def transfer(M, a):
        b = _hom(a) @ M.transpose(-1, -2)
        w = b[..., 2:3]
        w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
        return b[..., :2] / w

    e21 = ((p1 - transfer(Hinv, p2)) ** 2).sum(-1) / sigma2
    e12 = ((p2 - transfer(H, p1)) ** 2).sum(-1) / sigma2
    in1 = e21 < CHI2_H
    in2 = e12 < CHI2_H
    zero = torch.zeros_like(e21)
    sc = (torch.where(in1, CHI2_H - e21, zero)
          + torch.where(in2, CHI2_H - e12, zero))
    return (sc * mask).sum(-1), in1 & in2 & mask


def score_fundamental(F, p1, p2, mask, sigma2=1.0):
    """Epipolar-distance chi2 score; returns (score [...], inliers)."""
    p1h, p2h = _hom(p1), _hom(p2)
    l2 = p1h @ F.transpose(-1, -2)
    l1 = p2h @ F
    d2 = (p2h * l2).sum(-1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / sigma2
    d1 = (p1h * l1).sum(-1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / sigma2
    in1 = d1 < CHI2_F
    in2 = d2 < CHI2_F
    zero = torch.zeros_like(d1)
    sc = (torch.where(in1, TH_SCORE - d1, zero)
          + torch.where(in2, TH_SCORE - d2, zero))
    return (sc * mask).sum(-1), in1 & in2 & mask


def draw_samples(mask, num_iters: int, sample_size: int,
                 generator: torch.Generator):
    """[num_iters, sample_size] indices drawn without replacement among the
    masked matches (uniform over them)."""
    probs = mask.to(torch.float32)
    probs = probs / torch.clamp(probs.sum(), min=1.0)
    return torch.multinomial(probs[None].expand(num_iters, -1), sample_size,
                             replacement=False, generator=generator)


def _ransac(fit_fn, score_fn, denorm, p1, p2, mask, idx):
    """Batched RANSAC over the sample sets idx [S, k]: Hartley-normalize
    once, fit every sample, denormalize, score all, keep the best."""
    p1n, T1 = normalize_points(p1, mask)
    p2n, T2 = normalize_points(p2, mask)
    models = denorm(fit_fn(p1n[idx], p2n[idx]), T1, T2)       # [S, 3, 3]
    scores, inls = score_fn(models, p1, p2, mask)
    best = torch.argmax(scores)
    return models[best], scores[best], inls[best]


def _denorm_h(Hn, T1, T2):
    return torch.linalg.inv_ex(T2).inverse @ Hn @ T1


def _denorm_f(Fn, T1, T2):
    return T2.T @ Fn @ T1


def _motion_hypotheses_from_F(F, K):
    """E = K^T F K -> 4 (R, t) hypotheses [4, 3, 3], [4, 3]."""
    E = K.T @ F @ K
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=F.dtype, device=F.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motion_hypotheses_from_H(H, K):
    """Faugeras decomposition of A = K^-1 H K -> 8 (R, t) hypotheses."""
    A = torch.linalg.inv(K) @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt.T)
    d1, d2, d3 = d[0], d[1], d[2]
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    dev = H.device
    x1 = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev) * aux1   # [4]
    x3 = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev) * aux3
    eps = x1 * x3
    sgn = torch.sign(torch.where(eps == 0, torch.ones_like(eps), eps))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    one = torch.ones_like(x1)
    zero = torch.zeros_like(x1)

    def finish(Rp, tp):
        R = s * (U @ Rp @ Vt)
        t = (U @ tp[..., None])[..., 0]
        return R, t / torch.clamp(torch.linalg.norm(t, dim=-1,
                                                    keepdim=True), min=1e-12)

    # d' > 0
    st = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct4 = ct * one
    Rp = torch.stack([torch.stack([ct4, zero, -sgn * st], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([sgn * st, zero, ct4], -1)], -2)
    Rs_p, ts_p = finish(Rp, torch.stack([x1, zero, -x3], -1) * (d1 - d3))
    # d' < 0
    sp = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp4 = cp * one
    Rn = torch.stack([torch.stack([cp4, zero, sgn * sp], -1),
                      torch.stack([zero, -one, zero], -1),
                      torch.stack([sgn * sp, zero, -cp4], -1)], -2)
    Rs_n, ts_n = finish(Rn, torch.stack([x1, zero, x3], -1) * (d1 + d3))
    return torch.cat([Rs_p, Rs_n]), torch.cat([ts_p, ts_n])


class TwoViewResult(NamedTuple):
    ok: torch.Tensor          # scalar bool
    used_h: torch.Tensor      # scalar bool
    R: torch.Tensor           # [3, 3] world(cam1) -> cam2
    t: torch.Tensor           # [3]
    points: torch.Tensor      # [N, 3] triangulated (cam1 frame)
    good: torch.Tensor        # [N] triangulation-valid mask
    inliers: torch.Tensor     # [N] model inliers
    n_good: torch.Tensor      # scalar int


def two_view_reconstruct(p1, p2, mask, K, generator: torch.Generator,
                         num_iters=200, min_triangulated=50,
                         min_parallax_cos=0.99966, samples=None):
    """Monocular two-view bootstrapping. p1, p2 [N, 2] matched undistorted
    pixels, mask [N] valid matches, K [3, 3]. ``samples`` optionally
    injects the (H, F) RANSAC index sets [2, S, 8] instead of drawing them
    from ``generator``. Points are triangulated with cam1 as world."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if samples is None:
        samples = [draw_samples(mask, num_iters, 8, generator)
                   for _ in range(2)]
    H, sh, inl_h = _ransac(fit_homography, score_homography, _denorm_h,
                           p1, p2, mask, samples[0])
    F, sf, inl_f = _ransac(fit_fundamental, score_fundamental, _denorm_f,
                           p1, p2, mask, samples[1])
    use_h = sh / torch.clamp(sh + sf, min=1e-12) > 0.40

    Rh, th_ = _motion_hypotheses_from_H(H, K)
    Rf, tf_ = _motion_hypotheses_from_F(F, K)
    Rs = torch.cat([Rh, Rf])                    # [12, 3, 3]
    ts = torch.cat([th_, tf_])                  # [12, 3]
    hyp_active = torch.cat([use_h.expand(8), (~use_h).expand(4)])
    inliers = torch.where(use_h, inl_h, inl_f)

    I3 = _eye3(p1)
    z3 = torch.zeros(3, dtype=p1.dtype, device=p1.device)
    P1 = K @ torch.cat([I3, z3[:, None]], 1)
    P2 = K @ torch.cat([Rs, ts[..., None]], -1)               # [12, 3, 4]
    X = triangulate_dlt(P1, P2, p1, p2)                       # [12, N, 3]
    good, cosp = triangulation_checks(
        I3, z3, Rs, ts, X, p1, p2, fx, fy, cx, cy, sigma2=1.0,
        reproj_chi2=4.0, min_parallax_cos=0.99999999)
    good = good & inliers
    # parallax of the 50th-best good point (reference: 50th-smallest cos)
    cp = torch.sort(torch.where(good, cosp, torch.ones_like(cosp)), -1).values
    ngood = good.sum(-1)
    k = torch.clamp(ngood - 1, min=0, max=49)
    pcos = torch.gather(cp, -1, k[:, None])[:, 0]
    ngood = torch.where(hyp_active, ngood, torch.full_like(ngood, -1))
    best = torch.argmax(ngood)
    nbest = ngood[best]
    others = torch.where(torch.arange(12, device=p1.device) == best,
                         torch.full_like(ngood, -1), ngood)
    nsecond = others.max()
    n_inl = inliers.sum()
    ok = ((nbest >= min_triangulated)
          & (nbest.float() > 0.8 * n_inl.float())
          & (nsecond.float() < 0.75 * nbest.float())
          & (pcos[best] < min_parallax_cos))
    return TwoViewResult(ok=ok, used_h=use_h, R=Rs[best], t=ts[best],
                         points=X[best], good=good[best], inliers=inliers,
                         n_good=nbest)
