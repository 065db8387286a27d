"""Sparse inverse-compositional image alignment (SVO-style).

Port of ``ygz_tpu/frontend/sparse_align.py``: per pyramid level (coarse ->
fine, never level 0), 4x4 patches around the previous frame's points,
Jacobians precomputed once per level in the reference frame, a fixed number
of Gauss-Newton iterations on SE(3) with per-pixel Huber weights and a
Jacobi-preconditioned 6x6 solve; T <- T * exp(-delta).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..backend.optim import solve_preconditioned
from ..geometry.lie import se3_exp, se3_mul
from ..ops.align import sample_patches
from ..ops.image import in_bounds

PATCH_HALF = 2      # 4x4 patches like the reference
PATCH = 2 * PATCH_HALF


class SparseAlignResult(NamedTuple):
    R: torch.Tensor        # [3, 3] cur <- ref
    t: torch.Tensor        # [3]
    n_meas: torch.Tensor   # points contributing at the finest level
    mean_res: torch.Tensor  # mean |residual| at convergence


def sparse_image_align(ref_pyr, cur_pyr, uv0, X_ref, valid, intr,
                       R_init, t_init, levels: Sequence[int] = (3, 2, 1),
                       iters: int = 10):
    """Estimate T_cur_ref by direct alignment.

    ref_pyr, cur_pyr: tuples of [H_l, W_l] levels; uv0 [N, 2] level-0
    pixels in the ref frame; X_ref [N, 3] points in the REF camera frame;
    valid [N]; intr (fx, fy, cx, cy) at level 0."""
    fx, fy, cx, cy = intr
    R, t = R_init, t_init
    dev = uv0.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    n_meas = torch.zeros((), dtype=torch.int64, device=dev)
    mean_res = torch.zeros((), dtype=torch.float32, device=dev)
    npts = uv0.shape[0]
    x, y, z = X_ref[:, 0], X_ref[:, 1], X_ref[:, 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    Xhat = torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], 1)
    dX = torch.cat([torch.eye(3, dtype=uv0.dtype, device=dev).expand(
        npts, 3, 3), -Xhat], 2)                                # [N, 3, 6]

    for lvl in levels:
        scale = 0.5 ** lvl
        ref_img = ref_pyr[lvl]
        cur_img = cur_pyr[lvl]
        h, w = cur_img.shape
        fxl, fyl = fx * scale, fy * scale
        cxl = (cx + 0.5) * scale - 0.5
        cyl = (cy + 0.5) * scale - 0.5
        uv_l = (uv0 + 0.5) * scale - 0.5

        # reference patches + fixed IC Jacobians
        ref_border = sample_patches(ref_img, uv_l, PATCH + 2)   # [N, 6, 6]
        ref_flat = ref_border[:, 1:-1, 1:-1].reshape(npts, -1)
        gx = 0.5 * (ref_border[:, 1:-1, 2:] - ref_border[:, 1:-1, :-2])
        gy = 0.5 * (ref_border[:, 2:, 1:-1] - ref_border[:, :-2, 1:-1])
        dpi = torch.stack([
            torch.stack([fxl * zi, zero, -fxl * x * zi2], -1),
            torch.stack([zero, fyl * zi, -fyl * y * zi2], -1)], 1)
        Jp = dpi @ dX                                           # [N, 2, 6]
        J = (gx.reshape(npts, -1)[..., None] * Jp[:, None, 0, :]
             + gy.reshape(npts, -1)[..., None] * Jp[:, None, 1, :])
        ref_ok = valid & (z > 0.1) & in_bounds(uv_l, w, h,
                                               border=PATCH_HALF + 1)

        def project(Rc, tc):
            Xc = X_ref @ Rc.T + tc
            ziC = 1.0 / torch.clamp(Xc[:, 2], min=1e-6)
            uvc = torch.stack([fxl * Xc[:, 0] * ziC + cxl,
                               fyl * Xc[:, 1] * ziC + cyl], -1)
            return uvc, Xc[:, 2] > 0.1

        for _ in range(iters):
            uv_c, front = project(R, t)
            vis = ref_ok & front & in_bounds(uv_c, w, h,
                                             border=PATCH_HALF + 1)
            r = sample_patches(cur_img, uv_c, PATCH).reshape(npts, -1) \
                - ref_flat                                        # [N, 16]
            # Huber weight on per-pixel residuals (k = 10 intensity levels)
            wh = torch.clamp(10.0 / torch.clamp(r.abs(), min=1e-6), max=1.0)
            wr = vis.to(torch.float32)[:, None] * wh
            Jw = J * wr[..., None]
            H = torch.einsum("nki,nkj->ij", Jw, J)
            b = torch.einsum("nki,nk->i", Jw, r)
            H = H + 1e-6 * torch.trace(H) / 6.0 * eye6
            Rd, td = se3_exp(-solve_preconditioned(H, b))
            R, t = se3_mul(R, t, Rd, td)

        # diagnostics at the finest processed level
        uv_c, front = project(R, t)
        vis = ref_ok & front & in_bounds(uv_c, w, h, border=PATCH_HALF + 1)
        res = (sample_patches(cur_img, uv_c, PATCH).reshape(npts, -1)
               - ref_flat).abs().mean(1)
        n_meas = vis.sum()
        mean_res = torch.where(vis, res, torch.zeros_like(res)).sum() \
            / torch.clamp(n_meas, min=1)
    return SparseAlignResult(R=R, t=t, n_meas=n_meas, mean_res=mean_res)
