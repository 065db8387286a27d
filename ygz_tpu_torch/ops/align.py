"""Batched inverse-compositional patch alignment (Align2D) + affine warps.

Port of ``ygz_tpu/ops/align.py``: all candidate points align at once, with
patches in an [N, P, P] tensor, batched 3x3 Hessian inverses and a
fixed number of iterations (a Python loop in place of ``lax.fori_loop``;
no data-dependent early exit, so the result matches the reference and the
host never waits on the device inside the loop). The frame step that runs
these is captured as a CUDA graph (``frontend/framestep_graph.py``): the
Hessian inverses use ``inv_ex`` (no host sync on singular input) through
the cuBLAS batched LU that the capture pins, and the 2x2 determinant of
``best_search_level`` is written out.
"""
from __future__ import annotations

import torch

from .image import sample_bilinear

PATCH = 8          # aligned patch side (reference WarpPatchSize=8)
HALF = PATCH / 2.0


def _grid_offsets(size: int, device="cpu"):
    """Symmetric subpixel patch grid: size offsets centred on 0."""
    o = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    return ox, oy


def sample_patches(img, uv, size: int):
    """Bilinear patches [N, size, size] centred at uv [N, 2].

    Shared-fraction gather: every sample of a patch sits on one integer grid
    shifted by a common subpixel fraction, so the patch is a bilinear blend
    of ONE (size+1)^2 integer gather. The integer corner is clamped to
    [0, W - size - 1] x [0, H - size - 1] of the image it is given — for a
    stacked pyramid that is the stacked width W0, not the level's width
    (reference defect C-ref1, kept for parity)."""
    H, W = img.shape
    o0 = -(size - 1) / 2.0
    x = torch.clamp(uv[:, 0], 0.0, W - 1.001) + o0
    y = torch.clamp(uv[:, 1], 0.0, H - 1.001) + o0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None, None]
    fy = (y - y0)[:, None, None]
    xi = torch.clamp(x0.long(), 0, W - size - 1)
    yi = torch.clamp(y0.long(), 0, H - size - 1)
    r = torch.arange(size + 1, device=img.device)
    idx = ((yi[:, None, None] + r[None, :, None]) * W
           + xi[:, None, None] + r[None, None, :])
    g = img.reshape(-1)[idx]                      # [N, size+1, size+1]
    top = (1.0 - fx) * g[:, :-1, :-1] + fx * g[:, :-1, 1:]
    bot = (1.0 - fx) * g[:, 1:, :-1] + fx * g[:, 1:, 1:]
    return (1.0 - fy) * top + fy * bot


def warp_affine_patches(ref_img, uv_ref, A_ref_cur, size: int):
    """patch[n, i, j] = ref(uv_ref[n] + A_ref_cur[n] @ o_ij)."""
    ox, oy = _grid_offsets(size, ref_img.device)
    o = torch.stack([ox, oy], -1)                              # [s, s, 2]
    warped = torch.einsum("nab,ijb->nija", A_ref_cur, o)
    return sample_bilinear(ref_img, warped + uv_ref[:, None, None, :])


def affine_warp_matrix(X_ref, uv_ref, fx, fy, cx, cy, R_cr, t_cr, fx_c, fy_c,
                       cx_c, cy_c, d=5.0):
    """A_cur_ref [N, 2, 2] by finite differences at each point's depth
    (ORBmatcher::GetWarpAffineMatrix)."""
    z = X_ref[:, 2:3]

    def backproject(du, dv):
        xn = torch.stack([(uv_ref[:, 0] + du - cx) / fx,
                          (uv_ref[:, 1] + dv - cy) / fy], -1)
        return torch.cat([xn * z, z], -1)

    def project_cur(Xr):
        Xc = Xr @ R_cr.T + t_cr
        zi = 1.0 / torch.clamp(Xc[:, 2:3], min=1e-6)
        return torch.cat([fx_c * Xc[:, 0:1] * zi + cx_c,
                          fy_c * Xc[:, 1:2] * zi + cy_c], -1)

    c = project_cur(backproject(0.0, 0.0))
    du = project_cur(backproject(d, 0.0))
    dv = project_cur(backproject(0.0, d))
    return torch.stack([(du - c) / d, (dv - c) / d], -1)


def det2x2(A):
    """Determinants of [..., 2, 2] matrices, written out."""
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def best_search_level(A_cur_ref, max_level: int):
    """Level where the warped patch covers ~1 px^2 per pixel."""
    det = det2x2(A_cur_ref).abs()
    lvl = torch.ceil(0.5 * torch.log2(torch.clamp(det, min=1e-6)))
    return torch.clamp(torch.clamp(lvl, 0, max_level).to(torch.int32), 0,
                       max_level)


def _patch_jacobian(ref_border):
    """Bordered ref patches [N, P+2, P+2] -> (inner [N, P, P],
    J [N, P*P, 3] = [dx, dy, 1], inverse Hessian [N, 3, 3])."""
    inner = ref_border[:, 1:-1, 1:-1]
    dx = 0.5 * (ref_border[:, 1:-1, 2:] - ref_border[:, 1:-1, :-2])
    dy = 0.5 * (ref_border[:, 2:, 1:-1] - ref_border[:, :-2, 1:-1])
    n, P = inner.shape[0], inner.shape[1]
    J = torch.stack([dx.reshape(n, P * P), dy.reshape(n, P * P),
                     torch.ones(n, P * P, dtype=ref_border.dtype,
                                device=ref_border.device)], -1)
    H = J.transpose(1, 2) @ J
    H = H + 1e-4 * torch.eye(3, dtype=H.dtype, device=H.device)[None]
    # inv_ex: a NaN patch gives a NaN inverse (masked downstream, as in the
    # reference) instead of an exception and a host sync
    return inner, J, torch.linalg.inv_ex(H).inverse


def _klt(sample, ref_border, uv_init, iters, eps):
    """Shared IC-KLT loop; ``sample(uv) -> [N, P, P]`` current patches."""
    ref, J, Hinv = _patch_jacobian(ref_border)
    n, P = ref.shape[0], ref.shape[1]
    ref_flat = ref.reshape(n, P * P)
    Jt = J.transpose(1, 2)
    uv = uv_init.to(torch.float32)
    mean = torch.zeros(n, dtype=torch.float32, device=uv.device)
    conv = torch.zeros(n, dtype=torch.bool, device=uv.device)
    for _ in range(iters):
        cur = sample(uv).reshape(n, P * P)
        r = cur - (ref_flat + mean[:, None])
        g = (Jt @ r[:, :, None])[..., 0]                   # [N, 3]
        delta = (Hinv @ g[:, :, None])[..., 0]              # [N, 3]
        # inverse compositional: the warp increment is subtracted; the
        # mean-brightness term is a ref-side parameter and accumulates
        step_uv = delta[:, :2]
        done = (step_uv * step_uv).sum(1) < eps * eps
        upd = ~conv
        uv = torch.where(upd[:, None], uv - step_uv, uv)
        mean = torch.where(upd, mean + delta[:, 2], mean)
        conv = conv | done
    return uv, mean, conv


def align2d(cur_img, ref_border, uv_init, valid, iters: int = 10,
            eps: float = 0.03):
    """Batched 3-DoF (du, dv, dmean) IC-KLT on one image.
    Returns (uv [N, 2], ok [N], mean_diff [N])."""
    P = ref_border.shape[1] - 2
    H_img, W_img = cur_img.shape
    uv, mean, conv = _klt(lambda u: sample_patches(cur_img, u, P),
                          ref_border, uv_init, iters, eps)
    inb = ((uv[:, 0] > HALF + 1) & (uv[:, 0] < W_img - HALF - 2)
           & (uv[:, 1] > HALF + 1) & (uv[:, 1] < H_img - HALF - 2))
    return uv, valid & conv & inb, mean


def align2d_stacked(stack, ref_border, uv_init, valid, row_off, w_l, h_l,
                    iters: int = 10, eps: float = 0.03):
    """align2d where every point aligns at its OWN level of a stacked
    [SH, W0] pyramid: the level is a row offset into the stack.

    uv_init [N, 2] level-local; row_off / w_l / h_l [N] the level's row
    offset and extents. Returns (uv level-local, ok, mean_diff)."""
    P = ref_border.shape[1] - 2
    n = uv_init.shape[0]
    off = torch.stack([torch.zeros(n, dtype=torch.float32,
                                   device=uv_init.device),
                       row_off.to(torch.float32)], -1)
    uv, mean, conv = _klt(lambda u: sample_patches(stack, u + off, P),
                          ref_border, uv_init, iters, eps)
    wf = w_l.to(torch.float32)
    hf = h_l.to(torch.float32)
    inb = ((uv[:, 0] > HALF + 1) & (uv[:, 0] < wf - HALF - 2)
           & (uv[:, 1] > HALF + 1) & (uv[:, 1] < hf - HALF - 2))
    return uv, valid & conv & inb, mean
