"""Sparse inverse-compositional image alignment (SVO-style).

Port of ``ygz_tpu/frontend/sparse_align.py``: per pyramid level (coarse ->
fine, never level 0), 4x4 patches around the previous frame's points,
Jacobians precomputed once per level in the reference frame, a fixed number
of Gauss-Newton iterations on SE(3) with per-pixel Huber weights and a
Jacobi-preconditioned 6x6 solve; T <- T * exp(-delta).

``sparse_image_align`` runs every level's loop in one launch of the
hand-written CUDA kernel ``csrc/sparse_align.cu`` on CUDA tensors, and the
plain PyTorch version ``sparse_image_align_torch`` on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from ..backend.optim import solve_preconditioned
from ..geometry.lie import se3_exp, se3_mul
from ..ops.align import sample_patches
from ..ops.image import in_bounds
from ..utils import cuda_build

PATCH_HALF = 2      # 4x4 patches like the reference
PATCH = 2 * PATCH_HALF


class SparseAlignResult(NamedTuple):
    R: torch.Tensor        # [3, 3] cur <- ref
    t: torch.Tensor        # [3]
    n_meas: torch.Tensor   # points contributing at the finest level
    mean_res: torch.Tensor  # mean |residual| at convergence


def sparse_image_align_torch(ref_pyr, cur_pyr, uv0, X_ref, valid, intr,
                             R_init, t_init,
                             levels: Sequence[int] = (3, 2, 1),
                             iters: int = 10):
    """Estimate T_cur_ref by direct alignment (plain PyTorch).

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


def _level_args(pyr, levels, name):
    """Per level of the walk: the image's pointer and (h, w, row stride)."""
    ptrs, hws = [], []
    for lvl in levels:
        img = pyr[lvl]
        if img.dtype != torch.float32 or img.dim() != 2:
            raise TypeError(f"{name}[{lvl}] must be a 2-D float32 tensor")
        if img.stride(1) != 1:
            raise ValueError(f"{name}[{lvl}]: pixels of a row must be "
                             f"adjacent")
        h, w = img.shape
        # sample_patches' 7x7 gather of the bordered reference patch
        if h < PATCH + 3 or w < PATCH + 3:
            raise ValueError(f"{name}[{lvl}] is {h}x{w}: below 7x7")
        ptrs.append(img.data_ptr())
        hws += [h, w, img.stride(0)]
    return ptrs, hws


def sparse_image_align(ref_pyr, cur_pyr, uv0, X_ref, valid, intr,
                       R_init, t_init, levels: Sequence[int] = (3, 2, 1),
                       iters: int = 10):
    """Estimate T_cur_ref by direct alignment.

    ref_pyr, cur_pyr: tuples of [H_l, W_l] levels; uv0 [N, 2] level-0
    pixels in the ref frame; X_ref [N, 3] points in the REF camera frame;
    valid [N]; intr (fx, fy, cx, cy) at level 0.

    CUDA tensors run one launch of the hand-written kernel over all levels
    (counted in ``sparse_image_align.launches``); CPU tensors run the plain
    version ``sparse_image_align_torch``; any other device raises."""
    args = (ref_pyr, cur_pyr, uv0, X_ref, valid, intr, R_init, t_init,
            levels, iters)
    tensors = [uv0, X_ref, valid, R_init, t_init] + [
        pyr[lvl] for pyr in (ref_pyr, cur_pyr) for lvl in levels]
    return cuda_build.on_device(
        "sparse_image_align", tensors, lambda: _sparse_align(*args),
        lambda: sparse_image_align_torch(*args))


def _sparse_align(ref_pyr, cur_pyr, uv0, X_ref, valid, intr, R_init, t_init,
                  levels, iters):
    """One launch of csrc/sparse_align.cu on the inputs' stream."""
    f32 = torch.float32
    dev = uv0.device
    levels = tuple(levels)
    N = uv0.shape[0]
    uv0, suv = cuda_build.rows_arg(uv0, 2, f32, "uv0")
    X_ref, sx = cuda_build.rows_arg(X_ref, 3, f32, "X_ref")
    valid, sval = cuda_build.rows_arg(valid, 0, torch.bool, "valid")
    if not (X_ref.shape[0] == valid.shape[0] == N) or N < 1:
        raise ValueError("sparse_image_align: rows of unequal length")
    if tuple(R_init.shape) != (3, 3) or tuple(t_init.shape) != (3,) \
            or R_init.dtype != f32 or t_init.dtype != f32:
        raise TypeError("sparse_image_align: R_init [3, 3] and t_init [3] "
                        "float32")
    ref_ptrs, ref_hws = _level_args(ref_pyr, levels, "ref_pyr")
    cur_ptrs, cur_hws = _level_args(cur_pyr, levels, "cur_pyr")
    R_init, t_init = R_init.contiguous(), t_init.contiguous()
    # the level intrinsics as the plain version forms them (Python floats)
    fx, fy, cx, cy = (float(v) for v in intr)
    lv_intr = []
    for lvl in levels:
        s = 0.5 ** lvl
        lv_intr += [s, fx * s, fy * s, (cx + 0.5) * s - 0.5,
                    (cy + 0.5) * s - 0.5]
    n_lv = len(levels)
    ptrs = ctypes.c_void_p * n_lv
    ints = ctypes.c_int * (3 * n_lv)
    floats = ctypes.c_float * (5 * n_lv)
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn = cuda_build.function(
        "sparse_align", "ygz_sparse_align",
        [p, i, p, i, p, i, i, p, p, p, p, p, i, p, p, i, p, p, p, p, p])
    # the kernel owns its level limit
    max_levels = cuda_build.function(
        "sparse_align", "ygz_sparse_align_max_levels", [])()
    if n_lv > max_levels:
        raise ValueError(f"sparse_image_align: {n_lv} levels is more than "
                         f"the kernel takes")
    R = torch.empty((3, 3), dtype=f32, device=dev)
    t = torch.empty(3, dtype=f32, device=dev)
    n_meas = torch.empty((), dtype=torch.int64, device=dev)
    mean_res = torch.empty((), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check_launch(fn(
        uv0.data_ptr(), suv, X_ref.data_ptr(), sx, valid.data_ptr(), sval, N,
        ptrs(*ref_ptrs), ints(*ref_hws), ptrs(*cur_ptrs), ints(*cur_hws),
        floats(*lv_intr), n_lv, R_init.data_ptr(), t_init.data_ptr(),
        int(iters), R.data_ptr(), t.data_ptr(),
        n_meas.data_ptr(), mean_res.data_ptr(), stream), "sparse_align")
    cuda_build.count_launch(sparse_image_align)
    return SparseAlignResult(R=R, t=t, n_meas=n_meas, mean_res=mean_res)


sparse_image_align.launches = 0
