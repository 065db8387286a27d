"""Core image ops: bilinear sampling, remap, blur, pyramid, stacked layout.

Port of ``ygz_tpu/ops/image.py`` on [H, W] float32 tensors. Only the
``scale_factor == 2.0`` pyramid is supported: the JAX package resizes other
factors with ``jax.image.resize``, which antialiases when it downsamples and
has no bit-compatible torch counterpart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sample_bilinear(img, uv):
    """Bilinearly sample img [H, W] at uv [..., 2] (x, y); coordinates are
    clamped to the interpolation domain. Returns [...]."""
    H, W = img.shape
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    # integer corners clamped again after the cast: a NaN coordinate then
    # reads a valid pixel (and stays NaN) instead of indexing out of range
    i0 = (torch.clamp(y0f.long(), 0, H - 2) * W
          + torch.clamp(x0f.long(), 0, W - 2))
    flat = img.reshape(-1)
    i00 = flat[i0]
    i01 = flat[i0 + 1]
    i10 = flat[i0 + W]
    i11 = flat[i0 + W + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11))


def in_bounds(uv, w, h, border=0.0):
    return ((uv[..., 0] >= border) & (uv[..., 0] < w - 1 - border)
            & (uv[..., 1] >= border) & (uv[..., 1] < h - 1 - border))


def remap(img, map_u, map_v):
    """cv::remap: out[y, x] = bilinear(img, map_u[y, x], map_v[y, x])."""
    return sample_bilinear(img, torch.stack([map_u, map_v], -1))


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable edge-padded Gaussian blur (the reference blurs 7x7,
    sigma 2 before BRIEF). Written as explicit shifted sums so the result
    does not depend on a convolution library's algorithm choice."""
    r = ksize // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    H, W = img.shape
    p = F.pad(img[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    out = k[0] * p[:, 0:W]
    for i in range(1, ksize):
        out = out + k[i] * p[:, i:i + W]
    p = F.pad(out[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    res = k[0] * p[0:H]
    for i in range(1, ksize):
        res = res + k[i] * p[i:i + H]
    return res


def halfsample(img):
    """2x2 average downsample."""
    H, W = img.shape
    H2, W2 = H // 2, W // 2
    return img[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2).mean(dim=(1, 3))


def _check_factor(scale_factor):
    if scale_factor != 2.0:
        raise NotImplementedError(
            "only scale_factor == 2.0 is ported (the JAX package resizes "
            "other factors with an antialiasing jax.image.resize)")


def build_pyramid(img, num_levels: int, scale_factor: float = 2.0):
    """Image pyramid as a tuple of [H_l, W_l] tensors."""
    _check_factor(scale_factor)
    levels = [img]
    for _ in range(1, num_levels):
        levels.append(halfsample(levels[-1]))
    return tuple(levels)


# --------------------------------------------------------- stacked pyramids
# One [SH, W0] buffer: level l occupies rows row_off[l] : row_off[l] + H_l,
# columns 0 : W_l (zero-padded to W0) — the JAX package's layout.

def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float = 2.0):
    _check_factor(scale_factor)
    shapes = [(h, w)]
    for _ in range(1, n_levels):
        ph, pw = shapes[-1]
        shapes.append((ph // 2, pw // 2))
    return shapes


def stack_rows(h: int, w: int, n_levels: int, scale_factor: float = 2.0):
    """(row_offsets, total_rows) of the stacked layout."""
    offs, acc = [], 0
    for (ph, _pw) in pyramid_shapes(h, w, n_levels, scale_factor):
        offs.append(acc)
        acc += ph
    return offs, acc


def infer_height(sh: int, w: int, n_levels: int,
                 scale_factor: float = 2.0) -> int:
    """Level-0 height of a stacked pyramid with `sh` rows. With halving
    levels sh = sum_l floor(h / 2^l), so h lies in [sh / s, (sh + L) / s]
    for s = sum_l 2^-l; the search starts there."""
    s = sum(0.5 ** lvl for lvl in range(n_levels))
    for h in range(max(1, int(sh / s) - 1), sh + 1):
        if stack_rows(h, w, n_levels, scale_factor)[1] == sh:
            return h
    raise ValueError(f"cannot infer level heights from SH={sh}")


def stack_and_height(pyr, n_levels: int):
    """(stacked [SH, W0] buffer, level-0 height) of either representation."""
    if isinstance(pyr, (tuple, list)):
        return stack_pyramid(pyr), pyr[0].shape[0]
    return pyr, infer_height(pyr.shape[0], pyr.shape[1], n_levels)


def stack_pyramid(pyr):
    """Tuple of [H_l, W_l] levels -> one [SH, W0] buffer."""
    w0 = pyr[0].shape[1]
    return torch.cat([F.pad(lv, (0, w0 - lv.shape[1])) for lv in pyr], 0)


def unstack_pyramid(stack, n_levels: int, scale_factor: float = 2.0,
                    height: int | None = None):
    """Stacked [SH, W0] -> tuple of [H_l, W_l] views."""
    w0 = stack.shape[1]
    if height is None:
        height = infer_height(stack.shape[0], w0, n_levels, scale_factor)
    shapes = pyramid_shapes(height, w0, n_levels, scale_factor)
    offs, total = stack_rows(height, w0, n_levels, scale_factor)
    if total != stack.shape[0]:
        raise ValueError(f"stack has {stack.shape[0]} rows, layout {total}")
    return tuple(stack[o: o + ph, :pw] for o, (ph, pw) in zip(offs, shapes))


def as_levels(pyr, n_levels: int, scale_factor: float = 2.0,
              height: int | None = None):
    """Accept a level tuple or a stacked buffer; return the tuple form."""
    if isinstance(pyr, (tuple, list)):
        return tuple(pyr)
    return unstack_pyramid(pyr, n_levels, scale_factor, height)


def extract_patches(img, uv, half: int):
    """Square (2*half+1)^2 patches at integer-rounded uv [N, 2], centres
    clamped so patches stay in-image. Returns [N, 2h+1, 2h+1]."""
    H, W = img.shape
    if min(H, W) < 2 * half + 1:
        # the clamped gather would read wrapped rows (JAX's dynamic_slice
        # refuses such an image outright)
        raise ValueError(f"extract_patches: a {2 * half + 1}-px patch does "
                         f"not fit a {H}x{W} image")
    cx =torch.clamp(torch.round(uv[:, 0]).long(), half, W - half - 1)
    cy = torch.clamp(torch.round(uv[:, 1]).long(), half, H - half - 1)
    r = torch.arange(-half, half + 1, device=img.device)
    idx = ((cy[:, None, None] + r[None, :, None]) * W
           + cx[:, None, None] + r[None, None, :])
    return img.reshape(-1)[idx]
