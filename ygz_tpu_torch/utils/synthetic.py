"""Synthetic textured-surface scene with exact image formation (numpy only).

The numpy render path of ``ygz_tpu.utils.synthetic``: a camera observes a
textured surface z = depth_fn(x, y) in the world frame; any view is rendered
by inverse-warping the texture with clamped bilinear sampling. Every pixel
has known depth, which gives analytic ground truth for the end-to-end runs
(tests and ``chip_smoke.py``). Rendering stays on the host so the frames
are identical whichever device the tracker runs on.
"""
from __future__ import annotations

import numpy as np

PLANE_Z = 5.0
TEX_SCALE = 60.0  # texture pixels per world unit


def _blur_np(tex, ksize, sigma):
    """Separable edge-padded Gaussian blur in numpy."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    out = tex
    for axis in (1, 0):
        p = np.pad(out, [(0, 0), (r, r)] if axis == 1 else [(r, r), (0, 0)],
                   mode="edge")
        acc = np.zeros_like(out)
        for i, w in enumerate(k):
            sl = (slice(None), slice(i, i + out.shape[1])) if axis == 1 \
                else (slice(i, i + out.shape[0]), slice(None))
            acc += w * p[sl]
        out = acc
    return out


def make_texture(size=1600, seed=0, blur_sigma=2.0):
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, (size, size)).astype(np.float32)
    t = _blur_np(tex, 9, blur_sigma)
    t = (t - t.mean()) * 3.0 + 128.0   # boost contrast after blur
    return np.clip(t, 0, 255).astype(np.float32)


def _bilinear_np(img, uv):
    """Bilinear sampling with coordinates clamped to the interpolation
    domain (the semantics of ops.image.sample_bilinear)."""
    H, W = img.shape
    x = np.clip(uv[..., 0], 0.0, W - 1.001)
    y = np.clip(uv[..., 1], 0.0, H - 1.001)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    fx = (x - x0).astype(np.float32)
    fy = (y - y0).astype(np.float32)
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11)).astype(np.float32)


class PlaneScene:
    """Camera intrinsics + textured surface; render views at any pose.

    Pose convention: (R, t) maps WORLD -> CAMERA. World frame = first
    camera frame. ``depth_fn(x, y) -> z`` is the surface depth (default:
    the constant plane z = PLANE_Z, which is degenerate for monocular VO;
    end-to-end runs use SmoothScene)."""

    def __init__(self, w=640, h=480, f=400.0, seed=0, tex_size=1600,
                 depth_fn=None):
        self.w, self.h, self.f = w, h, float(f)
        self.cx, self.cy = w / 2.0 - 0.5, h / 2.0 - 0.5
        self.K = np.array([[f, 0, self.cx], [0, f, self.cy], [0, 0, 1]],
                          np.float32)
        self.tex = make_texture(tex_size, seed)
        self.tex_c = tex_size / 2.0
        self.depth_fn = depth_fn or (lambda x, y: np.full_like(x, PLANE_Z))

    def world_to_tex(self, Xw):
        return np.stack([Xw[..., 0] * TEX_SCALE + self.tex_c,
                         Xw[..., 1] * TEX_SCALE + self.tex_c], axis=-1)

    def _intersect(self, o_w, d_w):
        """Ray-surface intersection by fixed-point iteration on lambda."""
        lam = (PLANE_Z - o_w[2]) / d_w[..., 2]
        for _ in range(8):
            x = o_w[0] + lam * d_w[..., 0]
            y = o_w[1] + lam * d_w[..., 1]
            z = self.depth_fn(x, y)
            lam = (z - o_w[2]) / d_w[..., 2]
        return lam

    def _rays(self, R, t, uv=None):
        R = np.asarray(R, np.float32)
        t = np.asarray(t, np.float32)
        if uv is None:
            ys, xs = np.mgrid[0: self.h, 0: self.w].astype(np.float32)
        else:
            xs, ys = uv[..., 0], uv[..., 1]
        d_cam = np.stack([(xs - self.cx) / self.f, (ys - self.cy) / self.f,
                          np.ones_like(xs)], axis=-1)
        Rwc = R.T
        return -Rwc @ t, d_cam @ Rwc.T

    def render(self, R, t):
        """Render the view from pose (R, t) (world->cam). Returns [h,w] f32."""
        o_w, d_w = self._rays(R, t)
        lam = self._intersect(o_w, d_w)
        Xw = o_w[None, None, :] + lam[..., None] * d_w
        return _bilinear_np(self.tex, self.world_to_tex(Xw))

    def render_u8(self, R, t):
        """The view as a camera's u8 frame [h, w]."""
        return np.clip(self.render(R, t), 0, 255).astype(np.uint8)

    def project(self, R, t, Xw):
        """World points -> pixels for pose (R,t). Returns uv [N,2], z [N]."""
        Xc = Xw @ np.asarray(R).T + np.asarray(t)
        u = self.f * Xc[:, 0] / Xc[:, 2] + self.cx
        v = self.f * Xc[:, 1] / Xc[:, 2] + self.cy
        return np.stack([u, v], axis=-1).astype(np.float32), Xc[:, 2]

    def backproject(self, R, t, uv):
        """Pixels in view (R,t) -> world points on the surface."""
        o_w, d_w = self._rays(R, t, np.asarray(uv, np.float32))
        lam = self._intersect(o_w, d_w)
        return (o_w[None, :] + lam[:, None] * d_w).astype(np.float32)


def smooth_depth(x, y, base=PLANE_Z, amp=0.5, period=4.0):
    """Smooth non-planar depth (breaks the planar-homography degeneracy
    without depth discontinuities)."""
    w = 2.0 * np.pi / period
    return base + amp * np.sin(w * x) * np.sin(w * y)


class SmoothScene(PlaneScene):
    def __init__(self, **kw):
        kw.setdefault("depth_fn", smooth_depth)
        super().__init__(**kw)
