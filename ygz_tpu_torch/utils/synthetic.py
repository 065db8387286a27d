"""Synthetic textured-surface scene with exact image formation (numpy only).

The numpy render path of ``ygz_tpu.utils.synthetic``: a camera observes a
textured surface z = depth_fn(x, y) in the world frame; any view is rendered
by inverse-warping the texture with clamped bilinear sampling. Every pixel
has known depth, which gives analytic ground truth for the end-to-end runs
(tests and ``chip_smoke.py``). Rendering stays on the host so the frames
are identical whichever device the tracker runs on. Surfaces: the plane,
``SmoothScene`` (smooth relief) and ``StepScene`` (terraced depth);
``Nuisance`` adds a real camera's exposure changes, noise, blur and
occluders to rendered frames.

The mono-inertial runs add a continuous camera trajectory (``pose_fn``:
0.6 m/s forward, a +-0.15 m lateral sine, small angles) and its exact IMU
(``synth_imu``: analytic accelerations, float64 rotation rates, 200 Hz), for
any body-to-camera rig ``Tbc``.
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

    def distorted_grid(self, fx, fy, cx, cy, dist, iters=100):
        """[h, w, 2] f32: for each pixel of a camera with intrinsics (fx,
        fy, cx, cy) and radtan distortion dist = [k1, k2, p1, p2(, k3)],
        the point of this scene's pinhole image on the same ray (the
        distorted normalized point undistorted by fixed-point iteration in
        float64). Pose-independent: compute it once per camera."""
        k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
        ys, xs = np.mgrid[0: self.h, 0: self.w].astype(np.float64)
        xd, yd = (xs - cx) / fx, (ys - cy) / fy
        x, y = xd, yd
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
            x, y = (xd - (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
                          - x),
                    yd - (y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
                          - y))
        return np.stack([x * self.f + self.cx, y * self.f + self.cy],
                        -1).astype(np.float32)

    def render_at(self, R, t, uv):
        """The view from (R, t) sampled at pinhole pixel positions uv
        [..., 2] (e.g. a distorted_grid). Returns [...] f32."""
        o_w, d_w = self._rays(R, t, uv)
        lam = self._intersect(o_w, d_w)
        Xw = o_w + lam[..., None] * d_w
        return _bilinear_np(self.tex, self.world_to_tex(Xw))

    def render_pair(self, R, t, baseline):
        """A rectified stereo pair [h, w] f32: the left view at (R, t) and
        the right camera `baseline` along the left camera's x axis, at
        t - [baseline, 0, 0]."""
        t = np.asarray(t, np.float32)
        right_t = t - np.array([baseline, 0.0, 0.0], np.float32)
        return self.render(R, t), self.render(R, right_t)

    def depth(self, R, t):
        """Per-pixel metric depth [h, w] f32 of the view from (R, t): the
        camera-frame z of each pixel's ray-surface intersection."""
        R = np.asarray(R, np.float32)
        t = np.asarray(t, np.float32)
        o_w, d_w = self._rays(R, t)
        lam = self._intersect(o_w, d_w)
        Xw = o_w[None, None, :] + lam[..., None] * d_w
        return (Xw @ R.T + t)[..., 2].astype(np.float32)

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


def step_depth(x, y, base=PLANE_Z, amp=1.2, cell=1.1):
    """Piecewise-constant 'terraced' depth: breaks the planar-homography
    degeneracy of single-plane scenes."""
    cx = np.floor(x / cell).astype(np.int64)
    cy = np.floor(y / cell).astype(np.int64)
    h = ((cx * 1103515245 + cy * 12345) % 4) / 3.0  # deterministic 0..1
    return base + amp * (h - 0.5)


class StepScene(PlaneScene):
    def __init__(self, **kw):
        kw.setdefault("depth_fn", step_depth)
        super().__init__(**kw)


class Nuisance:
    """Photometric and occlusion nuisances of a real camera that the clean
    renderer lacks: per-frame exposure gain and bias, Gaussian pixel noise,
    occasional motion blur, and moving flat occluder rectangles (untextured
    regions that defeat both direct alignment and descriptors locally).
    Each frame draws from ``default_rng((seed, frame_idx))``, in the JAX
    package's order, so both packages make the same frames."""

    def __init__(self, seed: int = 0, gain: float = 0.15, bias: float = 8.0,
                 noise: float = 2.0, blur_p: float = 0.2,
                 n_occluders: int = 2, occ_size: int = 70):
        self.seed = seed
        self.gain = gain
        self.bias = bias
        self.noise = noise
        self.blur_p = blur_p
        self.n_occluders = n_occluders
        self.occ_size = occ_size

    def apply(self, img, frame_idx: int):
        img = np.asarray(img, np.float32)
        h, w = img.shape
        rng = np.random.default_rng((self.seed, frame_idx))
        g = 1.0 + rng.uniform(-self.gain, self.gain)
        b = rng.uniform(-self.bias, self.bias)
        out = img * g + b
        if rng.random() < self.blur_p:
            out = _blur_np(out, 5, 1.0)
        for _ in range(self.n_occluders):
            s = int(rng.uniform(0.5, 1.5) * self.occ_size)
            x0 = int(rng.uniform(0, max(w - s, 1)))
            y0 = int(rng.uniform(0, max(h - s, 1)))
            out[y0: y0 + s, x0: x0 + s] = rng.uniform(40, 200)
        out = out + rng.normal(0, self.noise, out.shape)
        return np.clip(out, 0, 255).astype(np.float32)


# ---------------------------------------------------------------------------
# Continuous mono-inertial trajectory and its IMU

G_W = np.array([0.0, -9.81, 0.0], np.float32)  # world gravity (vision frame)
IMU_HZ = 200.0


def _rodrigues64(w):
    """float64 SO(3) exp (the synthesis must not lose precision to
    float32)."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _log64(R):
    c = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(c)
    if th < 1e-10:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * th / (2 * np.sin(th))


def _angles(t):
    return np.array([0.015 * np.sin(1.8 * t + 1.0), 0.03 * np.sin(3.0 * t),
                     0.0])


def _centre(t):
    return np.array([0.6 * t, 0.15 * np.sin(2.0 * t), 0.0])


def _accel(t):
    return np.array([0.0, -0.6 * np.sin(2.0 * t), 0.0])  # exact c''(t)


def _R_cw64(t):
    return _rodrigues64(_angles(t))


def pose_fn(t):
    """Continuous camera trajectory: the world->cam (R, t) at time t."""
    R = _R_cw64(t)
    c = _centre(t)
    return R.astype(np.float32), (-R @ c).astype(np.float32)


def _R_wb64(t, Rbc):
    return _R_cw64(t).T @ Rbc.T


def synth_imu(t0, t1, Tbc=None, g_w=G_W, hz=IMU_HZ):
    """IMU samples (t, gyro [3], acc [3]) in (t0, t1] of the body of a rig
    whose camera follows pose_fn; Tbc [4, 4] is the camera pose in the body
    frame (identity: body == camera). Analytic accelerations of the camera
    centre, float64 rotation rates (float32 double differencing would add
    ~100 m/s^2 of noise); a lever arm tbc adds the second difference of
    R_wb tbc (float64, h = 1e-3)."""
    Tbc = np.eye(4) if Tbc is None else np.asarray(Tbc, np.float64)
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]
    eps, h = 1e-6, 1e-3
    out = []
    n = int(round((t1 - t0) * hz))
    for k in range(1, n + 1):
        t = t0 + k / hz
        Rwb_m = _R_wb64(t - eps, Rbc)
        Rwb_p = _R_wb64(t + eps, Rbc)
        omega = _log64(Rwb_m.T @ Rwb_p) / (2 * eps)
        # body position p_wb = c - R_wb tbc
        acc_w = _accel(t)
        if np.any(tbc):
            acc_w = acc_w - (_R_wb64(t + h, Rbc) @ tbc
                             - 2 * _R_wb64(t, Rbc) @ tbc
                             + _R_wb64(t - h, Rbc) @ tbc) / (h * h)
        acc_body = _R_wb64(t, Rbc).T @ (acc_w - g_w)
        out.append((t, omega.astype(np.float32), acc_body.astype(np.float32)))
    return out
