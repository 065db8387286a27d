"""The benchmark's generator: a periodic lap over a textured surface, its
frames rendered on the device under the configuration's camera model, what
each sensor sees besides (a rectified pair's right view, the metric depth),
and the lap's exact IMU. The scene's unit is the metre: the surface lies
about 5 m ahead.

Frozen copies of ``ygz_tpu_torch/utils/synthetic.py`` at commit 9b79ab1,
kept here so the yardstick cannot move when the port changes:

- ``make_texture`` and ``_blur_np`` (uniform noise, a separable 9-tap
  Gaussian of sigma 2, edge padding, contrast x3 about 128, clipped), in
  torch with a ``torch.Generator`` on the device;
- ``smooth_depth`` (the plane z = 5 with a 0.5-unit sine relief of period
  4) and ``PlaneScene.render``'s eight fixed-point ray-surface iterations
  and clamped bilinear texture sampling at 60 texture pixels per unit;
- ``PlaneScene.distorted_grid``'s radtan inversion (100 fixed-point
  iterations in float64), so a frame is what a camera with the
  configuration's distortion sees;
- ``synth_imu``'s derivatives: analytic accelerations of the camera
  centre, float64 rotation rates by a central difference of h = 1e-6 and
  the lever arm's second difference of h = 1e-3 (the rotation's log takes
  its angle by atan2, see ``log_so3``).

The path is a sum of sines of integer multiples of 2 pi / lap_s in each
coordinate and angle (the traffic file gives the terms), so position,
velocity and rotation repeat after one lap and a window cycling the
rendered lap sees continuous motion however long it runs.

This module imports torch and numpy, nothing of the port.
"""
from __future__ import annotations

import math

import numpy as np

PLANE_Z = 5.0
TEX_SCALE = 60.0      # texture pixels per world unit
G_W = np.array([0.0, -9.81, 0.0])   # world gravity (synth_imu's G_W)


def seed_words(seed: int) -> int:
    """The seed as a non-negative 63-bit integer (torch and numpy take it;
    seeds may pass 2**31)."""
    return int(seed) % (1 << 63)


def lap_phase(seed: int, lap_s: float) -> float:
    """Where on the lap a seed starts, in seconds of camera time."""
    rng = np.random.default_rng([seed_words(seed), 1])
    return float(rng.uniform(0.0, lap_s))


# ---------------------------------------------------------------- the path
class Lap:
    """A periodic camera path. `terms` maps each of x, y, z (the camera
    centre, world units) and pitch, yaw (radians, about the camera's x and y
    axes) to [[amplitude, harmonic], ...]: coordinate(tau) = sum of
    amplitude * sin(harmonic * 2 pi tau / lap_s). tau = t + phase."""

    AXES = ("x", "y", "z")
    ANGLES = ("pitch", "yaw")

    def __init__(self, lap_s: float, terms: dict, phase: float = 0.0):
        self.lap_s = float(lap_s)
        self.w0 = 2.0 * math.pi / self.lap_s
        self.phase = float(phase)
        self.terms = {k: [(float(a), int(h)) for a, h in terms.get(k, [])]
                      for k in self.AXES + self.ANGLES}

    def _series(self, key, tau, deriv=0):
        tau = np.asarray(tau, np.float64)
        out = np.zeros_like(tau)
        for a, h in self.terms[key]:
            w = h * self.w0
            if deriv == 0:
                out = out + a * np.sin(w * tau)
            elif deriv == 1:
                out = out + a * w * np.cos(w * tau)
            else:
                out = out - a * w * w * np.sin(w * tau)
        return out

    def centre(self, t):
        """[..., 3] camera centre at camera time t (float64)."""
        tau = np.asarray(t, np.float64) + self.phase
        return np.stack([self._series(k, tau) for k in self.AXES], -1)

    def velocity(self, t):
        tau = np.asarray(t, np.float64) + self.phase
        return np.stack([self._series(k, tau, 1) for k in self.AXES], -1)

    def accel(self, t):
        """Exact c''(t)."""
        tau = np.asarray(t, np.float64) + self.phase
        return np.stack([self._series(k, tau, 2) for k in self.AXES], -1)

    def R_cw(self, t):
        """[..., 3, 3] world->camera rotation: exp([pitch, yaw, 0])."""
        tau = np.asarray(t, np.float64) + self.phase
        w = np.stack([self._series("pitch", tau), self._series("yaw", tau),
                      np.zeros_like(tau)], -1)
        return rodrigues(w)

    def pose(self, t):
        """(R_cw [..., 3, 3], t_cw [..., 3]) in float64."""
        R = self.R_cw(t)
        c = self.centre(t)
        return R, -np.einsum("...ij,...j->...i", R, c)


def rodrigues(w):
    """float64 SO(3) exp of [..., 3] (synth_imu's _rodrigues64, batched)."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    safe = np.where(th < 1e-12, 1.0, th)
    k = w / safe[..., 0]
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)
    return np.where(th < 1e-12, eye, R)


def log_so3(R):
    """float64 SO(3) log of [..., 3, 3] (synth_imu's _log64, batched), with
    the angle by atan2 of the skew part and the trace: arccos of a trace
    near 3, as _log64 takes it, reads the 1e-7 rad of a 2e-6 s difference
    as 0 on some samples."""
    R = np.asarray(R, np.float64)
    v = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    s = 0.5 * np.linalg.norm(v, axis=-1)
    c = 0.5 * (np.trace(R, axis1=-2, axis2=-1) - 1.0)
    th = np.arctan2(s, c)
    scale = np.where(s < 1e-300, 0.5, th / (2.0 * np.maximum(s, 1e-300)))
    return v * scale[..., None]


def lap_imu(lap: Lap, hz: float, Tbc=None, g_w=G_W):
    """One lap of IMU samples at `hz`: (gyro [n, 3], acc [n, 3]) float64 at
    camera times k / hz for k = 1..n, n = lap_s * hz, of the body of a rig
    whose camera follows `lap`; Tbc [4, 4] is the camera pose in the body
    frame (synth_imu's formulas, every sample at once)."""
    Tbc = np.eye(4) if Tbc is None else np.asarray(Tbc, np.float64)
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]
    eps, h = 1e-6, 1e-3
    n = int(round(lap.lap_s * hz))
    t = np.arange(1, n + 1, dtype=np.float64) / hz

    def R_wb(tt):
        return np.swapaxes(lap.R_cw(tt), -1, -2) @ Rbc.T

    Rwb_m, Rwb_p = R_wb(t - eps), R_wb(t + eps)
    omega = log_so3(np.swapaxes(Rwb_m, -1, -2) @ Rwb_p) / (2.0 * eps)
    Rwb = R_wb(t)
    acc_w = lap.accel(t)
    if np.any(tbc):
        acc_w = acc_w - (R_wb(t + h) @ tbc - 2.0 * (Rwb @ tbc)
                         + R_wb(t - h) @ tbc) / (h * h)
    acc_body = np.einsum("nji,nj->ni", Rwb, acc_w - g_w)
    return omega, acc_body


def body_velocity(lap: Lap, t, Tbc):
    """[..., 3] world velocity of the body p_wb = c - R_wb tbc (float64,
    central difference of h = 1e-3 for the lever arm)."""
    Tbc = np.asarray(Tbc, np.float64)
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]
    t = np.asarray(t, np.float64)
    h = 1e-3

    def arm(tt):
        return np.swapaxes(lap.R_cw(tt), -1, -2) @ (Rbc.T @ tbc)

    return lap.velocity(t) - (arm(t + h) - arm(t - h)) / (2.0 * h)


def smooth_depth(x, y, base=PLANE_Z, amp=0.5, period=4.0):
    """The surface's depth z(x, y) of numpy arrays or tensors."""
    w = 2.0 * math.pi / period
    if isinstance(x, np.ndarray):
        return base + amp * np.sin(w * x) * np.sin(w * y)
    return base + amp * (w * x).sin() * (w * y).sin()


# --------------------------------------------------------- texture, render
def blur(tex, ksize=9, sigma=2.0):
    """Separable edge-padded Gaussian blur of a [H, W] float32 tensor
    (_blur_np's arithmetic: the taps summed in the same order)."""
    import torch

    r = ksize // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).tolist()
    out = tex
    for axis in (1, 0):
        pad = (r, r, 0, 0) if axis == 1 else (0, 0, r, r)
        p = torch.nn.functional.pad(out[None, None], pad,
                                    mode="replicate")[0, 0]
        acc = torch.zeros_like(out)
        n = out.shape[axis]
        for i, w in enumerate(k):
            acc += w * (p[:, i: i + n] if axis == 1 else p[i: i + n, :])
        out = acc
    return out


def make_texture(size, seed, device):
    """[size, size] float32 texture on `device` from the seed."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed_words(seed))
    tex = torch.rand((size, size), generator=g, device=device) * 255.0
    t = blur(tex)
    t = (t - t.mean()) * 3.0 + 128.0
    return t.clamp(0.0, 255.0)


def ray_grid(cam: dict, device):
    """[H, W, 3] float32 camera-frame ray directions (x, y, 1) of every
    pixel of a camera with intrinsics fx, fy, cx, cy and radtan distortion
    k1, k2, p1, p2 (k3): the distorted normalized point undistorted by 100
    fixed-point iterations in float64. Pose-independent."""
    import torch

    H, W = int(cam["height"]), int(cam["width"])
    k1, k2, p1, p2, k3 = (list(cam.get("dist", [])) + [0.0] * 5)[:5]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64,
                                         device=device),
                            torch.arange(W, dtype=torch.float64,
                                         device=device), indexing="ij")
    xd, yd = (xs - cam["cx"]) / cam["fx"], (ys - cam["cy"]) / cam["fy"]
    x, y = xd, yd
    if any((k1, k2, p1, p2, k3)):
        for _ in range(100):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
            x, y = (xd - (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
                          - x),
                    yd - (y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
                          - y))
    return torch.stack([x, y, torch.ones_like(x)], -1).to(torch.float32)


def bilinear(img, u, v):
    """Clamped bilinear sampling of [H, W] at float coordinates (the
    semantics of ops.image.sample_bilinear)."""
    import torch

    H, W = img.shape
    x = u.clamp(0.0, W - 1.001)
    y = v.clamp(0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.long()
    y0 = y0.long()
    flat = img.reshape(-1)
    i00 = flat[y0 * W + x0]
    i01 = flat[y0 * W + x0 + 1]
    i10 = flat[(y0 + 1) * W + x0]
    i11 = flat[(y0 + 1) * W + x0 + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11))


def render(tex, rays, R_cw, t_cw):
    """[N, H, W] float32 views of the surface from N world->camera poses
    (R_cw [N, 3, 3], t_cw [N, 3] float32 tensors) along `rays` [H, W, 3]."""
    import torch

    Rwc = R_cw.transpose(1, 2)
    o = -(Rwc @ t_cw[:, :, None])[:, :, 0]                 # [N, 3]
    d = torch.einsum("nij,hwj->nhwi", Rwc, rays)            # [N, H, W, 3]
    ox, oy, oz = (o[:, i, None, None] for i in range(3))
    lam = (PLANE_Z - oz) / d[..., 2]
    for _ in range(8):
        x = ox + lam * d[..., 0]
        y = oy + lam * d[..., 1]
        lam = (smooth_depth(x, y) - oz) / d[..., 2]
    c = tex.shape[0] / 2.0
    u = (ox + lam * d[..., 0]) * TEX_SCALE + c
    v = (oy + lam * d[..., 1]) * TEX_SCALE + c
    return bilinear(tex, u, v)


def render_lap(lap: Lap, cam: dict, fps: float, seed: int, device,
               tex_size: int, n_frames=None, chunk: int = 40):
    """One lap of uint8 frames [n, H, W] on the host, rendered on `device`
    in chunks: frame k is the view at camera time k / fps. `n_frames`
    (default: the whole lap) renders only the first frames."""
    import torch

    n_lap = int(round(lap.lap_s * fps))
    n = n_lap if n_frames is None else min(int(n_frames), n_lap)
    tex = make_texture(tex_size, seed, device)
    rays = ray_grid(cam, device)
    R, t = lap.pose(np.arange(n) / fps)
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    out = torch.empty((n, int(cam["height"]), int(cam["width"])),
                      dtype=torch.uint8)
    if str(device).startswith("cuda"):
        out = out.pin_memory()
    for i in range(0, n, chunk):
        img = render(tex, rays, R[i: i + chunk], t[i: i + chunk])
        # clip then truncate toward zero, as numpy's astype(uint8)
        out[i: i + chunk].copy_(img.clamp(0.0, 255.0).to(torch.uint8))
    return out.numpy()


# ------------------------------------------------- the other sensors' views
# Functions added beside render and render_lap, which are left as they are
# so that the monocular frames stay the same bit for bit.
def render_depth(rays, R_cw, t_cw):
    """[N, H, W] float32 metric depth of the views that render draws: the
    camera-frame z of render's last ray-surface iterate, which is its ray
    parameter itself, since the rays have z = 1 (the same eight fixed-point
    iterations, so a pixel's depth is that of the point whose texture it
    shows)."""
    import torch

    Rwc = R_cw.transpose(1, 2)
    o = -(Rwc @ t_cw[:, :, None])[:, :, 0]
    d = torch.einsum("nij,hwj->nhwi", Rwc, rays)
    ox, oy, oz = (o[:, i, None, None] for i in range(3))
    lam = (PLANE_Z - oz) / d[..., 2]
    for _ in range(8):
        x = ox + lam * d[..., 0]
        y = oy + lam * d[..., 1]
        lam = (smooth_depth(x, y) - oz) / d[..., 2]
    return lam


def _lap_chunks(lap, cam, fps, device, n_frames, chunk, draw, dtype):
    """[n, H, W] host array of `dtype`: draw(rays, R_cw, t_cw) of each chunk
    of the lap's frame poses (frame k at camera time k / fps)."""
    import torch

    n_lap = int(round(lap.lap_s * fps))
    n = n_lap if n_frames is None else min(int(n_frames), n_lap)
    rays = ray_grid(cam, device)
    R, t = lap.pose(np.arange(n) / fps)
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    out = torch.empty((n, int(cam["height"]), int(cam["width"])),
                      dtype=dtype)
    for i in range(0, n, chunk):
        out[i: i + chunk].copy_(draw(rays, R[i: i + chunk],
                                     t[i: i + chunk]))
    return out.numpy()


def render_lap_right(lap: Lap, cam: dict, fps: float, seed: int, device,
                     tex_size: int, n_frames=None, chunk: int = 40):
    """The right views [n, H, W] uint8 of render_lap's frames: a rectified
    pair's second camera, with the same pinhole intrinsics and the same
    rotation, its centre moved by the baseline b = cam["bf"] / cam["fx"]
    metres along the left camera's own +x axis: t_right = t_cw - [b, 0,
    0]."""
    import torch

    tex = make_texture(tex_size, seed, device)
    b = float(cam["bf"]) / float(cam["fx"])

    def draw(rays, R, t):
        img = render(tex, rays, R, t - t.new_tensor([b, 0.0, 0.0]))
        return img.clamp(0.0, 255.0).to(torch.uint8)

    return _lap_chunks(lap, cam, fps, device, n_frames, chunk, draw,
                       torch.uint8)


def render_lap_depth(lap: Lap, cam: dict, fps: float, device, n_frames=None,
                     chunk: int = 40):
    """The metric depth maps [n, H, W] float32 of render_lap's frames
    (render_depth), aligned with them pixel for pixel."""
    import torch

    return _lap_chunks(lap, cam, fps, device, n_frames, chunk, render_depth,
                       torch.float32)


def frame_imu_span(j: int, fps: float, hz: float):
    """The IMU samples frame j (camera time j / fps) is fed: the global
    sample numbers g, sample g at camera time g / hz, with (j - 1) / fps <
    g / hz <= j / fps, as range(lo, hi). Exact in rationals, so consecutive
    frames share no sample and skip none. Sample g is lap_imu's sample
    (g - 1) mod n: the lap's samples repeat with it."""
    from fractions import Fraction

    r = Fraction(hz) / Fraction(fps)
    return math.floor((j - 1) * r) + 1, math.floor(j * r) + 1
