"""Shared inputs of the direct tracker's tests: the CPU parity tests against
JAX (test_torch_direct_align.py) and the card tests of the one-launch
kernel against the plain version (test_torch_cuda.py). No JAX here: the
card tests import this without it.

A textured plane seen by the current camera (752x480, the EuRoC size) at
depth 5 and by four reference cameras on the same axis at 1, 1.4, 2.8 and
5.6 times that depth, so the cached points' search levels are 0/1, 1, 2
and 3. Each point's stored 20x20 patch is captured from its reference
camera's pyramid at its reference level, as the mapper captures it. The
cases (numpy from a seed) put points on the selection's 20-px border and
at the stacked buffer's bottom clamp (C-ref1), give patches that are NaN
or faint noise that never converges, take every point's validity away,
use one point or a ragged 1,500, or put points behind the camera.
"""
import functools

import numpy as np
import torch

from ygz_tpu_torch.frontend.direct_tracker import capture_ref_patches_core
from ygz_tpu_torch.ops.image import build_pyramid, stack_pyramid
from ygz_tpu_torch.utils.synthetic import PlaneScene

from torch_gn_cases import H0, INTR, W0, so3
from torch_parity import render_u8

N_LEVELS = 4
DEPTH_FACTORS = (1.0, 1.4, 2.8, 5.6)   # ceil(log2 k): levels 0/1, 1, 2, 3
R_CUR = so3([0.01, -0.02, 0.005])
T_CUR = np.array([0.05, 0.02, 0.01], np.float32)
# the predicted pose the tracker starts from: ~0.6 deg and ~1.5 cm off
R_PRED = (so3([0.004, 0.006, -0.003]) @ R_CUR).astype(np.float32)
T_PRED = (T_CUR + np.array([0.012, -0.008, 0.004], np.float32))

CASES = {
    "main": dict(seed=0, n=512),
    "level_borders": dict(seed=1, n=512, border=True),
    "nan_patch": dict(seed=2, n=512, nan=64),
    "no_valid_point": dict(seed=3, n=512, no_valid=True),
    "one_point": dict(seed=4, n=1),
    "ragged_1500": dict(seed=5, n=1500),
    "never_converge": dict(seed=6, n=512, noise=128),
    "behind_camera": dict(seed=7, n=512, behind=40),
}


@functools.lru_cache(maxsize=None)
def scene_frames():
    """(scene, the current frame's stacked pyramid, each reference camera's
    stacked pyramid), numpy float32."""
    scene = PlaneScene(seed=7, w=W0, h=H0, f=INTR[0], tex_size=2400)
    cur = render_u8(scene, R_CUR, T_CUR)
    refs = [render_u8(scene, np.eye(3, dtype=np.float32), ref_t(k))
            for k in DEPTH_FACTORS]

    def stacked(img):
        return stack_pyramid(build_pyramid(torch.as_tensor(img),
                                           N_LEVELS)).numpy()

    return scene, stacked(cur), tuple(stacked(r) for r in refs)


def ref_t(k):
    """The reference camera k times the plane's depth away, on the axis."""
    return np.array([0.0, 0.0, 5.0 * (k - 1.0)], np.float32)


def border_pixels(rng, n):
    """Current-frame pixels within a pixel of the 20-px border lines, and
    at the bottom right, where level 3's 9x9 gather reaches the stacked
    buffer's last rows and is clamped to SH - 9 (C-ref1)."""
    uv = rng.uniform(24, [W0 - 25, H0 - 25], (n, 2))
    q = n // 6
    uv[:q, 0] = 20.0 + rng.uniform(-1, 1, q)
    uv[q: 2 * q, 0] = W0 - 21.0 + rng.uniform(-1, 1, q)
    uv[2 * q: 3 * q, 1] = 20.0 + rng.uniform(-1, 1, q)
    uv[3 * q: 4 * q, 1] = H0 - 21.0 + rng.uniform(-1, 1, q)
    uv[4 * q: 5 * q] = np.stack([rng.uniform(W0 - 40, W0 - 20, q),
                                 rng.uniform(H0 - 26, H0 - 20, q)], 1)
    return uv


@functools.lru_cache(maxsize=None)
def direct_case(seed, n, border=False, nan=0, no_valid=False, noise=0,
                behind=0):
    """The cached points of a case as numpy arrays, in
    track_local_map_direct's order: xyz [n, 3], valid [n], patch
    [n, 20, 20], ref_uv [n, 2], ref_level [n] int32, ref_R [n, 3, 3],
    ref_t [n, 3]."""
    scene, _, ref_stacks = scene_frames()
    rng = np.random.default_rng(seed)
    uv_cur = (border_pixels(rng, n) if border else
              rng.uniform(40, [W0 - 40, H0 - 40], (n, 2)))
    X = scene.backproject(R_CUR, T_CUR, uv_cur.astype(np.float32))
    group = rng.integers(0, len(DEPTH_FACTORS), n)
    # the stored patch's octave; at k = 1 a search at level 1 needs a
    # reference at level 1 to stay inside the stored patch
    level = np.where(group == 0, 1, rng.integers(0, 2, n)).astype(np.int32)
    ref_uv = np.zeros((n, 2), np.float32)
    patch = np.zeros((n, 20, 20), np.float32)
    for g, k in enumerate(DEPTH_FACTORS):
        m = group == g
        if not m.any():
            continue
        ref_uv[m], _ = scene.project(np.eye(3), ref_t(k), X[m])
        patch[m] = capture_ref_patches_core(
            torch.as_tensor(ref_stacks[g]), torch.as_tensor(ref_uv[m]),
            torch.as_tensor(level[m]), N_LEVELS).numpy()
    ref_R = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    ref_tr = np.stack([ref_t(DEPTH_FACTORS[g]) for g in group]).astype(
        np.float32)
    valid = np.zeros(n, bool) if no_valid else rng.random(n) > 0.05
    if nan:
        patch[rng.choice(n, nan, replace=False)] = np.nan
    if noise:
        # faint noise on grey: gradients of ~0.03 against the image's ~20,
        # so every step is tens of pixels long and none passes the 0.03-px
        # test
        idx = rng.choice(n, noise, replace=False)
        patch[idx] = 128.0 + rng.uniform(-0.05, 0.05, (noise, 20, 20))
    if behind:
        X[n - behind:] = -X[n - behind:]      # z < 0 in every camera
    return (X.astype(np.float32), valid, patch, ref_uv, level, ref_R,
            ref_tr)
