"""Shared inputs of the pose Gauss-Newton and sparse-alignment tests: the
CPU parity tests against JAX (test_torch_gn_kernels.py) and the card tests
of the kernels against their plain versions (test_torch_cuda.py). No JAX
here: the card tests import this without it.

Each case is made with numpy from a seed: stereo rows, one row, a ragged
1,500 rows, points behind the camera, the PnP polish's gate, 512 mono rows
(the frame step's shape), 333 rows (not a multiple of a kernel's block),
every row behind the camera (H = 0: a singular system), no valid row; two
752x480 views of a textured plane with points inside, on the level
borders, 333 of them, or none valid.
"""
import numpy as np

from ygz_tpu_torch.backend.optim import CHI2_MONO
from ygz_tpu_torch.geometry.lie import so3_exp
from ygz_tpu_torch.utils.synthetic import PlaneScene

from torch_parity import np_, render_u8, t_

INTR = (458.0, 458.0, 375.5, 239.5)
BF = 47.906          # the EuRoC stereo rig's bf
W0, H0 = 752, 480


def so3(w):
    return np_(so3_exp(t_(np.asarray(w, np.float32))))


R_TRUE = so3([0.03, -0.04, 0.01])


def pose_problem(seed, n, stereo=False, behind=0, no_valid=False,
                 unit_weights=False):
    """Points in front of a camera at (R_true, t_true), pixels with 0.5-px
    noise and 1/8 gross outliers, a start pose off by ~3 deg and 7 cm."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(3, 10, n)], 1).astype(np.float32)
    t_true = np.array([0.1, -0.05, 0.2], np.float32)
    Xc = X @ R_TRUE.T + t_true
    uv = np.stack([INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2],
                   INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]], 1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    n_out = n // 8
    uv[:n_out] += rng.uniform(20, 60, (n_out, 2)).astype(np.float32)
    if behind:
        X[n - behind:] = -X[n - behind:]            # z < 0 in the camera
    if unit_weights:
        is2 = np.ones(n, np.float32)
    else:
        is2 = (0.25 ** rng.integers(0, 4, n)).astype(np.float32)
    valid = np.zeros(n, bool) if no_valid else rng.random(n) > 0.05
    ur = None
    if stereo:
        ur = (uv[:, 0] - BF / Xc[:, 2]
              + rng.normal(0, 0.3, n)).astype(np.float32)
        ur[rng.random(n) < 0.4] = -1.0               # mono rows among them
    R0 = so3([0.07, -0.02, 0.04])
    t0 = (t_true + np.array([0.05, -0.03, 0.04])).astype(np.float32)
    return dict(X=X, uv=uv, is2=is2, valid=valid, R0=R0, t0=t0, ur=ur,
                n_out=n_out)


POSE_CASES = {
    "stereo": (dict(seed=0, n=512, stereo=True), {}),
    "one_row": (dict(seed=1, n=1), {}),
    "ragged_1500": (dict(seed=2, n=1500), {}),
    "behind_camera": (dict(seed=3, n=512, behind=40), {}),
    # backend/pnp.py's polish: unit weights, the chi2 gate passed by name
    "pnp_polish": (dict(seed=4, n=300, unit_weights=True),
                   dict(chi2_th=CHI2_MONO)),
    "stereo_gate_9.21": (dict(seed=5, n=256, stereo=True),
                         dict(chi2_th=9.21)),
    "mono_512": (dict(seed=12, n=512), {}),
    "ragged_333": (dict(seed=13, n=333), {}),
    # every weight 0 (z < 0): H = 0, a singular system
    "all_behind_singular": (dict(seed=14, n=64, behind=64), {}),
}


def singular(spec):
    """Whether a pose case's normal equations are 0 (every row behind the
    camera): both versions then give non-finite steps and no inlier."""
    return spec.get("behind", 0) >= spec["n"]


# pose_problem's keywords of the no-valid-row case
NO_VALID = dict(seed=6, n=128, no_valid=True)


def plane_frames():
    """Two 752x480 views of a textured plane 5 cm and ~1.3 deg apart."""
    scene = PlaneScene(seed=7, w=W0, h=H0, f=INTR[0], tex_size=2000)
    R1 = so3([0.01, -0.02, 0.005])
    t1 = np.array([0.05, 0.02, 0.01], np.float32)
    return (scene, render_u8(scene, np.eye(3), np.zeros(3)),
            render_u8(scene, R1, t1), t1)


def border_points(rng, n):
    """Level-0 pixels whose level-1 and level-2 positions lie within a
    pixel of the 3-px border lines (left and bottom), two at the image's
    corners, the rest inside."""
    uv = rng.uniform(30, [W0 - 30, H0 - 30], (n, 2))
    q = n // 8
    for j, s in enumerate((0.5, 0.25)):
        # the level-l position of u is (u + 0.5) s - 0.5
        left = (3.0 + 0.5) / s - 0.5
        bottom = (H0 * s - 4.0 + 0.5) / s - 0.5
        a = 2 * j * q
        uv[a: a + q, 0] = left + rng.uniform(-1, 1, q) / s
        uv[a + q: a + 2 * q, 1] = bottom + rng.uniform(-1, 1, q) / s
    uv[-2:] = [[0.0, 0.0], [W0 - 1.0, H0 - 1.0]]
    return uv.astype(np.float32)


ALIGN_CASES = {
    "levels_2_1_iters_3": dict(seed=8, border=False),
    "level_borders": dict(seed=9, border=True),
    "ragged_333": dict(seed=15, border=False, n=333),
}


def align_points(seed, border, n=512):
    """(uv0 [n, 2] level-0 pixels, valid [n]) of an alignment case."""
    rng = np.random.default_rng(seed)
    uv0 = (border_points(rng, n) if border else
           rng.uniform(40, [W0 - 40, H0 - 40], (n, 2)).astype(np.float32))
    return uv0, rng.random(n) > 0.1
