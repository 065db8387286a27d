"""IMU preintegration and NavState prediction of the torch port against the
JAX package on the same seeded windows: a 100-sample window, a padded
64-cap window, non-zero biases, and a batch of chain links preintegrated at
once (the window BA's and VINS init's use)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_tpu.geometry import lie as jlie
from ygz_tpu.imu import preintegration as jpre
from ygz_tpu.imu.navstate import NavState as JNavState
from ygz_tpu_torch import interop
from ygz_tpu_torch.geometry import lie
from ygz_tpu_torch.imu import navstate, preintegration as tpre

import torch_parity as tp

FIELDS = tpre.PreintState._fields
# float32 recursions with another sin/cos: every entry of a field within
# atol 1e-6 + rtol 1e-4 of the field's largest |entry| of the JAX package's
# (the rtol is taken on the field's scale: (1 - cos x) / x^2 of a 2.5e-3
# rad step loses ~2% to float32 cancellation in both packages, differently,
# so entries that cancel to ~1e-3 inside a 0.5-sized Jacobian differ by
# ~1e-6 while the field agrees to ~3e-6 of its scale)
RTOL, ATOL = 1e-4, 1e-6


def _window(rng, n, cap):
    """n valid samples of a smooth random motion, padded to cap."""
    t = np.arange(n) * 0.005
    om = np.zeros((cap, 3), np.float32)
    ac = np.zeros((cap, 3), np.float32)
    dts = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    a, f, p = rng.uniform(0.1, 0.6, (3, 3))
    om[:n] = (a * np.sin(f * t[:, None] * 6 + p)).astype(np.float32)
    ac[:n] = (rng.normal(0, 0.5, 3) + np.array([0, 0, 9.81])
              + 0.3 * np.cos(f * t[:, None] * 4)).astype(np.float32)
    dts[:n] = rng.uniform(0.004, 0.006, n).astype(np.float32)
    valid[:n] = True
    return om, ac, dts, valid


def _jax_preint(win, bg, ba):
    return jpre.preintegrate(*(jnp.asarray(a) for a in win),
                             jnp.asarray(bg), jnp.asarray(ba))


def _assert_preint(got, want, what):
    for f in FIELDS:
        w = tp.np_(getattr(want, f))
        tp.assert_close(getattr(got, f), w,
                        atol=ATOL + RTOL * float(np.abs(w).max()),
                        what=f"{what}: {f}")


@pytest.mark.parametrize("n,cap", [(100, 100), (41, 64), (64, 64)])
def test_preintegrate_matches_jax(n, cap):
    rng = np.random.default_rng(n)
    win = _window(rng, n, cap)
    bg = rng.normal(0, 0.02, 3).astype(np.float32)
    ba = rng.normal(0, 0.1, 3).astype(np.float32)
    got = tpre.preintegrate(*(tp.t_(a) for a in win), tp.t_(bg), tp.t_(ba))
    _assert_preint(got, _jax_preint(win, bg, ba), f"{n}/{cap}")


def test_preintegrate_batched_links_match_jax():
    """Links of different lengths in one [links, cap] batch, each held to
    its own JAX preintegration; the loop stops after the longest."""
    rng = np.random.default_rng(3)
    lens = [100, 37, 64, 1]
    wins = [_window(rng, n, 128) for n in lens]
    bg = rng.normal(0, 0.02, 3).astype(np.float32)
    ba = rng.normal(0, 0.1, 3).astype(np.float32)
    stacked = [tp.t_(np.stack(a)) for a in zip(*wins)]
    got = tpre.preintegrate(*stacked, tp.t_(bg), tp.t_(ba))
    assert got.dP.shape == (4, 3) and got.cov.shape == (4, 9, 9)
    # the caller's count gives the same state without the readback
    same = tpre.preintegrate(*stacked, tp.t_(bg), tp.t_(ba), n_steps=100)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(same, f)), f
    for i, win in enumerate(wins):
        _assert_preint(got.take(i), _jax_preint(win, bg, ba), f"link {i}")
    # per-link biases broadcast like the single ones
    per = tpre.preintegrate(*stacked, tp.t_(np.tile(bg, (4, 1))),
                            tp.t_(np.tile(ba, (4, 1))))
    tp.assert_close(per.dP, got.dP, atol=0.0)


def test_predict_navstate_and_right_jacobian_match_jax():
    rng = np.random.default_rng(11)
    win = _window(rng, 80, 96)
    z3 = np.zeros(3, np.float32)
    jp = _jax_preint(win, z3, z3)
    pre = interop.preint_from_numpy(jp, device="cpu")
    R0 = np.asarray(jlie.so3_exp(jnp.asarray(
        rng.normal(0, 0.3, 3).astype(np.float32))))
    vals = dict(P=rng.normal(0, 1, 3), V=rng.normal(0, 0.5, 3), R=R0,
                bg=rng.normal(0, 0.01, 3), ba=rng.normal(0, 0.05, 3),
                dbg=rng.normal(0, 0.003, 3), dba=rng.normal(0, 0.02, 3))
    vals = {k: np.asarray(v, np.float32) for k, v in vals.items()}
    jns = JNavState(**{k: jnp.asarray(v) for k, v in vals.items()})
    gw = np.array([0.0, -9.81, 0.0], np.float32)
    want = jpre.predict_navstate(jns, jp, jnp.asarray(gw))
    got = tpre.predict_navstate(interop.navstate_from_numpy(jns, "cpu"), pre,
                                tp.t_(gw))
    for f in navstate.NavState._fields:
        tp.assert_close(getattr(got, f), getattr(want, f), atol=1e-5,
                        rtol=1e-5, what=f)
    # back across: the port's state rebuilds the JAX NavState
    back = JNavState(*interop.to_numpy(got))
    tp.assert_close(back.P, want.P, atol=1e-5, rtol=1e-5)

    w = rng.normal(0, 0.4, (16, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-5
    got = lie.so3_right_jacobian(tp.t_(w))
    for i in range(len(w)):
        tp.assert_close(got[i], jlie.so3_right_jacobian(jnp.asarray(w[i])),
                        atol=1e-6, what=f"J_r at {w[i]}")


def test_navstate_increments():
    rng = np.random.default_rng(2)
    ns = navstate.NavState.identity()
    d = tp.t_(rng.normal(0, 0.1, 15).astype(np.float32))
    out = navstate.inc_small(ns, d)
    tp.assert_close(out.P, d[:3], atol=0.0)
    tp.assert_close(out.V, d[3:6], atol=0.0)
    tp.assert_close(out.R, lie.so3_exp(d[6:9]), atol=0.0)
    tp.assert_close(out.bg_total, d[9:12], atol=0.0)
    tp.assert_close(out.ba_total, d[12:15], atol=0.0)
