"""IMU preintegration (Forster-style), batched over windows.

Port of ``ygz_tpu/imu/preintegration.py``. The JAX package runs one
``lax.scan`` over a padded window; here the samples are a Python loop of
eager steps, each of which advances a whole batch of windows (``[..., N]``
sample arrays: one frame's window, or every keyframe link of a chain at
once). The loop stops after the last sample that is valid in any window:
masked samples leave the state untouched, so the stop is exact.

Increments dP/dV/dR, the five bias Jacobians and the 9x9 [P, V, Phi]
covariance propagate together, in the reference's order
(IMUPreintegrator.cpp:62-121). Noise defaults follow the reference's
EuRoC-calibrated values with its empirical inflation (imudata.cpp:19-29).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry.lie import hat, so3_exp, so3_right_jacobian

# reference noise model (imudata.cpp:19-29), inflation included
GYR_MEAS_COV = 1.7e-4 ** 2 / 0.005 * 100.0     # ~5.78e-4 rad^2/s^2 per axis
ACC_MEAS_COV = 2.0e-3 ** 2 / 0.005 * 100.0     # ~0.08 (m/s^2)^2 per axis
GYR_BIAS_RW2 = (2.0e-5) ** 2 * 10.0            # 4e-9
ACC_BIAS_RW2 = (5.0e-3) ** 2 * 10.0            # 2.5e-4


class PreintState(NamedTuple):
    """Every field carries the batch's leading dims."""
    dP: torch.Tensor       # [..., 3]
    dV: torch.Tensor       # [..., 3]
    dR: torch.Tensor       # [..., 3, 3]
    J_P_bg: torch.Tensor   # [..., 3, 3]
    J_P_ba: torch.Tensor
    J_V_bg: torch.Tensor
    J_V_ba: torch.Tensor
    J_R_bg: torch.Tensor
    cov: torch.Tensor      # [..., 9, 9] order (P, V, Phi)
    dt: torch.Tensor       # [...] total time

    @staticmethod
    def zero(batch=(), dtype=torch.float32, device="cpu"):
        batch = tuple(batch)

        def z(*shape):
            return torch.zeros(batch + shape, dtype=dtype, device=device)

        eye = torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3))
        return PreintState(dP=z(3), dV=z(3), dR=eye.clone(),
                           J_P_bg=z(3, 3), J_P_ba=z(3, 3), J_V_bg=z(3, 3),
                           J_V_ba=z(3, 3), J_R_bg=z(3, 3), cov=z(9, 9),
                           dt=z())

    def take(self, i):
        """The windows at index (or slice) i of the leading batch dim."""
        return PreintState(*(f[i] for f in self))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _step(state: PreintState, w, a, dt, valid):
    """One sample of every window in the batch; the Jacobians and the
    covariance use the OLD increments, then dP/dV/dR update."""
    dt1 = dt[..., None]
    dt_ = dt[..., None, None]
    dt2 = dt_ * dt_
    dR_old = state.dR
    phi = w * dt1
    dR_inc = so3_exp(phi)
    Jr = so3_right_jacobian(phi)
    Ra_hat = dR_old @ hat(a)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(dR_old)
    zero = torch.zeros_like(dR_old)

    # covariance propagation, order (P, V, Phi)
    A = torch.cat([
        torch.cat([eye, eye * dt_, -0.5 * Ra_hat * dt2], -1),
        torch.cat([zero, eye, -Ra_hat * dt_], -1),
        torch.cat([zero, zero, dR_inc.transpose(-1, -2)], -1)], -2)
    Bg = torch.cat([zero, zero, Jr * dt_], -2)
    Ba = torch.cat([0.5 * dR_old * dt2, dR_old * dt_, zero], -2)
    cov = (A @ state.cov @ A.transpose(-1, -2)
           + GYR_MEAS_COV * (Bg @ Bg.transpose(-1, -2))
           + ACC_MEAS_COV * (Ba @ Ba.transpose(-1, -2)))

    # bias Jacobians (old quantities on the right-hand side)
    J_P_ba = state.J_P_ba + state.J_V_ba * dt_ - 0.5 * dR_old * dt2
    J_P_bg = (state.J_P_bg + state.J_V_bg * dt_
              - 0.5 * Ra_hat @ state.J_R_bg * dt2)
    J_V_ba = state.J_V_ba - dR_old * dt_
    J_V_bg = state.J_V_bg - Ra_hat @ state.J_R_bg * dt_
    J_R_bg = dR_inc.transpose(-1, -2) @ state.J_R_bg - Jr * dt_

    Ra = _mv(dR_old, a)
    new = PreintState(dP=state.dP + state.dV * dt1 + 0.5 * Ra * dt1 * dt1,
                      dV=state.dV + Ra * dt1, dR=dR_old @ dR_inc,
                      J_P_bg=J_P_bg, J_P_ba=J_P_ba, J_V_bg=J_V_bg,
                      J_V_ba=J_V_ba, J_R_bg=J_R_bg, cov=cov,
                      dt=state.dt + dt)
    # masked samples (padding) leave the state untouched
    return PreintState(*(
        torch.where(valid.reshape(valid.shape + (1,) * (n.dim() - valid.dim())),
                    n, o)
        for n, o in zip(new, state)))


def preintegrate(omega, acc, dts, valid, bg, ba,
                 n_steps: Optional[int] = None) -> PreintState:
    """Preintegrate a batch of padded IMU sample windows.

    omega, acc: [..., N, 3] raw gyro (rad/s) / accelerometer (m/s^2)
    samples; dts: [..., N] per-sample intervals; valid: [..., N] bool padding
    mask; bg, ba: biases subtracted from the raw measurements, [3] or
    [..., 3]. n_steps: how many leading samples hold any valid one (the
    caller's count spares a readback; None reads it from `valid`).
    Returns a PreintState with the windows' leading dims.
    """
    w = omega - bg[..., None, :]
    a = acc - ba[..., None, :]
    if n_steps is None:
        hit = valid.reshape(-1, valid.shape[-1]).any(0).nonzero()
        n_steps = int(hit[-1]) + 1 if len(hit) else 0
    state = PreintState.zero(w.shape[:-2], omega.dtype, omega.device)
    for i in range(min(n_steps, valid.shape[-1])):
        state = _step(state, w[..., i, :], a[..., i, :], dts[..., i],
                      valid[..., i])
    return state


def predict_navstate(ns, preint: PreintState, gravity_w):
    """Propagate a NavState through a preintegrated interval with
    first-order bias correction (the reference's Converter::updateNS and
    the correction terms of its g2o residuals)."""
    from .navstate import NavState

    dt = preint.dt[..., None]
    dbg, dba = ns.dbg, ns.dba
    dP = preint.dP + _mv(preint.J_P_bg, dbg) + _mv(preint.J_P_ba, dba)
    dV = preint.dV + _mv(preint.J_V_bg, dbg) + _mv(preint.J_V_ba, dba)
    dR = preint.dR @ so3_exp(_mv(preint.J_R_bg, dbg))
    P = ns.P + ns.V * dt + 0.5 * gravity_w * dt * dt + _mv(ns.R, dP)
    V = ns.V + gravity_w * dt + _mv(ns.R, dV)
    return NavState(P=P, V=V, R=ns.R @ dR, bg=ns.bg, ba=ns.ba, dbg=dbg,
                    dba=dba)
