"""15-DoF navigation state {P, V, R, b_g, b_a (+ delta-biases)}.

Port of ``ygz_tpu/imu/navstate.py``: a NamedTuple of tensors with the
manifold increments of the reference's NavState (IncSmall, IncSmallPVR,
IncSmallBias). Bias is kept as a linearization point plus a delta so the
preintegration's bias Jacobians stay valid between relinearizations.
Increments take any leading batch (``[..., 9]``, ``[..., 6]``, ``[..., 15]``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.lie import so3_exp


class NavState(NamedTuple):
    P: torch.Tensor    # [3] position (world)
    V: torch.Tensor    # [3] velocity (world)
    R: torch.Tensor    # [3, 3] body->world rotation
    bg: torch.Tensor   # [3] gyro bias (linearization point)
    ba: torch.Tensor   # [3] acc bias (linearization point)
    dbg: torch.Tensor  # [3] gyro bias delta
    dba: torch.Tensor  # [3] acc bias delta

    @staticmethod
    def identity(device="cpu"):
        z = torch.zeros(3, dtype=torch.float32, device=device)
        return NavState(P=z, V=z, R=torch.eye(3, device=device), bg=z, ba=z,
                        dbg=z, dba=z)

    @property
    def bg_total(self):
        return self.bg + self.dbg

    @property
    def ba_total(self):
        return self.ba + self.dba


def inc_small_pvr(ns: NavState, d9):
    """Manifold increment of [dP, dV, dPhi] (NavState::IncSmallPVR).
    Rotation is RIGHT-multiplied: R <- R exp(dPhi)."""
    return ns._replace(P=ns.P + d9[..., 0:3], V=ns.V + d9[..., 3:6],
                       R=ns.R @ so3_exp(d9[..., 6:9]))


def inc_small_bias(ns: NavState, d6):
    """Increment of [d(dbg), d(dba)] (NavState::IncSmallBias)."""
    return ns._replace(dbg=ns.dbg + d6[..., 0:3], dba=ns.dba + d6[..., 3:6])


def inc_small(ns: NavState, d15):
    return inc_small_bias(inc_small_pvr(ns, d15[..., 0:9]), d15[..., 9:15])
