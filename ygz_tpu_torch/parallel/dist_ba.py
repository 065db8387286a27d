"""Distributed bundle adjustment over the shards of a landmark mesh.

Port of ``ygz_tpu/parallel/dist_ba.py``, with its design (landmark-block
sharding and a matrix-free distributed PCG):

  * landmarks are block-sharded: shard d owns points [d·Lb, (d+1)·Lb);
  * observations are partitioned by the owner of their landmark
    (``partition_obs_by_landmark``), so every per-landmark block (V_l, b_l
    and the coupling M_l) is computed on its shard with no communication.
    M is never materialized: every product with it streams over the
    observation axis as per-edge [6, 3] blocks (no [Lb, P, 6, 3] tensor);
  * the reduced camera system S = U + λI − Σ_l M_l V_l⁻¹ M_lᵀ is never
    formed (no dense [P, 6, P, 6]): block-Jacobi-preconditioned CG whose
    matvec sums ONE [P, 6] vector over the shards per CG iteration; the
    preconditioner's [P, 6, 6] diagonal blocks are summed once per GN step;
  * landmark back-substitution is local to each shard.

The JAX step is one SPMD program under ``shard_map``; its collectives are
psums. Here a ``Mesh`` holds this process's shards (an ordered list of
devices; a device may repeat) and an optional ``torch.distributed`` process
group joining the processes of a job. The step keeps one set of tensors per
shard for the per-landmark state, and computes the replicated pose-side
state (the CG vectors, the LM decision) once per process on the mesh's
first device: every shard of the JAX program computes the same values.
``Mesh.psum`` adds the shards' partial sums in global shard order, the same
order in every process, so every process holds the same bits and takes the
same accept/reject decision, and a run repeats bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..backend.optim import (CHI2_MONO, CHI2_STEREO, _huber_weight,
                             _reproj_residual_jac3, segment_sum)
from ..geometry.lie import se3_exp, se3_mul


class Mesh:
    """The shards of the distributed BA's landmark axis.

    devices: this process's shard devices in order ("cpu" or "cuda:k"; a
    device may repeat, e.g. two shards on one card). group: the
    ``torch.distributed`` process group joining the job's processes, each
    with the same number of shards (None: one process). Process r holds the
    global shards [r·n, (r+1)·n) of n = len(devices)."""

    def __init__(self, devices, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.rank, self.n_proc = 0, 1
        if group is not None:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.n_proc = dist.get_world_size(group)

    @property
    def size(self) -> int:
        """The global shard count (the JAX mesh's ``devices.size``)."""
        return len(self.devices) * self.n_proc

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * len(self.devices)

    def shards(self, parts):
        """Every shard's tensor of the job in global shard order, on
        devices[0], from this process's `parts` (one per local shard, same
        shape). With a group the processes exchange them through one
        all_reduce of zero-padded slots: each slot adds only zeros to its
        owner's values, so every process receives every shard's exact
        bits."""
        home = self.devices[0]
        parts = [p.to(home) for p in parts]
        if self.group is None:
            return parts
        import torch.distributed as dist
        slots = torch.zeros((self.size,) + tuple(parts[0].shape),
                            dtype=parts[0].dtype, device=home)
        slots[self.first_shard: self.first_shard + len(parts)] = \
            torch.stack(parts)
        dist.all_reduce(slots, group=self.group)
        return list(slots.unbind(0))

    def psum(self, parts):
        """The sum over every shard of the job, added in global shard order
        (the same bits in every process and in every run)."""
        parts = self.shards(parts)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


class DistBAResult(NamedTuple):
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    points: torch.Tensor
    total_chi2: torch.Tensor


def partition_obs_by_landmark(obs_p, obs_l, obs_uv, obs_w, n_points: int,
                              n_dev: int, pad_to: int = None, obs_ur=None):
    """Partition the observation table by landmark owner (block sharding of
    the L axis over n_dev shards). Returns (obs_p, obs_l, obs_uv, obs_ur,
    obs_w) concatenated in shard order with every shard padded to the same
    length (padding rows carry w=0, pose 0 and the shard's first landmark),
    plus the per-shard length. obs_l stays GLOBAL; the step localizes it
    with each shard's block offset. obs_ur: optional [O] right-image u for
    stereo/RGB-D 3-row edges (-1 = monocular; default all-mono)."""
    obs_p = np.asarray(obs_p)
    obs_l = np.asarray(obs_l)
    obs_uv = np.asarray(obs_uv)
    obs_w = np.asarray(obs_w)
    if obs_ur is None:
        obs_ur = np.full(len(obs_p), -1.0, np.float32)
    obs_ur = np.asarray(obs_ur, np.float32)
    Lb = n_points // n_dev
    owner = np.clip(obs_l // max(Lb, 1), 0, n_dev - 1)
    shards = [np.nonzero(owner == d)[0] for d in range(n_dev)]
    O_shard = max(max((len(s) for s in shards), default=1), 1)
    if pad_to is not None:
        O_shard = max(O_shard, pad_to)
    op = np.zeros(n_dev * O_shard, np.int32)
    ol = np.zeros(n_dev * O_shard, np.int32)
    ouv = np.zeros((n_dev * O_shard, 2), np.float32)
    our = np.full(n_dev * O_shard, -1.0, np.float32)
    ow = np.zeros(n_dev * O_shard, np.float32)
    for d, s in enumerate(shards):
        sl = slice(d * O_shard, d * O_shard + len(s))
        op[sl] = obs_p[s]
        ol[sl] = obs_l[s]
        ouv[sl] = obs_uv[s]
        our[sl] = obs_ur[s]
        ow[sl] = obs_w[s]
        # padding rows must index a LOCAL landmark of this shard
        op[d * O_shard + len(s): (d + 1) * O_shard] = 0
        ol[d * O_shard + len(s): (d + 1) * O_shard] = d * Lb
    return op, ol, ouv, our, ow, O_shard


class _Shard:
    """One shard's observation rows (landmark indices made local), its
    landmark block and the per-landmark state of the current GN step."""

    def __init__(self, dev, g, O_shard, Lb, obs, points, pt_valid):
        o = slice(g * O_shard, (g + 1) * O_shard)
        rows = slice(g * Lb, (g + 1) * Lb)

        def take(a, dtype):
            return torch.as_tensor(a[o]).to(dev, dtype)

        obs_p, obs_l, obs_uv, obs_ur, obs_w = obs
        self.dev = dev
        self.obs_p = take(obs_p, torch.long)
        self.obs_l = take(obs_l, torch.long) - g * Lb
        self.uv = take(obs_uv, torch.float32)
        self.ur = take(obs_ur, torch.float32)
        self.w = take(obs_w, torch.float32)
        # per-edge chi2 gate: stereo 3-row edges use the 3-DoF threshold
        self.delta2 = torch.where(self.ur >= 0,
                                  torch.full_like(self.ur, CHI2_STEREO),
                                  torch.full_like(self.ur, CHI2_MONO))
        self.inlier = (self.w > 0.0).to(torch.float32)
        self.pts = torch.as_tensor(points[rows]).to(dev, torch.float32)
        self.valid = torch.as_tensor(pt_valid[rows]).to(dev, torch.float32)


def make_distributed_ba(mesh: Mesh, n_poses: int, n_points: int,
                        iters: int = 10, damping: float = 1e-3,
                        cg_iters: int = 48, phases=None):
    """Build the distributed-BA step over `mesh`.

    Call-time inputs (numpy arrays or tensors on any device), each the
    whole job's: kf_R [P, 3, 3], kf_t [P, 3], free [P] (replicated);
    points [L, 3] and pt_valid [L] (L divisible by the mesh size, block
    d on shard d); the observation arrays partitioned with
    `partition_obs_by_landmark` (global landmark indices), obs_ur [O]
    right-image u (-1 = mono) making stereo/RGB-D 3-row edges first-class;
    intr (fx, fy, cx, cy); bf = stereo baseline * fx (0 for mono). Every
    process of a multi-process mesh passes the same arrays and computes its
    own shards. Returns a DistBAResult on the mesh's first device, the same
    in every process (points: all L rows).

    cg_iters: inner PCG iterations for the reduced camera solve per GN step
    (block-Jacobi preconditioned; LM accept/reject guards inexact steps).

    phases: GN iteration counts between chi2-outlier drops (the reference
    LocalBundleAdjustment: 5 iterations -> drop chi2 > 5.991/7.815 or
    negative depth -> 10 iterations). Default splits `iters` as
    (min(5, ceil(iters/3)), rest).
    """
    n_dev = mesh.size
    Pn = n_poses
    Lb = n_points // n_dev
    if Lb * n_dev != n_points:
        raise ValueError(f"n_points={n_points} must divide by the mesh size "
                         f"{n_dev}")
    if phases is None:
        first = min(5, max(1, (iters + 2) // 3))
        phases = (first, iters - first) if iters > first else (iters,)
    home = mesh.devices[0]
    f32 = torch.float32
    eye3 = torch.eye(3, dtype=f32, device=home)
    eye6 = torch.eye(6, dtype=f32, device=home)

    def mv(M, x):
        return (M @ x[..., None])[..., 0]

    def step(kf_R, kf_t, free, points, pt_valid, obs_p, obs_l, obs_uv,
             obs_ur, obs_w, intr, bf):
        fx, fy, cx, cy = (float(v) for v in intr)
        bf = float(bf)
        O_shard = len(obs_p) // n_dev
        obs = (obs_p, obs_l, obs_uv, obs_ur, obs_w)
        sh = [_Shard(dev, mesh.first_shard + j, O_shard, Lb, obs, points,
                     pt_valid) for j, dev in enumerate(mesh.devices)]
        kf_R = torch.as_tensor(kf_R).to(home, f32)
        kf_t = torch.as_tensor(kf_t).to(home, f32)
        fm = torch.as_tensor(free).to(home, f32)[:, None]

        def rj(s, R, t, pts):
            R, t = R.to(s.dev), t.to(s.dev)
            return _reproj_residual_jac3(R[s.obs_p], t[s.obs_p],
                                         pts[s.obs_l], s.uv, s.ur, bf,
                                         fx, fy, cx, cy)

        def chi2_of(R, t, pts_list):
            # acceptance metric: NO depth masking (a point pushed behind a
            # camera keeps its clamped-depth residual, so the LM gate
            # cannot be gamed by collapsing the map to negative depths)
            parts = []
            for s, pts in zip(sh, pts_list):
                r = rj(s, R, t, pts)[0]
                parts.append(((r * r).sum(1) * s.w * s.inlier).sum())
            return mesh.psum(parts)

        def matvec(x, Ul):
            """S @ x matrix-free: the shards' observation-streamed
            landmark sums and ONE [P, 6] psum."""
            parts = []
            for s in sh:
                xs = x.to(s.dev)
                y = segment_sum(mv(s.AwBT, xs[s.obs_p]), s.obs_l, Lb)
                z = mv(s.Vinv, y)
                parts.append(segment_sum(mv(s.AwB, z[s.obs_l]), s.obs_p,
                                         Pn))
            out = mv(Ul, x) - mesh.psum(parts)
            return out * fm + x * (1.0 - fm)   # identity on fixed poses

        def gn_step(kf_R, kf_t, lam):
            first = []
            for s in sh:
                r, A, B, z = rj(s, kf_R, kf_t, s.pts)
                c2 = (r * r).sum(1) * s.w
                w = s.w * s.inlier * (z > 0.0) * _huber_weight(c2, s.delta2)
                Aw = A * w[:, None, None]
                Bw = B * w[:, None, None]
                AwT, BwT = Aw.transpose(1, 2), Bw.transpose(1, 2)
                lam_s = lam.to(s.dev)
                V = segment_sum(BwT @ B, s.obs_l, Lb) + lam_s * eye3.to(
                    s.dev)[None]
                s.bl = -segment_sum(mv(BwT, r), s.obs_l, Lb)
                s.Vinv = torch.linalg.inv_ex(V).inverse
                s.AwB = AwT @ B                               # [O, 6, 3]
                s.AwBT = s.AwB.transpose(1, 2)
                # chi2, U and b_p in one sum over the shards
                first.append(torch.cat([
                    (c2 * s.inlier).sum()[None],
                    segment_sum(AwT @ A, s.obs_p, Pn).reshape(-1),
                    segment_sum(mv(AwT, r), s.obs_p, Pn).reshape(-1)]))
            tot = mesh.psum(first)
            chi_old = tot[0]
            U = tot[1: 1 + 36 * Pn].reshape(Pn, 6, 6)
            bp = -tot[1 + 36 * Pn:].reshape(Pn, 6)
            # the Schur RHS correction Σ_l M V⁻¹ b_l and the preconditioner's
            # diagonal blocks Σ_l M_l V_l⁻¹ M_lᵀ, one sum over the shards
            second = []
            for s in sh:
                u = mv(s.Vinv, s.bl)                              # [Lb, 3]
                t_n = s.AwB @ s.Vinv[s.obs_l]                     # [O, 6, 3]
                second.append(torch.cat([
                    segment_sum(mv(s.AwB, u[s.obs_l]), s.obs_p,
                                Pn).reshape(-1),
                    segment_sum(t_n @ s.AwBT, s.obs_p, Pn).reshape(-1)]))
            tot = mesh.psum(second)
            g = (bp - tot[: 6 * Pn].reshape(Pn, 6)) * fm
            Ul = U + lam * eye6[None]
            # block-Jacobi preconditioner: S's [6, 6] diagonal blocks (exact
            # when each (pose, landmark) pair carries one observation)
            D = Ul - tot[6 * Pn:].reshape(Pn, 6, 6)
            D = D * fm[:, :, None] + (1.0 - fm)[:, :, None] * eye6[None]
            Dinv = torch.linalg.inv_ex(D).inverse

            # preconditioned CG on the reduced camera system
            x = torch.zeros((Pn, 6), dtype=f32, device=home)
            r = g
            z = mv(Dinv, r) * fm
            p = z
            for _ in range(cg_iters):
                Ap = matvec(p, Ul)
                rz = (r * z).sum()
                alpha = rz / torch.clamp((p * Ap).sum(), min=1e-20)
                x = x + alpha * p
                r = r - alpha * Ap
                z2 = mv(Dinv, r) * fm
                beta = (r * z2).sum() / torch.clamp(rz, min=1e-20)
                z, p = z2, z2 + beta * p
            dp = x * fm
            new_pts = []
            for s in sh:
                dps = dp.to(s.dev)
                rhs = s.bl - segment_sum(mv(s.AwBT, dps[s.obs_p]), s.obs_l,
                                         Lb)
                new_pts.append(s.pts + mv(s.Vinv, rhs) * s.valid[:, None])
            newR, newt = se3_mul(*se3_exp(dp), kf_R, kf_t)
            chi_new = chi2_of(newR, newt, new_pts)
            # the decision is the reduced chi2's: the same in every process
            accept = chi_new < chi_old
            kf_R = torch.where(accept, newR, kf_R)
            kf_t = torch.where(accept, newt, kf_t)
            for s, new in zip(sh, new_pts):
                s.pts = torch.where(accept.to(s.dev), new, s.pts)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-6, 1e3)
            # the ACCEPTED state's chi2
            return kf_R, kf_t, lam, torch.where(accept, chi_new, chi_old)

        lam = torch.tensor(damping, dtype=f32, device=home)
        chi = None
        for n_it in phases:
            for _ in range(n_it):
                kf_R, kf_t, lam, chi = gn_step(kf_R, kf_t, lam)
            # chi2-outlier drop between phases: local to each shard
            for s in sh:
                r, _, _, z = rj(s, kf_R, kf_t, s.pts)
                c2 = (r * r).sum(1) * s.w
                s.inlier = s.inlier * (c2 < s.delta2) * (z > 0.0)
        return DistBAResult(kf_R=kf_R, kf_t=kf_t,
                            points=torch.cat(mesh.shards(
                                [s.pts for s in sh])),
                            total_chi2=chi)

    return step
