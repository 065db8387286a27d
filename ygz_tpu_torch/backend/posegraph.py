"""Sim3 pose-graph ("essential graph") optimization, batched Gauss-Newton.

Port of ``ygz_tpu/backend/posegraph.py`` (the reference's
Optimizer::OptimizeEssentialGraph). Per-edge 7-DoF residuals and their
Jacobians come from autodiff (one reverse-mode pass over all edges, where
the JAX package vmaps ``jax.jacfwd``). The normal equations are either
scattered into a dense [7K x 7K] system and solved with Jacobi
preconditioning (``optimize_pose_graph``), or solved matrix-free by
block-Jacobi PCG for large graphs (``optimize_pose_graph_cg``). Iteration counts are fixed (no data-dependent
exit, so no host sync inside the loop).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.sim3 import sim3_exp, sim3_inv, sim3_log, sim3_mul
from .optim import segment_sum, solve_preconditioned


class PoseGraphResult(NamedTuple):
    R: torch.Tensor   # [K,3,3]
    t: torch.Tensor   # [K,3]
    s: torch.Tensor   # [K]
    total_chi2: torch.Tensor


def _edge_residual(dzi, dzj, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log( S_meas_ji^-1 * (exp(dzj) S_j) * (exp(dzi) S_i)^-1 )."""
    Rdi, tdi, sdi = sim3_exp(dzi)
    Rdj, tdj, sdj = sim3_exp(dzj)
    RiN, tiN, siN = sim3_mul(Rdi, tdi, sdi, Ri, ti, si)
    RjN, tjN, sjN = sim3_mul(Rdj, tdj, sdj, Rj, tj, sj)
    Rii, tii, sii = sim3_inv(RiN, tiN, siN)
    Rji, tji, sji = sim3_mul(RjN, tjN, sjN, Rii, tii, sii)
    Rmi, tmi, smi = sim3_inv(Rm, tm, sm)
    Re, te, se = sim3_mul(Rmi, tmi, smi, Rji, tji, sji)
    return sim3_log(Re, te, se)


def _res_and_jac(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """Per-edge residual r [E, 7] and Jacobians Ji, Jj [E, 7, 7] at 0.

    Reverse mode, one backward pass: the edges are repeated over a leading
    axis of the 7 residual components, and component k of copy k is summed,
    so the gradient of copy k is row k of each edge's Jacobian; every copy
    holds the residual. (Forward mode, the JAX package's ``jacfwd``, costs
    7-9 s once per process on CUDA at its first op, and a per-edge
    ``vmap`` issues many more small kernels.)"""
    E = Ri.shape[0]
    rows = [a.expand((7,) + a.shape)
            for a in (Ri, ti, si, Rj, tj, sj, Rm, tm, sm)]
    eye = torch.eye(7, dtype=Ri.dtype, device=Ri.device)[:, None, :]
    with torch.enable_grad():
        di = torch.zeros(7, E, 7, dtype=Ri.dtype, device=Ri.device,
                         requires_grad=True)
        dj = torch.zeros_like(di, requires_grad=True)
        r7 = _edge_residual(di, dj, *rows)
        gi, gj = torch.autograd.grad((r7 * eye).sum(), (di, dj))
    # [E, 7] and [E, res, dir]
    return r7[0].detach(), gi.permute(1, 0, 2), gj.permute(1, 0, 2)


def _normal_blocks(R, t, s, edge_i, edge_j, eR, et, es, edge_w):
    r, Ji, Jj = _res_and_jac(R[edge_i], t[edge_i], s[edge_i],
                             R[edge_j], t[edge_j], s[edge_j], eR, et, es)
    w = edge_w[:, None, None]
    JiW, JjW = Ji * w, Jj * w
    Hii = JiW.transpose(1, 2) @ Ji
    Hjj = JjW.transpose(1, 2) @ Jj
    Hij = JiW.transpose(1, 2) @ Jj
    bi = (JiW.transpose(1, 2) @ r[..., None])[..., 0]
    bj = (JjW.transpose(1, 2) @ r[..., None])[..., 0]
    chi2 = (r * r * edge_w[:, None]).sum()
    return Hii, Hjj, Hij, bi, bj, chi2


def _retract(d, R, t, s):
    Rd, td, sd = sim3_exp(d)
    return sim3_mul(Rd, td, sd, R, t, s)


def optimize_pose_graph(R, t, s, edge_i, edge_j, eR, et, es, edge_w,
                        fixed, n_nodes: int, iters: int = 20,
                        damping: float = 1e-6):
    """Optimize Sim3 keyframe poses against relative-Sim3 edges.

    R/t/s: [K] node Sim3 (world->cam). edge_*: [E] endpoint indices, the
    measured relative Sim3 (S_ji: cam_i -> cam_j) and weights (0 = padding).
    fixed: [K] bool gauge anchors."""
    K = n_nodes
    dev = R.device
    ei, ej = edge_i.long(), edge_j.long()
    free = (~fixed).to(R.dtype)
    fm = free[:, None]
    eye7 = torch.eye(7, dtype=R.dtype, device=dev)
    diag = torch.arange(K, device=dev)
    chi2 = torch.zeros((), dtype=R.dtype, device=dev)
    for _ in range(iters):
        Hii, Hjj, Hij, bi, bj, chi2 = _normal_blocks(R, t, s, ei, ej, eR, et,
                                                     es, edge_w)
        flat = segment_sum(
            torch.cat([Hii, Hjj, Hij, Hij.transpose(1, 2)]),
            torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]),
            K * K)
        H = flat.reshape(K, K, 7, 7).permute(0, 2, 1, 3)
        b = segment_sum(torch.cat([bi, bj]), torch.cat([ei, ej]), K)
        H = H * fm[:, :, None, None] * fm[None, None, :, :]
        H[diag, :, diag, :] += (eye7[None] * (1.0 - free)[:, None, None]
                                + damping * eye7[None])
        d = -solve_preconditioned(H.reshape(K * 7, K * 7),
                                  (b * fm).reshape(K * 7)).reshape(K, 7) * fm
        R, t, s = _retract(d, R, t, s)
    return PoseGraphResult(R=R, t=t, s=s, total_chi2=chi2)


def optimize_pose_graph_cg(R, t, s, edge_i, edge_j, eR, et, es, edge_w,
                           fixed, n_nodes: int, iters: int = 20,
                           cg_iters: int = 100, damping: float = 1e-5):
    """Matrix-free Sim3 pose-graph GN for large graphs: the same problem as
    optimize_pose_graph, with the normal equations solved by
    block-Jacobi-preconditioned conjugate gradients where H x is evaluated
    edge-wise — memory O(E * 49) instead of O(K^2 * 49)."""
    K = n_nodes
    dev = R.device
    ei, ej = edge_i.long(), edge_j.long()
    free = (~fixed).to(R.dtype)
    fm = free[:, None]
    eye7 = torch.eye(7, dtype=R.dtype, device=dev)
    chi2 = torch.zeros((), dtype=R.dtype, device=dev)

    def scatter(idx, x):
        return segment_sum(x, idx, K)

    for _ in range(iters):
        Hii, Hjj, Hij, bi, bj, chi2 = _normal_blocks(R, t, s, ei, ej, eR, et,
                                                     es, edge_w)
        b = -(scatter(ei, bi) + scatter(ej, bj)) * fm
        HijT = Hij.transpose(1, 2)

        def Hx(x):
            x = x * fm
            xi, xj = x[ei][..., None], x[ej][..., None]
            y = (scatter(ei, (Hii @ xi + Hij @ xj)[..., 0])
                 + scatter(ej, (HijT @ xi + Hjj @ xj)[..., 0]))
            return (y + damping * x) * fm

        # block-Jacobi preconditioner from the diagonal blocks
        Mdiag = (scatter(ei, Hii) + scatter(ej, Hjj)
                 + (damping + 1e-8) * eye7[None])
        Minv = torch.linalg.inv_ex(Mdiag).inverse

        def prec(x):
            return (Minv @ x[..., None])[..., 0] * fm

        x = torch.zeros(K, 7, dtype=R.dtype, device=dev)
        rr = b - Hx(x)
        z = prec(rr)
        p = z
        for _ in range(cg_iters):
            Ap = Hx(p)
            rz = (rr * z).sum()
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-20)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = prec(rr)
            beta = (rr * z).sum() / torch.clamp(rz, min=1e-20)
            p = z + beta * p
        R, t, s = _retract(x * fm, R, t, s)
    return PoseGraphResult(R=R, t=t, s=s, total_chi2=chi2)
