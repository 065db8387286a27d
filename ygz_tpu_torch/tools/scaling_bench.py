"""Distributed-BA scaling sweep (BASELINE.md: >= 70% scaling efficiency at
N >= 2).

Port of the JAX repository's ``tools/scaling_bench.py``: the
landmark-sharded global-BA step (``parallel/dist_ba.py``) at each mesh size
in strong scaling (fixed total observations) and weak scaling
(observations per shard fixed), and one solve split into its phases: the
normal-equation phase (``cg_iters=0``), the PCG phase (the rest) and the
psum pattern alone. Meshes: 1, 2, 4 and 8 shards on the CPU, or 1 and 2
shards of ``cuda:0`` on the card.

Shards of one device share it: on the CPU they share its cores, and on one
card the sweep measures the host's launch overhead per shard, not scaling.
Scaling across cards needs a machine with several. The output says so.

    python -m ygz_tpu_torch.tools.scaling_bench [--device cpu]
        [--out build/ygz_tpu_torch/scaling.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import device_label, resolve_device, sync
from ..utils.cuda_build import BUILD_DIR


def make_problem(P, L, O, seed=0):
    rng = np.random.default_rng(seed)
    intr = (400.0, 400.0, 320.0, 240.0)
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4, 9, L)], 1).astype(np.float32)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    kf_t = np.zeros((P, 3), np.float32)
    kf_t[:, 0] = 0.1 * np.arange(P)
    obs_p = rng.integers(0, P, O).astype(np.int32)
    obs_l = rng.integers(0, L, O).astype(np.int32)
    Xc = X[obs_l] + kf_t[obs_p]
    uv = np.stack([intr[0] * Xc[:, 0] / Xc[:, 2] + intr[2],
                   intr[1] * Xc[:, 1] / Xc[:, 2] + intr[3]], 1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    free = np.array([False] + [True] * (P - 1))
    # perturb the initial state so the solve does real work
    X0 = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    return (kf_R, kf_t, free, X0, np.ones(L, bool),
            obs_p, obs_l, uv, np.ones(O, np.float32), intr)


def time_ba(mesh, prob, P, L, iters=10, reps=5, cg_iters=48):
    """(seconds per solve, final chi2) of the sharded solve over `mesh`."""
    from ..parallel.dist_ba import (make_distributed_ba,
                                    partition_obs_by_landmark)

    (kf_R, kf_t, free, X0, ptv, obs_p, obs_l, obs_uv, obs_w, intr) = prob
    op, ol, ouv, our, ow, _ = partition_obs_by_landmark(
        obs_p, obs_l, obs_uv, obs_w, L, mesh.size)
    ba = make_distributed_ba(mesh, n_poses=P, n_points=L, iters=iters,
                             cg_iters=cg_iters)
    args = (kf_R, kf_t, free, X0, ptv, op, ol, ouv, our, ow, intr, 0.0)
    dev = str(mesh.devices[0])
    res = ba(*args)                      # warm-up
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        res = ba(*args)
    sync(dev)
    return (time.perf_counter() - t0) / reps, float(res.total_chi2)


def time_psum_loop(mesh, P, n_psums, reps=20):
    """The solve's per-GN-iteration sum pattern ([P, 6] per shard, n_psums
    times) alone: what the communication costs on this mesh with no local
    work."""
    import torch

    x = [torch.ones((P, 6), device=d) for d in mesh.devices]
    dev = str(mesh.devices[0])

    def loop():
        v = x
        for _ in range(n_psums):
            s = mesh.psum(v) * (1.0 / mesh.size)
            v = [s.to(d) for d in mesh.devices]
        return v

    loop()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        loop()
    sync(dev)
    return (time.perf_counter() - t0) / reps


def phase_breakdown(mesh, prob, P, L, reps=5):
    """One 10-iteration solve split into the normal-equation phase
    (residuals, Jacobians, U/V/D blocks, back-substitution; cg_iters=0),
    the PCG phase (the remainder) and the psum pattern alone."""
    t_full, _ = time_ba(mesh, prob, P, L, iters=10, reps=reps, cg_iters=48)
    t_ne, _ = time_ba(mesh, prob, P, L, iters=10, reps=reps, cg_iters=0)
    # per solve: 10 GN iterations x (48 CG sums + 3 block sums)
    t_psum = time_psum_loop(mesh, P, n_psums=10 * 51, reps=reps)
    return {"full_ms": round(t_full * 1e3, 2),
            "normal_eq_ms": round(t_ne * 1e3, 2),
            "cg_ms": round((t_full - t_ne) * 1e3, 2),
            "psum_only_ms": round(t_psum * 1e3, 2)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(BUILD_DIR / "scaling.json"))
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--obs", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sizes", default=None,
                    help="mesh sizes, comma-separated (default 1,2,4,8 on "
                         "the CPU, 1,2 on the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    from ..parallel.dist_ba import Mesh

    cuda = device.startswith("cuda")
    shard_dev = "cuda:0" if cuda else "cpu"
    sizes = [int(s) for s in (args.sizes or ("1,2" if cuda else "1,2,4,8")
                              ).split(",")]
    P, L, O = args.poses, args.points, args.obs
    strong, weak, phases = {}, {}, {}
    for n in sizes:
        mesh = Mesh([shard_dev] * n)
        prob = make_problem(P, L, O)
        t, chi = time_ba(mesh, prob, P, L, reps=args.reps)
        strong[n] = t
        print(f"strong n={n}: {t * 1e3:.1f} ms/solve chi2={chi:.1f}",
              flush=True)
        phases[n] = phase_breakdown(mesh, prob, P, L, reps=args.reps)
        print(f"phases n={n}: {phases[n]}", flush=True)
        O_w = O * n // max(sizes)
        t, chi = time_ba(mesh, make_problem(P, L, O_w), P, L, reps=args.reps)
        weak[n] = t
        print(f"weak   n={n}: {t * 1e3:.1f} ms/solve (O={O_w})", flush=True)

    out = {
        "problem": {"poses": P, "points": L, "observations": O,
                    "iters_per_solve": 10},
        "platform": "cuda" if cuda else "cpu",
        "device": device_label(device),
        "n_physical_devices_note": (
            f"every shard on {shard_dev}: "
            + ("the shards share one card, so the sweep measures the "
               "host's launch overhead per shard, not scaling across cards"
               if cuda else
               f"the shards share {os.cpu_count()} host cores; beyond that "
               "count wall-clock efficiency measures oversubscription, not "
               "the sharded program")),
        "strong_ms_per_solve": {str(n): round(strong[n] * 1e3, 2)
                                for n in sizes},
        "weak_ms_per_solve": {str(n): round(weak[n] * 1e3, 2) for n in sizes},
        "strong_efficiency": {str(n): round(strong[sizes[0]] * sizes[0]
                                            / (n * strong[n]), 3)
                              for n in sizes},
        "weak_efficiency": {str(n): round(weak[sizes[0]] / weak[n], 3)
                            for n in sizes},
        "phase_breakdown_ms": {str(n): phases[n] for n in sizes},
        "target": ">=0.70 at N>=2 (BASELINE.md)",
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
