"""A process of a multi-process distributed-BA job.

Port of ``tools/multihost_worker.py``: N copies of this module start, each
joins the job's process group over a localhost coordinator
(``multihost.init_distributed``), contributes two shards, and runs the
landmark-block-sharded BA (``dist_ba.py``) over the job's mesh, with its
sums crossing the process boundary. Process 0 prints the result:

    python -m ygz_tpu_torch.parallel.worker <host:port> <num_procs> <pid> \
        [--device cpu|cuda]

    RESULT <total_chi2> <kf_t, 12 values>
    TIMING <ms per solve> <host launch calls per solve, 0 on the CPU>

The gloo backend carries the sums (CUDA tensors through the host), so the
processes may share one card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

SHARDS_PER_PROCESS = 2


def build_problem(seed=0, P=4, L=64, O=1024, intr=(400.0, 400.0, 320.0,
                                                   240.0)):
    """Deterministic BA problem, identical in every process (the JAX
    worker's, from the same seed)."""
    from ..geometry import lie

    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4, 9, L)], 1).astype(np.float32)
    poses = []
    for p in range(P):
        w = rng.standard_normal(3).astype(np.float32) * 0.02
        t = np.array([0.3 * p, 0.0, 0.0], np.float32)
        poses.append((lie.so3_exp(torch.from_numpy(w)).numpy(), t))
    obs_p, obs_l, obs_uv = [], [], []
    for p, (R, t) in enumerate(poses):
        Xc = X @ R.T + t
        uv = np.stack([intr[0] * Xc[:, 0] / Xc[:, 2] + intr[2],
                       intr[1] * Xc[:, 1] / Xc[:, 2] + intr[3]], 1)
        uv += rng.standard_normal(uv.shape).astype(np.float32) * 0.2
        inb = ((uv > 10).all(1) & (uv < [630, 470]).all(1))
        for li in np.nonzero(inb)[0]:
            obs_p.append(p)
            obs_l.append(li)
            obs_uv.append(uv[li])
    n = len(obs_p)
    pad = O - n
    obs_p = np.array(obs_p + [0] * pad, np.int32)
    obs_l = np.array(obs_l + [0] * pad, np.int32)
    obs_uv = np.concatenate([np.asarray(obs_uv, np.float32),
                             np.zeros((pad, 2), np.float32)])
    obs_w = np.array([1.0] * n + [0.0] * pad, np.float32)
    X0 = X + rng.standard_normal(X.shape).astype(np.float32) * 0.05
    kf_R = np.stack([R for (R, t) in poses])
    kf_t = np.stack([t + rng.standard_normal(3).astype(np.float32) * 0.02
                     for (R, t) in poses])
    free = np.array([False, False] + [True] * (P - 2))
    return kf_R, kf_t, free, X0, obs_p, obs_l, obs_uv, obs_w, intr


def solve(mesh):
    """The worker's problem (4 poses, 64 points, 12 GN steps) solved over
    `mesh`: returns (run, result), `run` a no-argument callable that
    solves it again."""
    from .dist_ba import make_distributed_ba, partition_obs_by_landmark

    P, L = 4, 64
    (kf_R, kf_t, free, X0, obs_p, obs_l, obs_uv, obs_w,
     intr) = build_problem(P=P, L=L)
    op, ol, ouv, our, ow, _ = partition_obs_by_landmark(
        obs_p, obs_l, obs_uv, obs_w, L, mesh.size)
    ba = make_distributed_ba(mesh, n_poses=P, n_points=L, iters=12)

    def run():
        return ba(kf_R, kf_t, free, X0, np.ones(L, bool), op, ol, ouv, our,
                  ow, intr, 0.0)
    return run, run()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("coordinator", help="host:port of process 0")
    ap.add_argument("num_processes", type=int)
    ap.add_argument("process_id", type=int)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here")

    import torch.distributed as dist

    from ..utils.profiling import launch_calls
    from .multihost import global_ba_mesh, init_distributed

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    try:
        mesh = global_ba_mesh(SHARDS_PER_PROCESS * args.num_processes,
                              device=args.device)
        run, res = solve(mesh)
        sync = (torch.cuda.synchronize if args.device == "cuda"
                else lambda: None)
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        calls = launch_calls(run) if args.device == "cuda" else 0
        if args.process_id == 0:
            print("RESULT", repr(float(res.total_chi2)),
                  " ".join(repr(float(v)) for v in res.kf_t.cpu().ravel()),
                  flush=True)
            print("TIMING", repr(ms), calls, flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
