"""The torch port's multi-process distributed BA on the CPU: two worker
processes (python -m ygz_tpu_torch.parallel.worker, two shards each) join a
gloo process group over localhost and solve the sharded problem with their
sums crossing the process boundary; the result must match the port's
single-process solve on four shards (tests/test_multihost.py's bounds:
kf_t within 1e-4, chi2 within 1%). Also: the one-process mesh, the
worker's problem against the JAX worker's, array for array, and the
parallel package imported without JAX."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ygz_tpu_torch.parallel.dist_ba import Mesh
from ygz_tpu_torch.parallel.multihost import global_ba_mesh, init_distributed
from ygz_tpu_torch.parallel.worker import build_problem, solve

import torch_parity  # noqa: F401  (caps torch threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_matches_single_process():
    n_proc = 2
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ygz_tpu_torch.parallel.worker", coord,
         str(n_proc), str(i), "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for i in range(n_proc)]
    outs = []
    try:
        for p in procs:
            # a hung rendezvous fails here instead of eating the suite
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{err[-2000:]}"
    lines = [ln.split() for _, out, _ in outs for ln in out.splitlines()]
    result = [ln for ln in lines if ln[0] == "RESULT"]
    timing = [ln for ln in lines if ln[0] == "TIMING"]
    assert len(result) == 1 and len(timing) == 1, outs
    chi2_mp = float(result[0][1])
    kf_t_mp = np.array([float(v) for v in result[0][2:]]).reshape(-1, 3)
    assert float(timing[0][1]) > 0 and timing[0][2] == "0"

    _, res = solve(Mesh(["cpu"] * 4))
    kf_t_sp = res.kf_t.numpy()
    chi2_sp = float(res.total_chi2)
    np.testing.assert_allclose(kf_t_mp, kf_t_sp, atol=1e-4)
    assert abs(chi2_mp - chi2_sp) < 0.01 * max(chi2_sp, 1.0), \
        (chi2_mp, chi2_sp)


def test_one_process_mesh():
    """One process: init_distributed is a no-op and the mesh lists this
    process's shards with no group; a card mesh with no card raises."""
    init_distributed("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()
    mesh = global_ba_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.group is None and mesh.first_shard == 0
    assert [d.type for d in mesh.devices] == ["cpu"] * 4
    assert global_ba_mesh(device="cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            global_ba_mesh(2)


def test_worker_problem_is_the_jax_workers():
    """build_problem gives tools/multihost_worker.py's arrays bit for bit
    (that module sets JAX's environment when imported: restored after)."""
    saved = dict(os.environ)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import multihost_worker
    finally:
        sys.path.pop(0)
        os.environ.clear()
        os.environ.update(saved)
    want = multihost_worker.build_problem()
    got = build_problem()
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[-1] == want[-1]


def test_parallel_imports_no_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'ygz_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import ygz_tpu_torch.parallel\n"
        "from ygz_tpu_torch.parallel import dist_ba, multihost, worker\n"
        "from ygz_tpu_torch.frontend.tracker import TrackerConfig\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'ygz_tpu')]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
