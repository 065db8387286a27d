"""The port's measuring and evaluation entry points (ygz_tpu_torch/tools/)
against the JAX repository's bench.py and tools/: the same frames, paths
and problems from the same seeds; a short CPU run of each tool writing its
JSON or table with the JAX tool's keys; the per-closure loop recorder on a
loop that fires; and every tool importing without JAX."""
import copy
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from ygz_tpu_torch.backend import bow as tbow
from ygz_tpu_torch.backend.loopclosing import LoopCloser
from ygz_tpu_torch.backend.mapstate import SlamMap
from ygz_tpu_torch.frontend.tracker import FrameRecord
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.tools import (ate_report, bench, long_sequence,
                                 profile_framestep, scaling_bench,
                                 train_vocab)

import torch_parity  # noqa: F401  (small torch thread pools)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("bench", "long_sequence", "ate_report", "profile_framestep",
         "train_vocab", "scaling_bench")


def _load(rel, name):
    """A JAX repository script (bench.py, tools/*.py) as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ JAX parity
def test_bench_frames_match_jax(tmp_path, monkeypatch):
    """The port's bench frames are bench.render_frames' bit for bit."""
    jb = _load("bench.py", "jax_bench")
    monkeypatch.setattr(jb, "WARM_FRAMES", 3)
    monkeypatch.setattr(jb, "N_FRAMES", 5)
    monkeypatch.setattr(jb, "FRAMES_NPY", str(tmp_path / "frames.npy"))
    assert jb.render_frames() == 8
    want = np.load(tmp_path / "frames.npy")
    got, poses = bench.render_frames(8)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert len(poses) == 8


@pytest.mark.parametrize("path", ["long_sequence", "make_trajectory"])
def test_paths_match_jax(path):
    """long_sequence.pose / leg_length against tools/long_sequence.py, and
    ate_report.make_trajectory against test_vo_e2e.make_trajectory, within
    1e-6."""
    if path == "long_sequence":
        jl = _load(os.path.join("tools", "long_sequence.py"), "jax_longseq")
        for n in (64, 400, 2240, 4000):
            assert abs(long_sequence.leg_length(n) - jl.leg_length(n)) < 1e-6
            for i in sorted({0, 1, n // 9, n // 2, n - 1}):
                for a, b in zip(long_sequence.pose(i, n), jl.pose(i, n)):
                    np.testing.assert_allclose(a, b, atol=1e-6)
    else:
        from test_vo_e2e import make_trajectory
        for (Ra, ta), (Rb, tb) in zip(ate_report.make_trajectory(60),
                                      make_trajectory(60)):
            np.testing.assert_allclose(Ra, Rb, atol=1e-6)
            np.testing.assert_allclose(ta, tb, atol=1e-6)


def test_scaling_problem_matches_jax():
    js = _load(os.path.join("tools", "scaling_bench.py"), "jax_scaling")
    for P, L, O in ((4, 64, 256), (16, 2048, 8192)):
        got, want = scaling_bench.make_problem(P, L, O), \
            js.make_problem(P, L, O)
        assert len(got) == len(want)
        for g, w in zip(got[:-1], want[:-1]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[-1] == want[-1]


# ------------------------------------------------------------ CPU runs
def test_bench_runs_on_cpu(tmp_path):
    out = tmp_path / "bench.json"
    res = bench.main(["--device", "cpu", "--warm", "16", "--frames", "24",
                      "--batch", "8", "--pipeline-chunks", "1",
                      "--out", str(out)])
    assert json.loads(out.read_text()) == res
    jax_keys = {"metric", "value", "unit", "vs_baseline", "p50_frame_ms",
                "p90_frame_ms", "max_frame_ms", "mapping_drain_s",
                "device_pipeline_fps", "frames_ok", "frames_logged",
                "n_keyframes", "stage_ms"}
    assert jax_keys <= set(res)
    assert res["metric"] == "tracking_fps_per_chip"
    assert res["frames_logged"] == 40 and res["frames_timed"] == 24
    assert res["device"] == "cpu" and res["launch_calls_per_chunk"] is None
    assert res["ok_bar"] == 0.95 and res["device_pipeline_fps"] > 0
    assert res["ate_rmse_7dof"] < 0.03 * res["path_length"]
    assert "frame_step" in res["stage_ms"]


def test_long_sequence_runs_on_cpu(tmp_path):
    out = tmp_path / "longrun.json"
    res = long_sequence.main(["--frames", "64", "--device", "cpu",
                              "--out", str(out)])
    assert json.loads(out.read_text()) == res
    with open(os.path.join(ROOT, "LONGRUN_r05.json")) as f:
        jax_keys = set(json.load(f))
    assert set(res) == jax_keys | {"device"}
    assert res["platform"] == "cpu" and res["frames"] == 64
    assert res["frames_ok"] > 0.9 * 64 and res["ate_rmse_7dof"] < 0.25
    assert res["mapping_drain_s"] < 30.0


def test_ate_report_runs_on_cpu(tmp_path):
    out = tmp_path / "ate.md"
    rows = ate_report.main(["--modes", "mono", "--frames", "24",
                            "--device", "cpu", "--out", str(out)])
    text = out.read_text()
    assert "| mode | nuisances | ATE RMSE | frames OK | alignment |" in text
    assert [r[:2] for r in rows] == [("mono", "no"), ("mono", "yes")]
    for _, nu, rmse, ok, n, align in rows:
        assert n == 24 and ok > 12 and np.isfinite(rmse)
        assert f"| mono | {nu} | {rmse:.4f} | {ok}/24 |" in text
        assert align == "7-DoF (mono scale)"


def test_keyframe_log_and_weak_keyframe_stalls():
    """ate_report.keyframe_log records a tracker class's decisions and
    keyframes and restores the class; weak_keyframe_stalls flags a keyframe
    made with < 50 points that no keyframe followed for max_gap frames
    while the tracker saw at least twice its points, and nothing else."""
    class Tracker:
        frame_id = 0

        def _need_new_keyframe(self, ts, n_inliers, *args):
            return n_inliers < 50 or self.frame_id % 30 == 0

        def _create_keyframe(self, pyr, ts, R, t, ids, *args):
            return len(ids)

    need, create = Tracker._need_new_keyframe, Tracker._create_keyframe
    inliers = {f: 120 for f in range(1, 100)}
    inliers.update({5: 40, 10: 45, 60: 70})
    tr = Tracker()
    with ate_report.keyframe_log(Tracker) as (created, decided):
        for f in range(1, 100):
            tr.frame_id = f
            n = inliers[f]
            if tr._need_new_keyframe(f * 0.05, n, None, None, None):
                assert tr._create_keyframe(None, 0, None, None,
                                           np.arange(n)) == n
    assert Tracker._need_new_keyframe is need
    assert Tracker._create_keyframe is create
    assert decided == sorted(inliers.items())
    assert created == [(5, 40), (10, 45), (30, 120), (60, 70), (90, 120)]
    # keyframe 10 (45 points) held 20 frames: no stall at max_gap 20 only
    assert ate_report.weak_keyframe_stalls(created, decided, 30) == []
    assert ate_report.weak_keyframe_stalls(created, decided, 20) == \
        [(10, 45, 20, 120.0)]


def test_profile_framestep_runs_on_cpu(tmp_path):
    out = tmp_path / "prof.json"
    res = profile_framestep.main(
        ["--device", "cpu", "--width", "188", "--height", "120", "--cap",
         "64", "--reps", "1", "--out", str(out), "--trace-dir",
         str(tmp_path / "trace")])
    assert json.loads(out.read_text()) == res
    for k in ("pyramid_ms", "sparse_align_ms", "direct_track_ms",
              "sample_512x10x10_ms", "align2d_L0_ms", "pose_opt_ms",
              "frame_step_batch8_ms", "per_frame_ms"):
        assert res[k] > 0, k
    # device time is not a CPU number
    assert set(res["device_ms"].values()) == {None}
    assert os.path.getsize(res["trace"]) > 0


def test_train_vocab_runs_on_cpu(tmp_path):
    out = tmp_path / "v.npz"
    cache = tmp_path / "corpus.npz"
    argv = ["--device", "cpu", "--scenes", "1", "--views", "2",
            "--branching", "4", "--depth", "2", "--out", str(out),
            "--desc-cache", str(cache)]
    vocab = train_vocab.main(argv)
    loaded = tbow.load_vocabulary(str(out))
    assert (loaded.branching, loaded.depth) == (4, 2)
    assert 4 < loaded.n_words <= 16
    np.testing.assert_array_equal(loaded.words, vocab.words)
    # a retry with the same corpus reads the cache and trains the same tree
    again = train_vocab.main(argv)
    np.testing.assert_array_equal(again.words, vocab.words)


def test_scaling_bench_runs_on_cpu(tmp_path):
    out = tmp_path / "scaling.json"
    res = scaling_bench.main(["--device", "cpu", "--poses", "4", "--points",
                              "64", "--obs", "256", "--reps", "1",
                              "--sizes", "1,2", "--out", str(out)])
    assert json.loads(out.read_text()) == res
    for key in ("strong_ms_per_solve", "weak_ms_per_solve",
                "strong_efficiency", "weak_efficiency",
                "phase_breakdown_ms"):
        assert set(res[key]) == {"1", "2"}, key
    assert res["platform"] == "cpu"


# ------------------------------------------------------------ loop recorder
CAM = Camera.make(400.0, 400.0, 320.0, 240.0, 640, 480)
I3 = np.eye(3, dtype=np.float32)
Z3 = np.zeros(3, np.float32)


def _project(X):
    return np.stack([400.0 * X[:, 0] / X[:, 2] + 320.0,
                     400.0 * X[:, 1] / X[:, 2] + 240.0], -1).astype(np.float32)


def _feats(uv, desc, m=256):
    f = {"uv": np.zeros((m, 2), np.float32), "level": np.zeros(m, np.int32),
         "angle": np.zeros(m, np.float32),
         "desc": np.zeros((m, 256), np.uint8), "valid": np.zeros(m, bool)}
    f["uv"][: len(uv)] = uv
    f["desc"][: len(uv)] = desc
    f["valid"][: len(uv)] = True
    return f


def _revisit_with_drift():
    """14 keyframes: KF0-2 see place A's landmarks; KF3-10 a chain of other
    places (consecutive keyframes share 20 points); KF11-13 see place A
    again through noisy descriptors bound to duplicates drifted by a Sim3
    (s 1.08), sharing them among themselves and 20 points with KF10.
    Returns (map, BoW index, bow vectors)."""
    rng = np.random.default_rng(8)
    N = 400
    X = np.stack([rng.uniform(-2.5, 2.5, N), rng.uniform(-1.8, 1.8, N),
                  rng.uniform(4.0, 9.0, N)], -1).astype(np.float32)
    w = np.array([0.02, -0.04, 0.03])
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K)
    Xd = (1.08 * X @ R.T + np.array([0.3, -0.1, 0.4])).astype(np.float32)
    uv_a, uv_d = _project(X), _project(Xd)
    inb = ((np.minimum(uv_a, uv_d) > 25).all(1)
           & (uv_a[:, 0] < 615) & (uv_d[:, 0] < 615)
           & (uv_a[:, 1] < 455) & (uv_d[:, 1] < 455))
    keep = np.nonzero(inb)[0][:100]
    X, Xd, uv_a, uv_d = X[keep], Xd[keep], uv_a[keep], uv_d[keep]
    n = len(X)
    place_a = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    places = [rng.integers(0, 2, (n, 256)).astype(np.uint8)
              for _ in range(8)]
    smap = SlamMap(max_kf=16, max_pt=4096, max_feat=256)

    def landmarks(kf, P, d):
        ids = smap.alloc_points(len(P))
        smap.pt_xyz[ids] = P
        smap.pt_valid[ids] = True
        smap.pt_desc[ids] = d
        smap.pt_ref_kf[ids] = kf
        smap.bind(kf, np.arange(len(P)), ids)
        return ids

    descs = []
    prev = None
    for k in range(14):
        if k <= 2:
            d, uv = place_a, uv_a
        elif k <= 10:
            d = places[k - 3]
            uv = rng.uniform(30, [610, 450], (n, 2)).astype(np.float32)
        else:
            d = place_a.copy()
            for i in range(n):
                d[i, rng.choice(256, 10, replace=False)] ^= 1
            uv = uv_d
        t = np.array([0.2 * (k - 2), 0, 0], np.float32) \
            if 3 <= k <= 10 else Z3
        kf = smap.add_keyframe(I3, t, _feats(uv, d))
        descs.append(d)
        if k == 0:
            ids_a = landmarks(kf, X, d)
        elif k <= 2:
            smap.bind(kf, np.arange(n), ids_a)
        elif k == 11:
            ids_d = landmarks(kf, Xd, d)
        elif k > 11:
            smap.bind(kf, np.arange(n), ids_d)
        else:
            P = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                          rng.uniform(4, 9, n)], -1).astype(np.float32)
            landmarks(kf, P, d)
        if 3 <= k <= 11:
            smap.bind(kf, np.arange(n, n + 20), smap.kf_feat_pt[prev, :20])
        prev = kf
    vocab = tbow.train_vocabulary(np.concatenate([place_a] + places),
                                  branching=8, depth=2)
    index = tbow.BowIndex(vocab, max_kf=16, max_feat=256, device="cpu")
    bows = []
    for k in range(14):
        wid, b = index.quantize(descs[k], np.ones(n, bool))
        index.add_keyframe(k, b, feat_wid=wid)
        bows.append(b)
    return smap, index, bows


def test_closure_recorder_on_a_loop_that_fires():
    """long_sequence.record_closures on a loop that detect -> compute_sim3
    -> correct accepts: every call returns what the plain LoopCloser's does,
    the consistency groups and the detection count are left as detect alone
    leaves them, and the accepted event gains its ATE before and after."""
    smap, index, bows = _revisit_with_drift()
    plain_map, rec_map = copy.deepcopy(smap), copy.deepcopy(smap)
    plain = LoopCloser(index, CAM, device="cpu")
    lc = LoopCloser(index, CAM, device="cpu")
    rng = np.random.default_rng(1)
    gt = [np.array([0.05 * i, 0.1 * np.sin(i), 0.02 * i * i])
          for i in range(12)]
    traj = [FrameRecord(ts=0.05 * i, R=I3, t=-(c + rng.normal(0, 0.01, 3)),
                        state="OK") for i, c in enumerate(gt)]
    system = types.SimpleNamespace(
        trajectory=traj, tracker=types.SimpleNamespace(
            loop_closer=lc, recovered_pose=lambda rec: (rec.R, rec.t)))
    logged = []
    real = LoopCloser.process_keyframe
    with long_sequence.record_closures(system, gt, logged.append) as events:
        for k in (11, 12, 13):
            want = plain.process_keyframe(plain_map, k, bows[k])
            got = lc.process_keyframe(rec_map, k, bows[k])
            assert got == want, k
            assert lc.n_detect == plain.n_detect
            assert [(sorted(g), c) for g, c in lc._consistent_groups] == \
                [(sorted(g), c) for g, c in plain._consistent_groups], k
    assert LoopCloser.process_keyframe is real
    assert want, "the scenario's loop did not fire"
    assert len(events) == len(plain.events) == 1 and len(logged) == 1
    ev = events[0]
    assert ev is lc.events[-1]
    assert {k: ev[k] for k in plain.events[0]} == plain.events[0]
    assert ev["cand"] in (0, 1, 2) and ev["kf"] == 13
    assert 0 <= ev["ate_pre"] < 0.05 and ev["ate_post"] == ev["ate_pre"]
    np.testing.assert_allclose(rec_map.kf_R, plain_map.kf_R, atol=1e-6)
    np.testing.assert_allclose(rec_map.pt_xyz, plain_map.pt_xyz, atol=1e-5)


# ------------------------------------------------------------ no JAX
def test_tools_import_no_jax():
    """Every tool imports with jax, ygz_tpu and the tests' modules
    blocked."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'ygz_tpu', 'synthetic',\n"
        "                   'torch_parity') or top.startswith('test_'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {TOOLS!r}:\n"
        "    __import__('ygz_tpu_torch.tools.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'ygz_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
