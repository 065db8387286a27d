"""The torch port's distributed bundle adjustment (ygz_tpu_torch/parallel/)
against the JAX package's on the CPU: the observation partition (exact),
the sharded step on meshes of 1, 2 and 4 shards against the JAX step on a
virtual CPU mesh of the same size, the mapper's sharded global BA against
its dense one and against the JAX mapper's sharded one, the outlier gating
with stereo rows, and the tracker's mesh. The problems are those of
tests/test_dist_ba.py, made with numpy from its seeds."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from ygz_tpu.backend.mapping import LocalMapper as JaxMapper
from ygz_tpu.geometry import camera as jcam
from ygz_tpu.geometry import lie as jlie
from ygz_tpu.parallel import dist_ba as jdist
from ygz_tpu_torch.backend.mapping import LocalMapper
from ygz_tpu_torch.backend.mapstate import SlamMap
from ygz_tpu_torch.frontend.tracker import MonoTracker, TrackerConfig
from ygz_tpu_torch.frontend.vi_tracker import MonoViTracker
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.parallel import dist_ba as tdist

from torch_parity import np_, rot_angle_deg
from test_dist_ba import INTR, build_problem


def _jax_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("obs",))


def _jax_run(ba, args):
    return jax.tree.map(np.asarray, ba(*(
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)))


def _port_run(ba, args):
    return tdist.DistBAResult(*(np_(a) for a in ba(*args)))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("pad_to", [None, 512])
@pytest.mark.parametrize("stereo", [False, True])
def test_partition_obs_by_landmark_exact(n_dev, pad_to, stereo):
    _, _, obs_p, obs_l, obs_uv, obs_w = build_problem(P=4, L=256, O=2048)
    ur = None
    if stereo:
        ur = np.where(np.arange(len(obs_p)) % 3 == 0,
                      obs_uv[:, 0] - 5.0, -1.0).astype(np.float32)
    got = tdist.partition_obs_by_landmark(obs_p, obs_l, obs_uv, obs_w, 256,
                                          n_dev, pad_to=pad_to, obs_ur=ur)
    want = jdist.partition_obs_by_landmark(obs_p, obs_l, obs_uv, obs_w, 256,
                                           n_dev, pad_to=pad_to, obs_ur=ur)
    assert got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # padding rows: w = 0, pose 0, the shard's own first landmark
    op, ol, _, _, ow, O_shard = got
    Lb = 256 // n_dev
    for d in range(n_dev):
        rows = slice(d * O_shard, (d + 1) * O_shard)
        pad = ow[rows] == 0
        assert (op[rows][pad] == 0).all()
        assert (ol[rows][pad] == d * Lb).all() or not pad.any()


def _converging_problem():
    """test_dist_ba.py's converging problem: P=4, L=256, poses 2-3 and
    every point perturbed."""
    P, L, O = 4, 256, 2048
    poses, X, obs_p, obs_l, obs_uv, obs_w = build_problem(P=P, L=L, O=O)
    rng = np.random.default_rng(1)
    kf_R, kf_t = [], []
    for p, (R, t) in enumerate(poses):
        if p < 2:
            kf_R.append(R)
            kf_t.append(t)
        else:
            dw = rng.standard_normal(3).astype(np.float32) * 0.01
            dt = rng.standard_normal(3).astype(np.float32) * 0.03
            kf_R.append(np.asarray(jlie.so3_exp(jnp.asarray(dw))) @ R)
            kf_t.append(t + dt)
    Xp = X + rng.standard_normal(X.shape).astype(np.float32) * 0.05
    free = np.array([False, False] + [True] * (P - 2))
    return (P, L, poses, X, Xp,
            (np.stack(kf_R), np.stack(kf_t), free, Xp, np.ones(L, bool)),
            (obs_p, obs_l, obs_uv, obs_w))


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_distributed_ba_matches_jax(n_dev):
    """The port on n_dev CPU shards against the JAX step on a virtual mesh
    of n_dev devices: keyframe translations within 2e-3 and points within
    2e-2 (test_dist_ba.py's cross-mesh tolerance), total chi2 within 1%,
    and test_dist_ba.py's convergence bounds."""
    P, L, poses, X, Xp, state, obs = _converging_problem()
    op, ol, ouv, our, ow, _ = tdist.partition_obs_by_landmark(*obs, L, n_dev)
    args = state + (op, ol, ouv, our, ow, INTR, np.float32(0.0))
    want = _jax_run(jdist.make_distributed_ba(_jax_mesh(n_dev), n_poses=P,
                                              n_points=L, iters=12), args)
    mesh = tdist.Mesh(["cpu"] * n_dev)
    assert mesh.size == n_dev
    got = _port_run(tdist.make_distributed_ba(mesh, n_poses=P, n_points=L,
                                              iters=12), args)
    np.testing.assert_allclose(got.kf_t, want.kf_t, atol=2e-3)
    np.testing.assert_allclose(got.points, want.points, atol=2e-2)
    assert abs(got.total_chi2 - want.total_chi2) < 0.01 * want.total_chi2
    for p in range(2, P):
        R_true, t_true = poses[p]
        assert rot_angle_deg(got.kf_R[p], R_true) < 0.1, p
        assert np.linalg.norm(got.kf_t[p] - t_true) < 0.01
    err0 = np.linalg.norm(Xp - X, axis=1).mean()
    assert np.linalg.norm(got.points - X, axis=1).mean() < 0.6 * err0


def test_distributed_ba_mesh_sizes_agree_and_repeat():
    """Shard counts 1 and 8 agree within test_dist_ba.py's cross-mesh
    tolerance; a second run on the same mesh repeats bit for bit; a mesh
    whose size does not divide the landmark count raises (the JAX step
    asserts it)."""
    P, L, _, _, _, state, obs = _converging_problem()
    res = []
    for n_dev in (1, 8, 8):
        op, ol, ouv, our, ow, _ = tdist.partition_obs_by_landmark(
            *obs, L, n_dev)
        ba = tdist.make_distributed_ba(tdist.Mesh(["cpu"] * n_dev),
                                       n_poses=P, n_points=L, iters=12)
        res.append(_port_run(ba, state + (op, ol, ouv, our, ow, INTR, 0.0)))
    np.testing.assert_allclose(res[0].kf_t, res[1].kf_t, atol=2e-3)
    np.testing.assert_allclose(res[0].points, res[1].points, atol=2e-2)
    for a, b in zip(res[1], res[2]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        tdist.make_distributed_ba(tdist.Mesh(["cpu"] * 3), n_poses=P,
                                  n_points=L)


def _cams():
    return (Camera.make(*INTR, 640, 480), jcam.Camera.make(*INTR, 640, 480))


def _mapper_map():
    """test_dist_ba.py's mapper map: 5 keyframes, 300 points, keyframes 1-4
    perturbed by 2 cm."""
    rng = np.random.default_rng(4)
    P, L = 5, 300
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4, 9, L)], 1).astype(np.float32)
    rng = np.random.default_rng(4)   # the map's draws restart the stream
    smap = SlamMap(max_kf=8, max_pt=1024, max_feat=512)
    ids = smap.alloc_points(L)
    smap.pt_xyz[ids] = X + rng.normal(0, 0.02, X.shape)
    smap.pt_valid[ids] = True
    for p in range(P):
        rng.standard_normal(3)       # the JAX test's unused rotation draw
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.25 * p, 0, 0], np.float32)
        Xc = X @ R.T + t
        uv = np.stack([INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2],
                       INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]], 1)
        uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
        inb = ((uv > 10).all(1) & (uv < [630, 470]).all(1))
        feats = {"uv": uv, "level": np.zeros(L, np.int32),
                 "angle": np.zeros(L, np.float32),
                 "desc": np.zeros((L, 256), np.uint8), "valid": inb}
        tp = t + (rng.normal(0, 0.02, 3) if p else 0)
        smap.add_keyframe(R, tp.astype(np.float32), feats)
        smap.bind(p, np.nonzero(inb)[0], ids[np.nonzero(inb)[0]])
    return smap, P, L


def test_mapper_global_ba_distributed_matches_dense_and_jax():
    """LocalMapper.global_ba with a 2-shard CPU mesh against the dense
    solve on the same map (test_dist_ba.py's bounds: both near the truth
    within 1 cm, keyframe translations within 2e-3, points within 2e-2),
    and against the JAX mapper's sharded global BA on a 2-device mesh."""
    smap, P, L = _mapper_map()
    dense, dist, jax_dist = (copy.deepcopy(smap) for _ in range(3))
    tcam, jc = _cams()
    mesh = tdist.Mesh(["cpu", "cpu"])
    mapper = LocalMapper(tcam, device="cpu", mesh=mesh)
    LocalMapper(tcam, device="cpu").global_ba(dense)
    mapper.global_ba(dist)
    jax_mapper = JaxMapper(jc, mesh=_jax_mesh(2))
    jax_mapper.global_ba(jax_dist)
    # the sharded step really ran, in the JAX mapper's (P, L, O_shard,
    # phases) bucket
    assert list(mapper._dist_ba_cache) == list(jax_mapper._dist_ba_cache)
    truth = np.stack([[0.25 * p, 0, 0] for p in range(P)])
    for m in (dense, dist, jax_dist):
        assert np.linalg.norm(m.kf_t[:P] - truth, axis=1).max() < 0.01
    for other in (dense, jax_dist):
        np.testing.assert_allclose(dist.kf_t[:P], other.kf_t[:P], atol=2e-3)
        np.testing.assert_allclose(dist.pt_xyz[:L], other.pt_xyz[:L],
                                   atol=2e-2)
        for k in range(P):
            assert rot_angle_deg(dist.kf_R[k], other.kf_R[k]) < 0.05, k


def _gating_problem():
    """test_dist_ba.py's outlier problem: half the edges stereo (bf 40),
    10% of the edges gross outliers (30-80 px)."""
    rng = np.random.default_rng(3)
    P, L, O = 4, 64, 1024
    bf = 40.0
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4, 9, L)], 1).astype(np.float32)
    poses = []
    for p in range(P):
        w = rng.standard_normal(3).astype(np.float32) * 0.02
        t = np.array([0.3 * p, 0.0, 0.0], np.float32)
        poses.append((np.asarray(jlie.so3_exp(jnp.asarray(w))), t))
    obs_p, obs_l, obs_uv, obs_ur = [], [], [], []
    for p, (R, t) in enumerate(poses):
        Xc = X @ R.T + t
        uv = np.stack([INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2],
                       INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]], 1)
        uv += rng.standard_normal(uv.shape).astype(np.float32) * 0.2
        ur = uv[:, 0] - bf / Xc[:, 2]
        inb = ((uv > 10).all(1) & (uv < [630, 470]).all(1))
        for li in np.nonzero(inb)[0]:
            obs_p.append(p)
            obs_l.append(li)
            obs_uv.append(uv[li])
            obs_ur.append(ur[li] if li % 2 == 0 else -1.0)
    n = len(obs_p)
    n_out = n // 10
    out_sel = rng.choice(n, n_out, replace=False)
    obs_uv = np.asarray(obs_uv, np.float32)
    obs_uv[out_sel] += rng.uniform(30, 80, (n_out, 2)).astype(np.float32)
    pad = O - n
    obs_p = np.array(list(obs_p) + [0] * pad, np.int32)
    obs_l = np.array(list(obs_l) + [0] * pad, np.int32)
    obs_uv = np.concatenate([obs_uv, np.zeros((pad, 2), np.float32)])
    obs_ur = np.array(list(obs_ur) + [-1.0] * pad, np.float32)
    obs_w = np.array([1.0] * n + [0.0] * pad, np.float32)
    Xp = X + rng.standard_normal(X.shape).astype(np.float32) * 0.05
    kf_R = np.stack([R for (R, t) in poses])
    kf_t = np.stack([t + rng.standard_normal(3).astype(np.float32) * 0.02
                     for (R, t) in poses])
    free = np.array([False, False] + [True] * (P - 2))
    return (P, L, bf, poses, (kf_R, kf_t, free, Xp, np.ones(L, bool)),
            (obs_p, obs_l, obs_uv, obs_w, obs_ur))


def test_dist_ba_outlier_gating_and_stereo_rows():
    """On 8 CPU shards: the phased chi2 drop suppresses the outliers
    against a single phase (test_dist_ba.py's bounds: gated chi2 < 5% of
    the single-phase one, rotations within 0.3 deg, translations within
    0.12 and no worse than the single phase), and the gated solve agrees
    with the JAX one on an 8-device mesh (translations within 2e-3, chi2
    within 1%)."""
    P, L, bf, poses, state, (obs_p, obs_l, obs_uv, obs_w, obs_ur) = \
        _gating_problem()
    op, ol, ouv, our, ow, _ = tdist.partition_obs_by_landmark(
        obs_p, obs_l, obs_uv, obs_w, L, 8, obs_ur=obs_ur)
    args = state + (op, ol, ouv, our, ow, INTR, np.float32(bf))
    mesh = tdist.Mesh(["cpu"] * 8)
    res = _port_run(tdist.make_distributed_ba(mesh, n_poses=P, n_points=L,
                                              phases=(5, 10)), args)
    res1 = _port_run(tdist.make_distributed_ba(mesh, n_poses=P, n_points=L,
                                               phases=(15,)), args)
    assert np.isfinite(res.total_chi2)
    assert res.total_chi2 < 0.05 * res1.total_chi2, \
        (res.total_chi2, res1.total_chi2)
    for p in range(2, P):
        R_true, t_true = poses[p]
        assert rot_angle_deg(res.kf_R[p], R_true) < 0.3, p
        e_gated = np.linalg.norm(res.kf_t[p] - t_true)
        e_raw = np.linalg.norm(res1.kf_t[p] - t_true)
        assert e_gated < 0.12, (p, e_gated)
        assert e_gated < e_raw + 1e-4, (e_gated, e_raw)
    want = _jax_run(jdist.make_distributed_ba(_jax_mesh(8), n_poses=P,
                                              n_points=L, phases=(5, 10)),
                    args)
    np.testing.assert_allclose(res.kf_t, want.kf_t, atol=2e-3)
    assert abs(res.total_chi2 - want.total_chi2) < 0.01 * want.total_chi2


def test_tracker_config_builds_the_mesh():
    """TrackerConfig(mesh_devices=2) on a CPU tracker: a 2-shard CPU mesh
    under its mapper; on a CUDA tracker with fewer cards than shards, the
    JAX package's ValueError."""
    cam = Camera.make(40.0, 40.0, 31.5, 23.5, 64, 48)
    tr = MonoTracker(cam, TrackerConfig(mesh_devices=2), device="cpu")
    mesh = tr.mapper.mesh
    assert mesh.size == 2 and mesh.group is None
    assert [d.type for d in mesh.devices] == ["cpu", "cpu"]
    assert MonoTracker(cam, TrackerConfig(mesh_devices=1),
                       device="cpu").mapper.mesh is None
    # the mono-VI tracker (VINS init runs a global BA) inherits it
    vi = MonoViTracker(cam, TrackerConfig(mesh_devices=4), device="cpu")
    assert vi.mapper.mesh.size == 4
    k = torch.cuda.device_count()
    if k < 2:
        with pytest.raises(ValueError,
                           match=f"mesh_devices=2 but only {k} devices "
                                 f"visible"):
            MonoTracker(cam, TrackerConfig(mesh_devices=2), device="cuda")
