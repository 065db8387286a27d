"""The octree keypoint mode of the torch port against the JAX reference:
select_octree, shi_tomasi_map, the extractor in mode "octree" and a
monocular VO run with TrackerConfig(keypoint_mode="octree")."""
import numpy as np
import jax.numpy as jnp
import pytest

from ygz_tpu.frontend.extractor import OrbExtractor as JaxExtractor
from ygz_tpu.ops import fast as jfast, image as jimage, select as jsel
from ygz_tpu_torch.frontend.extractor import OrbExtractor
from ygz_tpu_torch.frontend.tracker import TrackerConfig
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.ops import fast as tfast, image as timage, select as tsel
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import agree, assert_close, np_, render_u8, t_
from test_vo_e2e import make_trajectory

# test_torch_features.py's pyramids: 3 levels at 240x320 (level 3 would be
# shorter than the 31x31 IC-angle patch)
H, W, LEVELS = 240, 320, 3


@pytest.fixture(scope="module")
def pyramids():
    scene = SmoothScene(seed=4, w=W, h=H, f=200.0, tex_size=800)
    img = render_u8(scene, np.eye(3), np.zeros(3))
    return (jimage.build_pyramid(jnp.asarray(img), LEVELS),
            timage.build_pyramid(t_(img), LEVELS))


def _tied_scores(rng, shape):
    """Integer FAST-like scores with many ties, most pixels empty, some
    high-threshold corners (+1000, as the merged map has them)."""
    s = rng.integers(0, 8, shape).astype(np.float32)
    s *= rng.random(shape) > 0.7
    s += 1000.0 * ((s > 0) & (rng.random(shape) > 0.9))
    return s


@pytest.mark.parametrize("shape,budget", [((240, 320), 40), ((240, 320), 300),
                                          ((480, 752), 120),
                                          ((480, 752), 512)])
@pytest.mark.parametrize("with_occupancy", [False, True])
def test_select_octree_matches_jax(shape, budget, with_occupancy):
    rng = np.random.default_rng(shape[1] + budget + with_occupancy)
    score = _tied_scores(rng, shape)
    occ = rng.random(shape) > 0.85 if with_occupancy else None
    got = tsel.select_octree(t_(score), max_kp=budget, border=16,
                             occupancy=None if occ is None else t_(occ))
    want = jsel.select_octree(jnp.asarray(score), max_kp=budget, border=16,
                              occupancy=None if occ is None
                              else jnp.asarray(occ))
    # the stable top-k keeps lax.top_k's tie order: exact
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np.asarray(w))
    assert np_(got[2]).sum() > 0.9 * budget


def test_octree_selection_covers_and_concentrates():
    """Twin of test_ops_frontend.py's test: every textured coarse region
    keeps a corner (coverage) and the rest of the budget concentrates in
    the texture-dense half."""
    rng = np.random.default_rng(3)
    score = np.zeros((H, W), np.float32)
    for y in range(40, H - 40, 40):
        for x in range(40, W // 2 - 20, 40):
            score[y, x] = rng.uniform(1, 5)
    ys = rng.integers(30, H - 30, 300)
    xs = rng.integers(W // 2 + 10, W - 30, 300)
    score[ys, xs] = rng.uniform(1, 50, 300)

    uv, s, valid = tsel.select_octree(t_(score), max_kp=120, border=16)
    uv = np_(uv)[np_(valid)]
    assert len(uv) > 60
    left = uv[uv[:, 0] < W // 2 - 16]
    n_left = len(range(40, H - 40, 40)) * len(range(40, W // 2 - 20, 40))
    assert len(left) >= 0.8 * n_left, (len(left), n_left)
    assert len(uv[uv[:, 0] >= W // 2]) > 2 * len(left)
    for x, y in uv:
        assert score[int(y), int(x)] > 0


def test_shi_tomasi_map_matches_jax():
    rng = np.random.default_rng(5)
    scene = SmoothScene(seed=4, w=W, h=H, f=200.0, tex_size=800)
    for img in (render_u8(scene, np.eye(3), np.zeros(3)),
                rng.uniform(0, 255, (48, 64)).astype(np.float32)):
        for half_box in (2, 4):
            got = np_(tfast.shi_tomasi_map(t_(img), half_box))
            want = np.asarray(jfast.shi_tomasi_map(jnp.asarray(img),
                                                   half_box=half_box))
            assert got.shape == want.shape
            # the cumulative sums add in another order: float32 ulps of
            # the box sums, which reach ~1e5 on u8 gradients
            assert_close(got, want, atol=1e-5 * float(np.abs(want).max()))


def test_shi_tomasi_ranks_corner_over_edge():
    img = np.zeros((64, 64), np.float32)
    img[20:40, 20:40] = 200.0
    st = np_(tfast.shi_tomasi_map(t_(img)))
    corner = st[18:23, 18:23].max()
    edge = st[28:32, 19:22].max()
    flat = st[5:10, 5:10].max()
    assert corner > edge >= flat


def _hamming(a, b):
    return (np_(a).astype(np.int32) != np_(b).astype(np.int32)).sum(-1)


def test_octree_extractor_matches_jax(pyramids):
    pj, pt = pyramids
    fj = JaxExtractor(n_features=300, n_levels=LEVELS, mode="octree")(pj)
    ft = OrbExtractor(n_features=300, n_levels=LEVELS, mode="octree")(
        timage.stack_pyramid(pt))
    # one merged FAST map and exact selection: the keypoints agree exactly
    np.testing.assert_array_equal(np_(ft.uv), np.asarray(fj.uv))
    np.testing.assert_array_equal(np_(ft.level), np.asarray(fj.level))
    np.testing.assert_array_equal(np_(ft.valid), np.asarray(fj.valid))
    np.testing.assert_array_equal(np_(ft.score), np.asarray(fj.score))
    v = np_(ft.valid)
    assert v.sum() > 200
    assert_close(np_(ft.angle)[v], np.asarray(fj.angle)[v], atol=1e-4)
    # C5: the blur differs by <= 4.6e-5, so compare BRIEF by Hamming
    d = _hamming(ft.desc, fj.desc)[v]
    assert np.median(d) == 0 and np.percentile(d, 99) <= 8
    # the grid and octree selections differ on this frame
    grid = OrbExtractor(n_features=300, n_levels=LEVELS)(
        timage.stack_pyramid(pt))
    assert agree(grid.uv, ft.uv) < 0.9


def test_octree_extract_keyframe_matches_jax(pyramids):
    pj, pt = pyramids
    rng = np.random.default_rng(1)
    m = 128
    uv0 = rng.uniform(30, [W - 30, H - 30], (m, 2)).astype(np.float32)
    lvl = rng.integers(0, LEVELS, m).astype(np.int32)
    valid = rng.random(m) > 0.2
    aj, dj, fj = JaxExtractor(n_features=300, n_levels=LEVELS,
                              mode="octree").extract_keyframe(
        pj, uv0, lvl, valid)
    at, dt, ft = OrbExtractor(n_features=300, n_levels=LEVELS,
                              mode="octree").extract_keyframe(
        timage.stack_pyramid(pt), t_(uv0), t_(lvl), t_(valid))
    assert_close(at, aj, atol=1e-4)
    d = _hamming(dt, dj)
    assert np.median(d) == 0 and np.percentile(d, 99) <= 8
    # the occupancy around the tracked points passes through exactly
    np.testing.assert_array_equal(np_(ft.uv), np.asarray(fj.uv))
    np.testing.assert_array_equal(np_(ft.level), np.asarray(fj.level))
    np.testing.assert_array_equal(np_(ft.valid), np.asarray(fj.valid))
    fv = np_(ft.valid)
    assert_close(np_(ft.angle)[fv], np.asarray(fj.angle)[fv], atol=1e-4)
    d = _hamming(ft.desc, fj.desc)[fv]
    assert np.median(d) == 0 and np.percentile(d, 99) <= 8


def test_port_mono_vo_octree_keypoint_mode():
    """Twin of the slow tests/test_vo_e2e.py::
    test_mono_vo_octree_keypoint_mode: 25 frames of SmoothScene seed 7
    with TrackerConfig(keypoint_mode="octree")."""
    scene = SmoothScene(seed=7)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    system = System(cam, Sensor.MONOCULAR,
                    config=TrackerConfig(keypoint_mode="octree"),
                    device="cpu")
    assert system.tracker.extractor.mode == "octree"
    states = [system.track_monocular(scene.render(R, t), i * 0.05)[0]
              for i, (R, t) in enumerate(make_trajectory(25))]
    assert states[-1] == "OK", states[-8:]
    assert sum(s == "OK" for s in states) > 15
