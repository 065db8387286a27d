"""ORB extraction, keypoint selection, descriptor matching and the two-view
initializer of the torch port against the JAX reference."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_tpu.frontend.extractor import OrbExtractor as JaxExtractor
from ygz_tpu.geometry import twoview as jtv
from ygz_tpu.ops import image as jimage, matching as jm, select as jsel
from ygz_tpu_torch.frontend.extractor import OrbExtractor, level_budgets
from ygz_tpu_torch.geometry import twoview as ttv
from ygz_tpu_torch.geometry.lie import so3_exp
from ygz_tpu_torch.ops import image as timage, matching as tm, select as tsel
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import agree, assert_close, np_, render_u8, rot_angle_deg, t_

H, W = 240, 320
# 3 levels at 240x320: the reference's 31x31 IC-angle patch needs a level
# at least 31 rows high, and level 3 would have 30
LEVELS = 3


@pytest.fixture(scope="module")
def pyramids():
    scene = SmoothScene(seed=4, w=W, h=H, f=200.0, tex_size=800)
    img = render_u8(scene, np.eye(3), np.zeros(3))
    return (jimage.build_pyramid(jnp.asarray(img), LEVELS),
            timage.build_pyramid(t_(img), LEVELS))


def _hamming(a, b):
    return (np_(a).astype(np.int32) != np_(b).astype(np.int32)).sum(-1)


@pytest.mark.parametrize("shape,n", [((480, 752), 512), ((240, 320), 300),
                                     ((480, 752), 10), ((48, 64), 10000)])
def test_cell_size_for_budget_matches_jax(shape, n):
    # covers both clamps ([8, 64]) and the unclamped EuRoC level-0 budget
    assert tsel.cell_size_for_budget(*shape, n) == \
        jsel.cell_size_for_budget(*shape, n)


def test_select_grid_topk_ties_match_jax():
    """Integer scores with many ties: the stable top-k keeps lax.top_k's
    lower-index-first order, so the selection is identical."""
    rng = np.random.default_rng(0)
    score = rng.integers(0, 6, (H, W)).astype(np.float32)
    occ = rng.random((H, W)) > 0.8
    uj, sj, vj = jsel.select_grid_topk(jnp.asarray(score), cell=16,
                                       max_per_cell=3, max_kp=300, border=10,
                                       occupancy=jnp.asarray(occ))
    ut, st, vt = tsel.select_grid_topk(t_(score), cell=16, max_per_cell=3,
                                       max_kp=300, border=10,
                                       occupancy=t_(occ))
    np.testing.assert_array_equal(np_(ut), np.asarray(uj))
    np.testing.assert_array_equal(np_(st), np.asarray(sj))
    np.testing.assert_array_equal(np_(vt), np.asarray(vj))
    uv = rng.uniform(0, [W, H], (50, 2)).astype(np.float32)
    valid = rng.random(50) > 0.3
    np.testing.assert_array_equal(
        np_(tsel.stamp_occupancy(H, W, t_(uv), t_(valid), 4)),
        np.asarray(jsel.stamp_occupancy(H, W, jnp.asarray(uv),
                                        jnp.asarray(valid), 4)))


def test_extractor_matches_jax(pyramids):
    pj, pt = pyramids
    fj = JaxExtractor(n_features=300, n_levels=LEVELS)(pj)
    ft = OrbExtractor(n_features=300, n_levels=LEVELS)(
        timage.stack_pyramid(pt))
    assert level_budgets(512, 4, 2.0) == JaxExtractor().budgets
    # FAST, NMS and the stable top-k are exact, so the keypoint sets agree;
    # >= 99% leaves room for a float tie that the blur could not break
    assert agree(ft.valid, fj.valid) >= 0.99
    assert agree(ft.level, fj.level) >= 0.99
    same = np.all(np_(ft.uv) == np.asarray(fj.uv), 1) & np_(ft.valid)
    assert same.mean() >= 0.99 * np_(ft.valid).mean()
    assert np_(ft.valid).sum() > 200
    # BRIEF rounds rotated test points: an angle differing in its last bit
    # can move a test, so compare by Hamming distance
    d = _hamming(ft.desc, fj.desc)[same]
    assert np.median(d) == 0 and np.percentile(d, 99) <= 8
    assert_close(np_(ft.angle)[same], np.asarray(fj.angle)[same], atol=1e-4)


def test_extract_keyframe_matches_jax(pyramids):
    pj, pt = pyramids
    rng = np.random.default_rng(1)
    m = 128
    uv0 = rng.uniform(30, [W - 30, H - 30], (m, 2)).astype(np.float32)
    lvl = rng.integers(0, 3, m).astype(np.int32)
    valid = rng.random(m) > 0.2
    aj, dj, fj = JaxExtractor(n_features=300,
                              n_levels=LEVELS).extract_keyframe(
        pj, uv0, lvl, valid)
    at, dt, ft = OrbExtractor(n_features=300,
                              n_levels=LEVELS).extract_keyframe(
        timage.stack_pyramid(pt), t_(uv0), t_(lvl), t_(valid))
    assert_close(at, aj, atol=1e-4)
    d = _hamming(dt, dj)
    assert np.median(d) == 0 and np.percentile(d, 99) <= 8
    assert agree(ft.valid, fj.valid) >= 0.99
    assert agree(ft.uv, fj.uv) >= 0.99


def _descs(rng, n1=200, n2=220):
    a = (rng.random((n1, 256)) > 0.5).astype(np.uint8)
    b = (rng.random((n2, 256)) > 0.5).astype(np.uint8)
    # 150 true matches with a few flipped bits
    for i in range(150):
        row = a[i].copy()
        row[rng.choice(256, rng.integers(0, 25), replace=False)] ^= 1
        b[(i * 7) % n2] = row
    return a, b


def test_matching_matches_jax():
    rng = np.random.default_rng(2)
    a, b = _descs(rng)
    va = rng.random(len(a)) > 0.05
    vb = rng.random(len(b)) > 0.05
    uva = rng.uniform(0, 300, (len(a), 2)).astype(np.float32)
    uvb = rng.uniform(0, 300, (len(b), 2)).astype(np.float32)
    anga = rng.uniform(-np.pi, np.pi, len(a)).astype(np.float32)
    angb = rng.uniform(-np.pi, np.pi, len(b)).astype(np.float32)
    for i in range(150):          # the true matches of _descs
        j = (i * 7) % len(b)
        uvb[j] = uva[i] + rng.normal(0, 3, 2)
        angb[j] = anga[i] + rng.normal(0, 0.05)
    # Hamming distances are exact integers in float32 (TF32 off)
    np.testing.assert_array_equal(
        np_(tm.hamming_matrix(t_(a), t_(b), t_(va), t_(vb))),
        np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(va), jnp.asarray(vb))))
    for kw in (dict(), dict(radius=20.0, mutual=True),
               dict(radius=50.0, ang=True, mutual=True),
               dict(ang=True, max_dist=tm.TH_HIGH, ratio=0.7)):
        kw = dict(kw)
        ang = kw.pop("ang", False)
        rad = kw.get("radius")
        ij, okj = jm.match_with_windows(
            jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
            uv_pred1=jnp.asarray(uva) if rad else None,
            uv2=jnp.asarray(uvb) if rad else None,
            ang1=jnp.asarray(anga) if ang else None,
            ang2=jnp.asarray(angb) if ang else None, **kw)
        it, okt = tm.match_with_windows(
            t_(a), t_(va), t_(b), t_(vb), uv_pred1=t_(uva) if rad else None,
            uv2=t_(uvb) if rad else None, ang1=t_(anga) if ang else None,
            ang2=t_(angb) if ang else None, **kw)
        np.testing.assert_array_equal(np_(it), np.asarray(ij))
        np.testing.assert_array_equal(np_(okt), np.asarray(okj))
        assert np_(okt).sum() > 50
    # batched form (the fuse stage): T targets at once
    ij, okj = jm.match_with_windows_batch(
        jnp.asarray(np.stack([a, a])), jnp.asarray(np.stack([va, va])),
        jnp.asarray(np.stack([b, b[::-1]])), jnp.asarray(np.stack([vb, vb])),
        jnp.asarray(np.stack([uva, uva])),
        jnp.asarray(np.stack([uvb, uvb[::-1]])), radius=20.0)
    it, okt = tm.match_with_windows_batch(
        t_(np.stack([a, a])), t_(np.stack([va, va])),
        t_(np.stack([b, b[::-1]])), t_(np.stack([vb, vb])),
        t_(np.stack([uva, uva])), t_(np.stack([uvb, uvb[::-1]])),
        radius=20.0)
    np.testing.assert_array_equal(np_(it), np.asarray(ij))
    np.testing.assert_array_equal(np_(okt), np.asarray(okj))


def test_distinctive_descriptors_matches_jax():
    rng = np.random.default_rng(3)
    base = (rng.random((64, 1, 256)) > 0.5).astype(np.uint8)
    stack = np.repeat(base, 8, 1)
    flips = rng.random(stack.shape) < 0.08
    stack = (stack ^ flips).astype(np.uint8)
    valid = rng.random((64, 8)) > 0.3
    packed = np.packbits(stack, axis=-1)
    bj, dj = jm.distinctive_descriptors_packed(jnp.asarray(packed),
                                               jnp.asarray(valid))
    bt, dt = tm.distinctive_descriptors_packed(t_(packed), t_(valid))
    np.testing.assert_array_equal(np_(bt), np.asarray(bj))
    np.testing.assert_array_equal(np_(dt), np.asarray(dj))


def _two_view_scene(seed=5, n=300, planar=False):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 8, n)], 1).astype(np.float32)
    if planar:
        X[:, 2] = 5.0 + 0.2 * X[:, 0]
    R = np_(so3_exp(t_(np.array([0.02, -0.05, 0.01], np.float32))))
    t = np.array([-0.4, 0.05, 0.02], np.float32)
    K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)

    def proj(R_, t_v):
        Xc = X @ R_.T + t_v
        return (Xc[:, :2] / Xc[:, 2:] * 400 + [320, 240]).astype(np.float32)

    p1 = proj(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    p2 = proj(R, t) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    p2[:20] += rng.uniform(20, 40, (20, 2)).astype(np.float32)   # outliers
    mask = rng.random(n) > 0.05
    return X, R, t, K, p1, p2, mask, rng


def _unit(M):
    M = np_(M).astype(np.float64).reshape(-1)
    M = M / np.linalg.norm(M)
    return M * np.sign(M[np.argmax(np.abs(M))])


@pytest.mark.parametrize("model", ["homography", "fundamental"])
def test_twoview_sample_fits_match_jax(model):
    """fit_homography / fit_fundamental on injected samples of noise-free
    matches (a planar scene for H, a general one for F), each fit then
    scored against every match, as the RANSAC scores it. F uses 24-point
    samples: the 8-point F null vector sits only 1e-8..1e-5 of the spectrum
    below the next eigenvalue, finer than either float32 eigensolver
    resolves, while 24 points open the gap to ~1e-4."""
    planar = model == "homography"
    X, R, t, K, p1, _, mask, rng = _two_view_scene(planar=planar)
    Xc2 = X @ R.T + t
    p2c = (Xc2[:, :2] / Xc2[:, 2:] * 400 + [320, 240]).astype(np.float32)
    p1n, T1 = jtv.normalize_points(jnp.asarray(p1), jnp.asarray(mask))
    p2n, T2 = jtv.normalize_points(jnp.asarray(p2c), jnp.asarray(mask))
    tp1n, tT1 = ttv.normalize_points(t_(p1), t_(mask))
    tp2n, tT2 = ttv.normalize_points(t_(p2c), t_(mask))
    # normalization: a mean and a mean-absolute-deviation in float32
    assert_close(tp1n, p1n, atol=1e-5)
    assert_close(tp2n, p2n, atol=1e-5)
    assert_close(tT2, T2, rtol=1e-5, atol=1e-5)
    jfit, tfit = ((jtv.fit_homography, ttv.fit_homography) if planar
                  else (jtv.fit_fundamental, ttv.fit_fundamental))
    jden, tden = ((jtv._denorm_h, ttv._denorm_h) if planar
                  else (jtv._denorm_f, ttv._denorm_f))
    jscore, tscore = ((jtv.score_homography, ttv.score_homography) if planar
                      else (jtv.score_fundamental, ttv.score_fundamental))
    k = 8 if planar else 24
    idx = np.stack([rng.choice(300, k, replace=False) for _ in range(6)])
    # the port fits all samples as one batch, as its RANSAC does
    Mt = tden(tfit(tp1n[t_(idx)], tp2n[t_(idx)]), tT1, tT2)
    st, it = tscore(Mt, t_(p1), t_(p2c), t_(mask))
    for i, s in enumerate(idx):
        mj = jden(jfit(p1n[s], p2n[s]), T1, T2)
        sj, ij = jscore(mj, jnp.asarray(p1), jnp.asarray(p2c),
                        jnp.asarray(mask))
        # smallest eigenvector of a float32 9x9 normal matrix: its error is
        # ~eps * spectrum / gap, ~1e-4 for H and ~1e-3 for F (unit vectors)
        assert_close(_unit(Mt[i]), _unit(mj), atol=2e-3 if planar else 2e-2)
        # scores within 2%, inlier sets 97% equal
        assert abs(float(st[i]) - float(sj)) <= 0.02 * abs(float(sj))
        assert agree(it[i], ij) >= 0.97


def _same_hypotheses(Rt, tt, Rj, tj):
    """The same set of (R, t) hypotheses: SVD sign choices may order the
    rotations differently in the two packages."""
    Rj, tj = np.asarray(Rj), np.asarray(tj)
    for a, b in zip(np_(Rt), np_(tt)):
        d = [rot_angle_deg(a, r) + 1e3 * np.abs(b - s).max()
             for r, s in zip(Rj, tj)]
        assert min(d) < 1e-2, d


def test_twoview_scores_and_hypotheses_match_jax():
    X, R, t, K, p1, p2, mask, rng = _two_view_scene()
    Hj = jtv.fit_homography(jnp.asarray(p1[20:]), jnp.asarray(p2[20:]))
    Fj = jtv.fit_fundamental(jnp.asarray(p1[20:]), jnp.asarray(p2[20:]))
    # the same model scored by both: per-match float32 transfer / epipolar
    # errors summed in another order
    for jscore, tscore, M in ((jtv.score_homography, ttv.score_homography,
                               Hj),
                              (jtv.score_fundamental, ttv.score_fundamental,
                               Fj)):
        sj, ij = jscore(M, jnp.asarray(p1), jnp.asarray(p2),
                        jnp.asarray(mask))
        st, it = tscore(t_(np.asarray(M)), t_(p1), t_(p2), t_(mask))
        assert_close(st, sj, rtol=1e-4, atol=0)
        assert agree(it, ij) >= 0.99
    Kt = t_(K)
    _same_hypotheses(*ttv._motion_hypotheses_from_F(t_(np.asarray(Fj)), Kt),
                     *jtv._motion_hypotheses_from_F(Fj, jnp.asarray(K)))
    _same_hypotheses(*ttv._motion_hypotheses_from_H(t_(np.asarray(Hj)), Kt),
                     *jtv._motion_hypotheses_from_H(Hj, jnp.asarray(K)))


def test_two_view_reconstruct_succeeds_like_jax():
    """The RANSAC draws differ (torch.Generator vs jax.random), so the two
    packages are judged by outcome: both accept, and both recover the
    motion and the structure up to scale."""
    X, R, t, K, p1, p2, mask, _ = _two_view_scene(seed=6)
    rj = jtv.two_view_reconstruct(jnp.asarray(p1), jnp.asarray(p2),
                                  jnp.asarray(mask), jnp.asarray(K),
                                  jax.random.PRNGKey(0))
    g = torch.Generator().manual_seed(0)
    rt = ttv.two_view_reconstruct(t_(p1), t_(p2), t_(mask), t_(K), g)
    assert bool(rj.ok) and bool(rt.ok)
    assert bool(rt.used_h) == bool(rj.used_h)
    assert rot_angle_deg(rt.R, R) < 0.2
    t_dir = t / np.linalg.norm(t)
    assert np.dot(np_(rt.t), t_dir) > 0.99
    good = np_(rt.good)
    assert abs(good.sum() - int(rj.n_good)) <= 0.05 * good.sum()
    # structure up to the monocular scale: fix it by the median depth
    Xt = np_(rt.points)[good]
    s = np.median(X[good][:, 2]) / np.median(Xt[:, 2])
    err = np.linalg.norm(Xt * s - X[good], axis=1)
    assert np.median(err) < 0.02 * np.median(X[:, 2])
