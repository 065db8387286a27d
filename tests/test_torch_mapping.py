"""Keyframe-tail numerics of the torch port against the JAX reference:
ref-patch capture, direct subpixel re-matching, epipolar matching +
triangulation between two keyframes, and the fused multi-partner
triangulation."""
import numpy as np
import jax.numpy as jnp
import pytest

from ygz_tpu.backend import mapping as jmap
from ygz_tpu.frontend import direct_tracker as jdt
from ygz_tpu.frontend.extractor import OrbExtractor as JaxExtractor
from ygz_tpu.ops import image as jimage
from ygz_tpu_torch.backend import mapping as tmap
from ygz_tpu_torch.frontend import direct_tracker as tdt
from ygz_tpu_torch.geometry.lie import so3_exp
from ygz_tpu_torch.ops import image as timage
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import agree, assert_close, np_, render_u8, t_

H, W, F = 240, 320, 200.0
LEVELS = 3   # the reference's 31x31 IC-angle patch needs >= 31 rows/level
K = np.array([[F, 0, W / 2 - 0.5], [0, F, H / 2 - 0.5], [0, 0, 1]],
             np.float32)
INTR = (F, F, W / 2 - 0.5, H / 2 - 0.5)


@pytest.fixture(scope="module")
def two_kfs():
    scene = SmoothScene(seed=2, w=W, h=H, f=F, tex_size=1200)
    RA = np.eye(3, dtype=np.float32)
    tA = np.zeros(3, np.float32)
    RB = np_(so3_exp(t_(np.array([0.01, -0.03, 0.0], np.float32))))
    tB = (-RB @ np.array([0.25, 0.03, 0.0], np.float32)).astype(np.float32)
    imgs = [render_u8(scene, RA, tA), render_u8(scene, RB, tB)]
    pyrs = [jimage.build_pyramid(jnp.asarray(im), LEVELS) for im in imgs]
    ext = JaxExtractor(n_features=400, n_levels=LEVELS)
    feats = [ext(p) for p in pyrs]
    stacks = [np.asarray(jimage.stack_pyramid(p)) for p in pyrs]
    return scene, (RA, tA), (RB, tB), stacks, feats


def test_capture_ref_patches_matches_jax(two_kfs):
    _, _, _, stacks, feats = two_kfs
    uv = np.asarray(feats[0].uv)
    lvl = np.asarray(feats[0].level)
    # plus points at the level edges, where the capture bleeds (C-ref1)
    edge = np.array([[W - 3, 50], [100, H - 2], [W - 1, H - 1]], np.float32)
    uv = np.concatenate([uv, edge, edge, edge])
    lvl = np.concatenate([lvl, np.repeat(np.arange(LEVELS), 3)]).astype(
        np.int32)
    want = np.asarray(jdt.capture_ref_patches(
        jnp.asarray(stacks[0]), jnp.asarray(uv), jnp.asarray(lvl),
        n_levels=LEVELS))
    got = np_(tdt.capture_ref_patches_core(t_(stacks[0]), t_(uv), t_(lvl),
                                           LEVELS))
    # the same float ops, but XLA's CPU backend may contract the bilinear
    # blend's multiply-add into an FMA: 1 ulp of the 0..255 range
    assert_close(got, want, atol=1e-4)


def test_epipolar_match_and_triangulate_matches_jax(two_kfs):
    _, (RA, tA), (RB, tB), _, feats = two_kfs
    fa, fb = feats
    args = (fa.desc, fa.uv, fa.level, fa.valid, fb.desc, fb.uv, fb.level,
            fb.valid, RA, tA, RB, tB, K)
    ij, gj, Xj = jmap.match_epipolar_and_triangulate(
        *(jnp.asarray(np.asarray(a)) for a in args), jnp.float32(5.0),
        jnp.asarray(np.asarray(fa.angle)), jnp.asarray(np.asarray(fb.angle)))
    it, gt, Xt = tmap._epipolar_match_core(
        *(t_(np.asarray(a)) for a in args), 5.0,
        t_(np.asarray(fa.angle)), t_(np.asarray(fb.angle)))
    # Hamming distances are exact; the epipolar gate compares a float32
    # point-line distance with 3.84 sigma^2, so a pair on the gate may flip
    assert agree(it, ij) >= 0.99
    assert agree(gt, gj) >= 0.99
    both = np_(gt) & np.asarray(gj)
    assert both.sum() > 50
    # DLT in float32 through a 4x4 eigensolver: 1e-4 relative of depth
    assert_close(np_(Xt)[both], np.asarray(Xj)[both], atol=2e-3, rtol=1e-3)


def test_refine_matches_direct_matches_jax(two_kfs):
    scene, (RA, tA), (RB, tB), stacks, feats = two_kfs
    fa = feats[0]
    valid = np.asarray(fa.valid)
    uvA = np.asarray(fa.uv)
    lvlA = np.asarray(fa.level)
    X = scene.backproject(RA, tA, uvA)
    patches = np.asarray(jdt.capture_ref_patches(
        jnp.asarray(stacks[0]), jnp.asarray(uvA), jnp.asarray(lvlA),
        n_levels=LEVELS))
    n = len(uvA)
    RA_n = np.tile(RA, (n, 1, 1))
    tA_n = np.tile(tA, (n, 1))
    args = (X, valid, patches, uvA, lvlA, RA_n, tA_n)
    uj, okj = jdt.refine_matches_direct(
        jnp.asarray(stacks[1]), jnp.asarray(RB), jnp.asarray(tB),
        *(jnp.asarray(a) for a in args), INTR, n_levels=LEVELS)
    ut, okt = tdt.refine_matches_core(
        t_(stacks[1]), t_(RB), t_(tB), *(t_(a) for a in args), INTR,
        n_levels=LEVELS)
    # KLT convergence at 0.03 px steps may flip for a borderline point
    assert agree(okt, okj) >= 0.99
    both = np_(okt) & np.asarray(okj)
    assert both.sum() > 0.5 * valid.sum()
    # bilinear warp by direct gather vs the reference's hat-weight matmuls,
    # then 10 float32 KLT steps: 2e-3 px
    assert_close(np_(ut)[both], np.asarray(uj)[both], atol=2e-3)


def test_triangulate_multi_matches_jax(two_kfs):
    """The fused multi-partner triangulation with one live partner and one
    empty slot (the reference pads empty slots with A's rows, masked)."""
    _, (RA, tA), (RB, tB), stacks, feats = two_kfs
    fa, fb = (jax_f._asdict() for jax_f in feats)
    a = {k: np.asarray(v) for k, v in fa.items()}
    b = {k: np.asarray(v) for k, v in fb.items()}
    unA = a["valid"]
    validB = np.stack([b["valid"], np.zeros_like(b["valid"])])
    ij, gj, Xj = jmap._triangulate_multi_jit(
        jnp.asarray(a["desc"]), jnp.asarray(a["uv"]), jnp.asarray(a["level"]),
        jnp.asarray(unA), jnp.asarray(a["angle"]), jnp.asarray(RA),
        jnp.asarray(tA), jnp.asarray(stacks[0]),
        (jnp.asarray(b["desc"]), jnp.asarray(a["desc"])),
        (jnp.asarray(b["uv"]), jnp.asarray(a["uv"])),
        (jnp.asarray(b["level"]), jnp.asarray(a["level"])),
        jnp.asarray(validB),
        (jnp.asarray(b["angle"]), jnp.asarray(a["angle"])),
        jnp.asarray(np.stack([RB, np.eye(3, dtype=np.float32)])),
        jnp.asarray(np.stack([tB, np.zeros(3, np.float32)])),
        (jnp.asarray(stacks[1]), jnp.asarray(stacks[0])),
        jnp.asarray([True, False]), jnp.asarray(K), jnp.float32(5.0),
        n_levels=LEVELS)
    partner = {"desc": t_(b["desc"]), "uv": t_(b["uv"]),
               "level": t_(b["level"]), "valid": t_(b["valid"]),
               "angle": t_(b["angle"]), "R": t_(RB), "t": t_(tB),
               "pyr": t_(stacks[1])}
    it, gt, Xt = tmap._triangulate_multi(
        t_(a["desc"]), t_(a["uv"]), t_(a["level"]), t_(unA), t_(a["angle"]),
        t_(RA), t_(tA), t_(stacks[0]), [partner, None], t_(K),
        tuple(float(K[i, j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2))),
        5.0, LEVELS)
    # matching gates and the KLT convergence test may flip a borderline
    # candidate; the empty slot accepts nothing in either package
    assert agree(gt[0], gj[0]) >= 0.99
    assert not np_(gt[1]).any() and not np.asarray(gj[1]).any()
    both = np_(gt[0]) & np.asarray(gj[0])
    assert both.sum() > 30
    np.testing.assert_array_equal(np_(it[0])[both], np.asarray(ij[0])[both])
    # re-triangulated from subpixel-refined B matches: float32 DLT
    assert_close(np_(Xt[0])[both], np.asarray(Xj[0])[both], atol=2e-3,
                 rtol=1e-3)
