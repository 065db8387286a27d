"""FAST-10 kernels of the torch port: the plain PyTorch versions against
the JAX reference and the interpret-mode Pallas kernel (exact), NMS, the
CUDA source's arithmetic (one arc value of one side for both thresholds,
sliding minimum) against the plain version, and the wrappers' device
dispatch. The
CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda.py (on a card only)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

from ygz_tpu.ops.fast import fast_score_map as jax_fast, nonmax_3x3 as jax_nms
from ygz_tpu.ops.pallas_fast import fast_score_map_pallas
from ygz_tpu_torch.frontend.extractor import OrbExtractor
from ygz_tpu_torch.ops import fast
from ygz_tpu_torch.ops.image import build_pyramid, stack_pyramid, stack_rows
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import np_, render_u8, t_


def _images():
    rng = np.random.default_rng(0)
    yield "rand96x160", rng.uniform(0, 255, (96, 160)).astype(np.float32)
    yield "rand101x137", rng.uniform(0, 255, (101, 137)).astype(np.float32)
    scene = SmoothScene(seed=3, w=320, h=240, f=200.0, tex_size=800)
    yield "render240x320", render_u8(scene, np.eye(3), np.zeros(3))


IMAGES = dict(_images())


# Exact equality: the plain version uses the reference's operations in its
# order (subtract, min, max, add; min/max are exact), so no tolerance.
@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("th", [20.0, 7.0])
def test_fast_plain_matches_jax_and_pallas(name, th):
    img = IMAGES[name]
    got = np_(fast.fast_score_map(t_(img), th))
    want = np.asarray(jax_fast(jnp.asarray(img), th))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(fast_score_map_pallas(jnp.asarray(img), th,
                                              interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert (got > 0).sum() > 50


def test_nonmax_3x3_matches_jax():
    img = IMAGES["render240x320"]
    score = np.asarray(jax_fast(jnp.asarray(img), 7.0))
    np.testing.assert_array_equal(np_(fast.nonmax_3x3(t_(score))),
                                  np.asarray(jax_nms(jnp.asarray(score))))


def test_wrapper_dispatch_on_cpu():
    img = t_(IMAGES["rand96x160"])
    before = fast.fast_score_map.launches
    out = fast.fast_score_map(img, 20.0)
    assert torch.equal(out, fast.fast_score_map_torch(img, 20.0))
    # a CPU tensor takes the plain version: no kernel launch counted
    assert fast.fast_score_map.launches == before
    with pytest.raises(TypeError):
        fast.fast_score_map(img.double(), 20.0)
    with pytest.raises(TypeError):
        fast.fast_score_map(img[None], 20.0)
    with pytest.raises(ValueError):
        fast.fast_score_map(img, -0.5)


# ------------------------------------------- the CUDA source's arithmetic
# A torch mirror of csrc/fast_score.cu: per pixel one arc value A' from the
# one side that can hold an arc of 10 (chosen by 4 opposite tap pairs), by
# the sliding minimum over the unrolled circle, the threshold applied last.
# It must give the plain version's bits at any threshold >= 0.

def _arc_value(img):
    d = torch.stack([fast._shift(img, dx, dy) for dx, dy in fast.CIRCLE]) \
        - img[None]
    bright = torch.minimum(d[0:8:2], d[8:16:2]).amax(0) > 0
    x = d * torch.where(bright, 1.0, -1.0)
    y = torch.cat([x, x[:9]])                 # y_j = x_{j mod 16}, j < 25
    best = None
    for start, n_win in ((0, 10), (10, 6)):
        # windows start .. start + n_win - 1: a suffix of y[start:start + 10]
        # and a prefix of what follows it
        suf = [y[start + 9]]
        for j in range(start + 8, start - 1, -1):
            suf.insert(0, torch.minimum(y[j], suf[0]))
        wins, pre = [suf[0]], None
        for k in range(1, n_win):
            tap = y[start + 9 + k]
            pre = tap if pre is None else torch.minimum(pre, tap)
            wins.append(torch.minimum(suf[k], pre))
        for w in wins:
            best = w if best is None else torch.maximum(best, w)
    return best


def _score_at(a, th, frame):
    s = a - th
    return torch.where(frame & (s > 0), s + th, torch.zeros_like(s))


def _frame(h, w):
    ys = torch.arange(h)[:, None]
    xs = torch.arange(w)[None, :]
    return (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)


def _mirror_score(img, th):
    return _score_at(_arc_value(img), th, _frame(*img.shape))


def _mirror_images():
    rng = np.random.default_rng(7)
    yield "uniform", rng.uniform(0, 255, (64, 80)).astype(np.float32)
    yield "integer_ties", rng.integers(0, 8, (64, 80)).astype(np.float32)
    yield "quarter_steps", (rng.integers(0, 1024, (64, 80)) / 4.0
                            ).astype(np.float32)
    yield "constant", np.full((64, 80), 128.0, np.float32)


MIRROR_IMAGES = dict(_mirror_images())


@pytest.mark.parametrize("name", sorted(MIRROR_IMAGES))
@pytest.mark.parametrize("th", [20.0, 7.0])
def test_one_arc_value_matches_plain_score(name, th):
    img = t_(MIRROR_IMAGES[name])
    assert torch.equal(_mirror_score(img, th),
                       fast.fast_score_map_torch(img, th))


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(img=hnp.arrays(np.float32,
                      hnp.array_shapes(min_dims=2, max_dims=2, min_side=6,
                                       max_side=24),
                      elements=st.floats(-1e4, 1e4, width=32)),
       scale=st.sampled_from([1e-3, 1.0, 1e3]),
       th=st.sampled_from([20.0, 7.0, 0.5, 0.0]))
def test_one_arc_value_matches_plain_score_hypothesis(img, scale, th):
    x = torch.as_tensor(img * np.float32(scale))
    assert torch.equal(_mirror_score(x, th), fast.fast_score_map_torch(x, th))


def _stacked(img, n_levels=4):
    levels = build_pyramid(t_(img), n_levels)
    return levels, stack_pyramid(levels)


def test_one_arc_value_matches_plain_corner_maps():
    """Both thresholds, the merge and the NMS from one A per pixel, as the
    fused kernel computes them, equal the plain corner maps."""
    levels, stack = _stacked(IMAGES["render240x320"])
    got = fast.fast_corner_maps_torch(stack, 240, 4, 20.0, 7.0)
    offs, _ = stack_rows(240, 320, 4)
    for o, lv in zip(offs, levels):
        h, w = lv.shape
        a, frame = _arc_value(lv), _frame(h, w)
        hi, lo = _score_at(a, 20.0, frame), _score_at(a, 7.0, frame)
        want = fast.nonmax_3x3(torch.where(hi > 0, hi + 1000.0, lo))
        assert torch.equal(got[o: o + h, :w], want)


@pytest.mark.parametrize("name", ["render240x320", "rand101x137"])
def test_corner_maps_plain_matches_jax_front(name):
    """The stacked front equals, level by level, the JAX extractor's:
    fast_score_map at 20 and 7 (and the interpret-mode Pallas kernel), the
    +1000 merge and nonmax_3x3; the pad columns are 0."""
    img = IMAGES[name]
    H, W = img.shape
    levels, stack = _stacked(img)
    got = np_(fast.fast_corner_maps_torch(stack, H, 4, 20.0, 7.0))
    offs, _ = stack_rows(H, W, 4)
    for o, lv in zip(offs, levels):
        h, w = lv.shape
        x = jnp.asarray(np_(lv))
        for score in (jax_fast, lambda im, th: fast_score_map_pallas(
                im, th, interpret=True)):
            hi, lo = score(x, 20.0), score(x, 7.0)
            want = jax_nms(jnp.where(hi > 0, hi + 1000.0, lo))
            np.testing.assert_array_equal(got[o: o + h, :w], np.asarray(want))
        assert not got[o: o + h, w:].any()
    assert (got > 1000.0).sum() > 50 and ((got > 0) & (got < 1000)).any()


def test_corner_maps_wrapper_dispatch_on_cpu():
    _, stack = _stacked(IMAGES["rand101x137"])
    before = (fast.fast_corner_maps.launches, fast.fast_score_map.launches)
    out = fast.fast_corner_maps(stack, 101, 4, 20.0, 7.0)
    assert torch.equal(out, fast.fast_corner_maps_torch(stack, 101, 4, 20.0,
                                                        7.0))
    # a CPU tensor takes the plain version: no kernel launch counted
    assert (fast.fast_corner_maps.launches,
            fast.fast_score_map.launches) == before
    with pytest.raises(TypeError):
        fast.fast_corner_maps(stack.double(), 101, 4, 20.0, 7.0)
    with pytest.raises(TypeError):
        fast.fast_corner_maps(stack[None], 101, 4, 20.0, 7.0)
    with pytest.raises(ValueError):            # rows of another layout
        fast.fast_corner_maps(stack[:-1], 101, 4, 20.0, 7.0)
    with pytest.raises(ValueError):            # not contiguous
        fast.fast_corner_maps(stack.t().contiguous().t(), 101, 4, 20.0, 7.0)
    with pytest.raises(NotImplementedError):   # C-ref3: factor 2.0 only
        fast.fast_corner_maps(stack, 101, 4, 20.0, 7.0, scale_factor=1.2)
    with pytest.raises(ValueError):            # a FAST threshold is >= 0
        fast.fast_corner_maps(stack, 101, 4, 20.0, -1.0)


def test_extractor_runs_one_corner_front_per_call(monkeypatch):
    calls = []
    real = fast.fast_corner_maps

    def counted(*args, **kw):
        calls.append(args[1:3])
        return real(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("the extractor ran the single-threshold map")

    monkeypatch.setattr(fast, "fast_corner_maps", counted)
    monkeypatch.setattr(fast, "fast_score_map", refused)
    levels, stack = _stacked(IMAGES["render240x320"], 3)
    ex = OrbExtractor(n_features=300, n_levels=3)
    a, b = ex(stack), ex(levels)
    assert calls == [(240, 3), (240, 3)]
    for f, g in zip(a, b):
        assert torch.equal(f, g)
    assert int(a.valid.sum()) > 200
