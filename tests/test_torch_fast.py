"""FAST-10 score kernel of the torch port: the plain PyTorch version against
the JAX reference and the interpret-mode Pallas kernel (exact), NMS and the
wrapper's device dispatch. The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda.py (on a card only)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_tpu.ops.fast import fast_score_map as jax_fast, nonmax_3x3 as jax_nms
from ygz_tpu.ops.pallas_fast import fast_score_map_pallas
from ygz_tpu_torch.ops import fast
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
