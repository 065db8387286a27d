"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card. Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Without a CUDA device every test skips."""
import numpy as np
import pytest
import torch

from ygz_tpu_torch.ops import fast
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import render_u8

# the main path's pyramid levels (EuRoC 752x480, 4 levels, factor 2) and
# ragged shapes that leave partial tiles on both axes
SHAPES = [(480, 752), (240, 376), (120, 188), (60, 94), (101, 137), (7, 9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_fast_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    imgs = [rng.uniform(0, 255, shape).astype(np.float32),
            rng.integers(0, 256, shape).astype(np.float32)]
    if shape == SHAPES[0]:
        scene = SmoothScene(seed=11, w=shape[1], h=shape[0], f=458.0,
                            tex_size=2000)
        imgs.append(render_u8(scene, np.eye(3), np.zeros(3)))
    for img in imgs:
        x = torch.as_tensor(img, device=cuda)
        for th in (20.0, 7.0):
            before = fast.fast_score_map.launches
            got = fast.fast_score_map(x, th)
            assert fast.fast_score_map.launches == before + 1
            torch.cuda.synchronize()
            # the same float ops in the same order (no multiply): bit-exact
            assert torch.equal(got, fast.fast_score_map_torch(x, th))


@pytest.mark.cuda
def test_fast_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    x = torch.zeros(64, 96, device=cuda)
    with pytest.raises(ValueError):
        fast.fast_score_map(x.t(), 20.0)          # not contiguous
    with pytest.raises(TypeError):
        fast.fast_score_map(x.half(), 20.0)
