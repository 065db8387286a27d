"""Shared helpers of the torch-port parity tests (tests/test_torch_*.py).

Each parity test makes its inputs with numpy from a seed, feeds the same
arrays to the JAX reference (``ygz_tpu``) and to its port
(``ygz_tpu_torch``), and compares the outputs as numpy arrays.
"""
import numpy as np
import torch

from ygz_tpu_torch.eval.ate import rotation_angle_deg

# Tier-1 runs several pytest workers on one host: keep each one's torch
# thread pool small.
torch.set_num_threads(2)


def np_(x):
    """numpy view of a jax array, a torch tensor or a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_(x, dtype=None):
    """CPU torch tensor of a numpy (or jax) array."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def agree(a, b) -> float:
    """Share of equal entries of two boolean or integer arrays."""
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a == b).mean()) if a.size else 1.0


def assert_close(a, b, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np_(a), np_(b), atol=atol, rtol=rtol,
                               err_msg=what)


def rot_angle_deg(Ra, Rb) -> float:
    """Angle of Ra Rb^T in degrees (float64, any array type)."""
    return rotation_angle_deg(np_(Ra), np_(Rb))


def render_u8(scene, R, t):
    """Integer-valued frame (a camera's u8 image, as float32)."""
    return scene.render_u8(R, t).astype(np.float32)
