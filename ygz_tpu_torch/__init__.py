"""ygz_tpu_torch — the PyTorch / CUDA port of the ygz_tpu SLAM engine.

The JAX package ``ygz_tpu`` is the reference: every module here mirrors its
twin's path, fixed capacities, packed layouts and validity masks so the two
can be compared entry for entry. This package imports ``torch`` and never
``jax`` (nor ``ygz_tpu``, whose ``__init__`` imports jax).

The monocular VO main path is ported: ``System.track_monocular`` ->
``MonoTracker.track`` -> the fused frame step, ORB extraction, two-view
init and the keyframe mapping tail. Its one hand-written kernel is the
FAST-10 score map (``ops/fast.py`` + ``csrc/fast_score.cu``), launched for
CUDA tensors; CPU tensors take the plain PyTorch version.
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM's normal equations (6x6 / Schur solves, patch Hessians) need true
# float32 — the JAX package pins f32 matmuls because bf16 passes lost 60% of
# frames on its bench. TF32 keeps a 10-bit mantissa: it would perturb those
# solves and break the exact Hamming distances of the +-1 descriptor matmul
# (ops/matching.py). Pin both matmul and cuDNN to full float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
