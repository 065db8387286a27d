"""ygz_tpu_torch — the PyTorch / CUDA port of the ygz_tpu SLAM engine.

The JAX package ``ygz_tpu`` is the reference: every module here mirrors its
twin's path, fixed capacities, packed layouts and validity masks so the two
can be compared entry for entry. This package imports ``torch`` and never
``jax`` (nor ``ygz_tpu``, whose ``__init__`` imports jax).

The JAX package's default monocular configuration is ported:
``System.track_monocular`` -> ``MonoTracker.track`` -> the fused frame
step, ORB extraction, two-view init, the keyframe mapping tail, BoW place
recognition, relocalization (EPnP RANSAC) and loop closing (Sim3, essential
graph, global BA), batched tracking (``System.track_monocular_batch``)
and the async mapping worker; on the card the frame step is replayed as a
captured CUDA graph. Its hand-written kernel source is the FAST-10 one
(``csrc/fast_score.cu``, wrappers in ``ops/fast.py``): the extractor's
front (both thresholds, merge, 3x3 NMS over the whole stacked pyramid in
one launch) and the single-threshold score map, launched for CUDA tensors;
CPU tensors take the plain PyTorch versions.
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
