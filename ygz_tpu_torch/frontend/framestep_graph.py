"""The frame step captured once as a CUDA graph and replayed per frame.

The JAX package compiles ``frame_step`` into one ``jit`` dispatch per frame
(``ygz_tpu/frontend/framestep.py:236-295``). Eager PyTorch issues the same
step as ~21,000 small kernels, each launched by the host, so the host's
issue rate bounds it. A CUDA graph is the port's counterpart of the ``jit``:
``frame_step`` is captured once over static buffers and each frame is one
graph launch plus the copies around it. There is no JAX counterpart of this
module.

Static inputs: the frame [H, W] (float32), the carry (pyr [SH, W],
state [24], pts [cap, 6]), the direct-tracking cache [cap, CACHE_COLS] and
the prediction [13]. The graph writes the new carry back into its static
carry buffers, so replays chain; ``load`` copies in, on the caller's
stream, the carry, cache and prediction it is given (a source that is the
static buffer itself costs nothing). The packed output and
the static pyramid are overwritten by the next replay: a caller that keeps
them copies them first.

A capture that fails raises; nothing falls back to eager execution.
"""
from __future__ import annotations

import torch

from ..ops.image import stack_rows
from .framestep import CACHE_COLS, FrameCarry, frame_step, pack_pred_np

WARMUP_STEPS = 2


class FrameStepGraph:
    """``frame_step`` at one shape (H, W, n_levels, scale_factor, remap
    present, cap) on one CUDA device, captured at construction."""

    def __init__(self, height: int, width: int, cap: int, intr,
                 n_levels: int = 4, scale_factor: float = 2.0,
                 min_align: int = 30, align_iters: int = 10,
                 remap_grid=None, device="cuda"):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"FrameStepGraph needs a CUDA device, got {dev}")
        self.device = dev
        self.intr = tuple(float(v) for v in intr)
        self.kw = dict(n_levels=n_levels, scale_factor=scale_factor,
                       min_align=min_align, align_iters=align_iters)
        _, sh = stack_rows(height, width, n_levels, scale_factor)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        self.img = zeros(height, width)
        self.carry = FrameCarry(pyr=zeros(sh, width), state=zeros(24),
                                pts=zeros(cap, 6))
        self.cache = zeros(cap, CACHE_COLS)
        self.pred = zeros(13)
        self.no_pred = torch.as_tensor(pack_pred_np(), device=dev)
        self.remap = (None if remap_grid is None else
                      remap_grid.to(dev, torch.float32).clone())
        self.replays = 0
        self.graph = torch.cuda.CUDAGraph()
        self._capture()

    def _body(self):
        new_carry, packed = frame_step(self.img, self.carry, self.cache,
                                       self.pred, self.remap, self.intr,
                                       **self.kw)
        for dst, src in zip(self.carry, new_carry):
            dst.copy_(src)
        return packed

    def _capture(self):
        """Warm up on a side stream (library handles and workspaces are made
        there, outside the capture), then capture. The capture is
        thread-local: another thread's launches and syncs on its own stream
        (the mapping worker) cannot break it. The linalg library is pinned
        to cuSOLVER / cuBLAS (no MAGMA, which may allocate or sync)."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        backend = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._body()
            side.synchronize()
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.out = self._body()
        finally:
            torch.backends.cuda.preferred_linalg_library(backend)
        torch.cuda.current_stream(self.device).wait_stream(side)

    def load(self, carry: FrameCarry = None, cache=None, pred=None):
        """Copy the given carry, cache and prediction into the static
        buffers, on the current stream (so after every replay already
        queued there). A source that is the static buffer itself (the
        chained carry) is skipped."""
        pairs = [] if carry is None else list(zip(self.carry, carry))
        pairs += [(self.cache, cache), (self.pred, pred)]
        for dst, src in pairs:
            if src is not None and src is not dst:
                dst.copy_(src)

    def step(self, img):
        """One frame: copy img (any dtype, host or device) into the static
        frame and replay. Returns the packed output (overwritten by the
        next replay); the new carry is ``self.carry``."""
        self.img.copy_(img)
        self.graph.replay()
        self.replays += 1
        return self.out

    def run_batch(self, imgs, carry: FrameCarry, cache, out=None):
        """B replays chained through the static carry, with no prediction;
        each frame's packed output and stacked pyramid are copied out.
        Returns (self.carry, outs [B, n_out], pyrs [B, SH, W])."""
        self.load(carry, cache, self.no_pred)
        B = imgs.shape[0]
        if out is None:
            out = (torch.empty((B, self.out.numel()), device=self.device),
                   torch.empty((B,) + tuple(self.carry.pyr.shape),
                               device=self.device))
        outs, pyrs = out
        for b in range(B):
            outs[b].copy_(self.step(imgs[b]))
            pyrs[b].copy_(self.carry.pyr)
        return self.carry, outs, pyrs
