"""The frame step captured once as a CUDA graph and replayed per frame.

The JAX package compiles ``frame_step`` into one ``jit`` dispatch per frame
(``ygz_tpu/frontend/framestep.py:236-295``). Eager PyTorch issues the same
step as ~21,000 small kernels, each launched by the host, so the host's
issue rate bounds it. A CUDA graph is the port's counterpart of the ``jit``:
``frame_step`` is captured once over static buffers and each frame is one
graph launch plus the copies around it. There is no JAX counterpart of this
module.

``FrameStepper`` alone chooses the replay (CUDA) or the eager step (CPU),
stages frames and hands back the outputs; its callers know no graph.

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

import functools
import itertools

import numpy as np
import torch

from ..ops.image import stack_rows
from .framestep import (CACHE_COLS, FrameCarry, frame_step, frame_step_batch,
                        pack_pred_np)

WARMUP_STEPS = 2


class FrameStepGraph:
    """``frame_step`` at one shape (H, W, n_levels, scale_factor, remap
    present, cap) on one CUDA device, captured at construction."""

    def __init__(self, height: int, width: int, cap: int, intr,
                 n_levels: int = 4, scale_factor: float = 2.0,
                 min_align: int = 30, align_iters: int = 10,
                 remap_grid=None, device="cuda"):
        dev = self.device = torch.device(device)
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


class _ChunkSlot:
    """The buffers of one chunk in flight on the card: its frames in pinned
    host memory and on the card, its packed outputs and stacked pyramids on
    the card, the outputs' pinned readback, and the events that order their
    reuse. The graph's static buffers are overwritten by every replay; a
    slot holds one chunk's copies."""

    def __init__(self, B, graph: FrameStepGraph, dtype):
        dev = graph.device
        H, W = graph.img.shape
        self.host_imgs = torch.empty((B, H, W), dtype=dtype, pin_memory=True)
        self.imgs = torch.empty((B, H, W), dtype=dtype, device=dev)
        self.outs = torch.empty((B, graph.out.numel()), device=dev)
        self.pyrs = torch.empty((B,) + tuple(graph.carry.pyr.shape),
                                device=dev)
        self.host_outs = torch.empty(tuple(self.outs.shape), pin_memory=True)
        self.uploaded = torch.cuda.Event()
        self.done = torch.cuda.Event()

    def stage(self, frames):
        """The chunk's frames through pinned memory in one non-blocking
        copy, once this slot's previous upload has left the buffer."""
        self.uploaded.synchronize()
        host = self.host_imgs.numpy()
        for b, f in enumerate(frames):
            host[b] = f
        self.imgs.copy_(self.host_imgs, non_blocking=True)
        self.uploaded.record()

    def read_back(self):
        """Queue the outputs' readback; returns a function that waits for it
        and gives a numpy copy (the pinned buffer is reused)."""
        self.host_outs.copy_(self.outs, non_blocking=True)
        self.done.record()

        def get():
            self.done.synchronize()
            return self.host_outs.numpy().copy()
        return get


class FrameStepper:
    """``frame_step`` at one tracker's shapes on one device: captured at
    construction and replayed on a CUDA device, eager on the CPU. The carry
    ``step`` and ``step_batch`` return may be the graph's static carry,
    which the next call overwrites: pass it back as it is, and keep a
    frame's pyramid through the function returned for it."""

    def __init__(self, height: int, width: int, cap: int, intr,
                 n_levels: int = 4, scale_factor: float = 2.0,
                 min_align: int = 30, remap_grid=None, device="cuda",
                 pipeline_depth: int = 2):
        self.device = torch.device(device)
        self.intr = intr
        self.remap = remap_grid
        self.kw = dict(n_levels=n_levels, scale_factor=scale_factor,
                       min_align=min_align)
        self.no_pred = torch.as_tensor(pack_pred_np(), device=self.device)
        self.graph = (FrameStepGraph(height, width, cap, intr,
                                     remap_grid=remap_grid,
                                     device=self.device, **self.kw)
                      if self.device.type == "cuda" else None)
        self.pipeline_depth = max(1, pipeline_depth)
        self._slots = None

    def step(self, img, carry: FrameCarry, cache, pred=None):
        """One host frame img [H, W] from `carry` against the device cache,
        with the device vector `pred` (pack_pred_np; None: the velocity
        model). On the card: the load's copies, the frame's pageable copy,
        one replay. Returns (new carry, the packed output on the device, a
        function giving a kept copy of the frame's stacked pyramid)."""
        pred = self.no_pred if pred is None else pred
        img = np.ascontiguousarray(img)
        if self.graph is None:
            carry, packed = frame_step(
                torch.as_tensor(img, device=self.device), carry, cache,
                pred, self.remap, self.intr, **self.kw)
        else:
            self.graph.load(carry, cache, pred)
            packed = self.graph.step(torch.from_numpy(img))
            carry = self.graph.carry
        return carry, packed, functools.cache(carry.pyr.clone)

    def step_batch(self, frames, carry: FrameCarry, cache):
        """B host frames chained from `carry` against `cache` with the
        velocity model (frame_step_batch). On the card they go up through
        the next of pipeline_depth pinned slots in one copy, B replays fill
        the slot and its readback is queued; the slot is reused
        pipeline_depth chunks later. Returns (new carry, a function giving
        the [B, packed] numpy outputs, a function per frame giving a kept
        copy of its stacked pyramid)."""
        if self.graph is None:
            imgs = torch.as_tensor(np.stack([np.asarray(f) for f in frames]),
                                   device=self.device)
            carry, outs, pyrs = frame_step_batch(
                imgs, carry, cache, self.remap, self.intr, **self.kw)
            outs_fn = outs.numpy
        else:
            slot = self._slot(len(frames), frames[0])
            slot.stage(frames)
            self.graph.load(carry, cache, self.no_pred)
            for b in range(len(frames)):
                slot.outs[b].copy_(self.graph.step(slot.imgs[b]))
                slot.pyrs[b].copy_(self.graph.carry.pyr)
            carry, outs_fn, pyrs = self.graph.carry, slot.read_back(), \
                slot.pyrs
        return carry, outs_fn, [functools.cache(p.clone) for p in pyrs]

    def _slot(self, B, frame):
        """The next staging slot. uint8 frames are staged as uint8, any
        other as float32 (the frame step casts to float32 first)."""
        dtype = torch.uint8 if np.asarray(frame).dtype == np.uint8 \
            else torch.float32
        if self._slots is None or self._slots[0] != (B, dtype):
            self._slots = ((B, dtype), itertools.cycle(
                [_ChunkSlot(B, self.graph, dtype)
                 for _ in range(self.pipeline_depth)]))
        return next(self._slots[1])
