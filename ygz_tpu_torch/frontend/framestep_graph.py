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

Static inputs: the frame [H, W], the carry (pyr [SH, W], state [24],
pts [cap, 6]), the direct-tracking cache [cap, CACHE_COLS] and the
prediction [13]. The graph writes the new carry back into its static
carry buffers, so replays chain; ``load`` copies in, on the caller's
stream, the carry, cache and prediction it is given (a source that is the
static buffer itself costs nothing). The packed output and the static
pyramid are overwritten by the next replay: a caller that keeps them
copies them first.

Two kinds of graph share the ``frame_step`` body and nothing else. The
chunk path's graph takes its frame in a static device buffer
(``FrameStepGraph(frame_dtype=None)``). The per-frame path's graph, one per
frame dtype, takes its frame in a pinned host buffer: the upload, the
frame step and the packed output's copy into a pinned host buffer are all
nodes of the graph, so a steady frame is one numpy copy in, one replay,
one wait and one copy out.

A capture that fails raises; nothing falls back to eager execution.
"""
from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from ..ops.image import stack_rows
from ..utils import cuda_build
from .framestep import (CACHE_COLS, FrameCarry, frame_step, frame_step_batch,
                        pack_pred_np)

WARMUP_STEPS = 2


@functools.cache
def _event_wait():
    """csrc/event_wait.cu's ygz_event_wait, loaded with ctypes.PyDLL: it
    keeps the interpreter lock while the host waits for the card, so no
    other Python thread takes the lock between the frame's replay and its
    output (ctypes.CDLL would hand it over and have to win it back)."""
    return cuda_build.function("event_wait", "ygz_event_wait",
                               [ctypes.c_void_p], hold_gil=True)


class FrameStepGraph:
    """``frame_step`` at one shape (H, W, n_levels, scale_factor, remap
    present, cap) on one CUDA device, captured at construction.

    frame_dtype None: the frame is a static device buffer (float32) that
    ``step`` copies any tensor into. A numpy dtype: the frame is staged in
    a pinned host buffer of that dtype, and the graph itself uploads it
    and copies the packed output into the pinned ``host_out``; ``read``
    waits for the replay and returns a copy of it."""

    def __init__(self, height: int, width: int, cap: int, intr,
                 n_levels: int = 4, scale_factor: float = 2.0,
                 min_align: int = 30, align_iters: int = 10,
                 remap_grid=None, device="cuda", frame_dtype=None):
        dev = self.device = torch.device(device)
        self.intr = tuple(float(v) for v in intr)
        self.kw = dict(n_levels=n_levels, scale_factor=scale_factor,
                       min_align=min_align, align_iters=align_iters)
        _, sh = stack_rows(height, width, n_levels, scale_factor)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        self.host_img = self.host_out = None
        if frame_dtype is None:
            self.img = zeros(height, width)
        else:
            dtype = torch.from_numpy(np.empty(0, frame_dtype)).dtype
            self.host_img = torch.zeros((height, width), dtype=dtype,
                                        pin_memory=True)
            self._host_img_np = self.host_img.numpy()
            self._host_pred = torch.zeros(13, pin_memory=True)
            self.img = torch.zeros((height, width), dtype=dtype, device=dev)
        self.carry = FrameCarry(pyr=zeros(sh, width), state=zeros(24),
                                pts=zeros(cap, 6))
        self.cache = zeros(cap, CACHE_COLS)
        self.pred = zeros(13)
        self.remap = (None if remap_grid is None else
                      remap_grid.to(dev, torch.float32).clone())
        self.replays = 0
        self.done = torch.cuda.Event()
        self._pending = False
        self.graph = torch.cuda.CUDAGraph()
        self._capture()

    def _body(self):
        if self.host_img is not None:
            self.img.copy_(self.host_img, non_blocking=True)
        new_carry, packed = frame_step(self.img, self.carry, self.cache,
                                       self.pred, self.remap, self.intr,
                                       **self.kw)
        for dst, src in zip(self.carry, new_carry):
            dst.copy_(src)
        if self.host_img is not None:
            if self.host_out is None:       # the first warm-up step
                self.host_out = torch.empty(packed.shape, dtype=packed.dtype,
                                            pin_memory=True)
            self.host_out.copy_(packed, non_blocking=True)
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

    def stage_pred(self, pred):
        """Copy the host vector pred [13] into the static prediction of a
        staged graph through its pinned buffer (once the last replay, whose
        copy may still read it, is done), on the current stream."""
        self.wait()
        self._host_pred.numpy()[:] = pred
        self.pred.copy_(self._host_pred, non_blocking=True)

    def step(self, img):
        """One frame: stage img (host or device; a staged graph takes a
        host array) and replay. Returns the packed output on the device
        (overwritten by the next replay); the new carry is ``self.carry``.
        A staged graph first waits for its previous replay, whose upload
        may still read the pinned frame."""
        if self.host_img is None:
            self.img.copy_(img)
        else:
            self.wait()
            self._host_img_np[...] = img
        self.graph.replay()
        if self.host_img is not None:
            self.done.record()
            self._pending = True
        self.replays += 1
        return self.out

    def wait(self):
        """Wait on the host, keeping the interpreter lock, for the last
        replay of a staged graph (at once when it was waited for)."""
        if self._pending:
            cuda_build.check_call(_event_wait()(self.done.cuda_event),
                                  "cudaEventSynchronize")
            self._pending = False

    def read(self):
        """The last replay's packed output of a staged graph as a fresh
        numpy array (the pinned buffer is the next replay's)."""
        self.wait()
        return self.host_out.numpy().copy()


class StaticLoads:
    """Which static inputs of a per-frame graph a frame copies in. The
    cache when the snapshot's cache is another tensor than the one loaded
    last: compared by identity, with a reference kept, so a freed cache
    whose memory returns as a new one (at the same address) still loads.
    The prediction on a frame that gives one and on the first frame after
    (which loads the velocity model's); the static prediction of a fresh
    graph is zeros, so its first frame loads too."""

    def __init__(self):
        self.cache = None
        self.pred_stale = True

    def cache_changed(self, cache) -> bool:
        if cache is self.cache:
            return False
        self.cache = cache
        return True

    def pred_needed(self, given: bool) -> bool:
        need = given or self.pred_stale
        self.pred_stale = given
        return need


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
    """``frame_step`` at one tracker's shapes on one device: replayed from
    CUDA graphs on a CUDA device (each captured at its first use), eager on
    the CPU. The carry ``step`` and ``step_batch`` return may be a graph's
    static carry, which the next call overwrites: pass it back as it is,
    and keep a frame's pyramid through the function returned for it.

    ``graph`` is the per-frame graph of the last ``step`` (None before it
    and on the CPU); ``batch_graph`` the chunk path's (None before the
    first ``step_batch``)."""

    def __init__(self, height: int, width: int, cap: int, intr,
                 n_levels: int = 4, scale_factor: float = 2.0,
                 min_align: int = 30, remap_grid=None, device="cuda",
                 pipeline_depth: int = 2):
        self.device = torch.device(device)
        self.intr = intr
        self.remap = remap_grid
        self.shape = (height, width, cap)
        self.kw = dict(n_levels=n_levels, scale_factor=scale_factor,
                       min_align=min_align)
        self.no_pred = torch.as_tensor(pack_pred_np(), device=self.device)
        self.graph = self.batch_graph = None
        self._graphs = {}          # frame dtype -> (graph, StaticLoads)
        self.pipeline_depth = max(1, pipeline_depth)
        self._slots = None

    def _graph(self, frame_dtype=None) -> FrameStepGraph:
        return FrameStepGraph(*self.shape, self.intr, remap_grid=self.remap,
                              device=self.device, frame_dtype=frame_dtype,
                              **self.kw)

    def step(self, img, carry: FrameCarry, cache, pred=None,
             ready_cache=None):
        """One host frame img [H, W] from `carry` against the device cache,
        with the host vector `pred` (pack_pred_np; None: the velocity
        model). `ready_cache`: a function giving `cache` ready on this
        thread's stream (``Snapshot.ready_cache``), called only on a frame
        that copies the cache; None: `cache` is ready as it is.

        On the card, through the per-frame graph of img's dtype: the carry
        when it is not the graph's own, the cache only when it is another
        tensor than the one loaded last, the prediction only on a frame
        that gives one and the frame after;
        the frame copied into pinned memory; one replay. Returns (new
        carry, a function giving the packed output as a fresh numpy array,
        to call before the next step; a function giving a kept copy of the
        frame's stacked pyramid)."""
        img = np.asarray(img)
        if self.device.type != "cuda":
            pred = self.no_pred if pred is None else torch.as_tensor(
                np.asarray(pred, np.float32), device=self.device)
            carry, packed = frame_step(
                torch.as_tensor(np.ascontiguousarray(img),
                                device=self.device),
                carry, cache, pred, self.remap, self.intr, **self.kw)
            return carry, packed.numpy, functools.cache(carry.pyr.clone)
        if img.dtype not in self._graphs:
            self._graphs[img.dtype] = (self._graph(img.dtype), StaticLoads())
        graph, loads = self._graphs[img.dtype]
        self.graph = graph
        graph.load(carry)
        if loads.cache_changed(cache):
            graph.cache.copy_(cache if ready_cache is None else ready_cache())
        if loads.pred_needed(pred is not None):
            graph.stage_pred(pack_pred_np() if pred is None else pred)
        graph.step(img)
        seq = graph.replays

        def out():
            if graph.replays != seq:
                raise RuntimeError("a frame's output was read after the "
                                   "next frame step")
            return graph.read()
        return graph.carry, out, functools.cache(graph.carry.pyr.clone)

    def step_batch(self, frames, carry: FrameCarry, cache):
        """B host frames chained from `carry` against `cache` with the
        velocity model (frame_step_batch). On the card they go up through
        the next of pipeline_depth pinned slots in one copy, B replays fill
        the slot and its readback is queued; the slot is reused
        pipeline_depth chunks later. Returns (new carry, a function giving
        the [B, packed] numpy outputs, a function per frame giving a kept
        copy of its stacked pyramid)."""
        if self.device.type != "cuda":
            imgs = torch.as_tensor(np.stack([np.asarray(f) for f in frames]),
                                   device=self.device)
            carry, outs, pyrs = frame_step_batch(
                imgs, carry, cache, self.remap, self.intr, **self.kw)
            outs_fn = outs.numpy
        else:
            if self.batch_graph is None:
                self.batch_graph = self._graph()
            graph = self.batch_graph
            slot = self._slot(len(frames), frames[0])
            slot.stage(frames)
            graph.load(carry, cache, self.no_pred)
            for b in range(len(frames)):
                slot.outs[b].copy_(graph.step(slot.imgs[b]))
                slot.pyrs[b].copy_(graph.carry.pyr)
            carry, outs_fn, pyrs = graph.carry, slot.read_back(), slot.pyrs
        return carry, outs_fn, [functools.cache(p.clone) for p in pyrs]

    def _slot(self, B, frame):
        """The next staging slot. uint8 frames are staged as uint8, any
        other as float32 (the frame step casts to float32 first)."""
        dtype = torch.uint8 if np.asarray(frame).dtype == np.uint8 \
            else torch.float32
        if self._slots is None or self._slots[0] != (B, dtype):
            self._slots = ((B, dtype), itertools.cycle(
                [_ChunkSlot(B, self.batch_graph, dtype)
                 for _ in range(self.pipeline_depth)]))
        return next(self._slots[1])
