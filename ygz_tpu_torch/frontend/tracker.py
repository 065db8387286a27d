"""Tracking front-end: host state machine over batched device steps.

Port of ``ygz_tpu/frontend/tracker.py``: ``MonoTracker`` (the monocular VO
main path), and ``RgbdTracker`` and ``StereoTracker``, which initialize
from one frame and seed metric map points from depth at every keyframe.
MonoTracker: initialize (ORB + two-view) -> per frame the fused step
(sparse alignment seeded by the last frame, direct local-map tracking with a
point cache, pose GN) -> keyframe decision -> mapping tail (triangulation,
fusion, local BA, culling, patch refresh), inline or, with
``async_mapping``, on a worker thread with its own CUDA stream. The frame
step reaches the device through ``framestep_graph.FrameStepper`` (a
captured CUDA graph replayed on the card). ``track_batch`` tracks chunks of
``track_batch`` frames with ``pipeline_depth`` chunks in flight. When direct
tracking fails, the feature fallback ladder (motion model -> reference KF
-> feature local map) runs before the tracker declares itself LOST; a LOST
tracker relocalizes through BoW candidates and EPnP RANSAC. Each keyframe
is indexed for place recognition and tested for a loop; an accepted loop is
corrected through the Sim3 essential graph, then a global BA (sharded over
``mesh_devices`` shards, parallel/dist_ba.py, when that is > 1).

The sensor-fusion hooks of the JAX tracker (``_predict_pose``,
``_on_vision_failed``, ``_fuse_pose``, ``_kf_time_gap``,
``_on_keyframe_created``, ``_run_local_ba``, ``_cull_keyframes``) keep their
no-op defaults here; the mono-VI subclass (``frontend/vi_tracker.py``)
overrides them.
"""
from __future__ import annotations

import enum
import functools
import os
import queue
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..backend.bow import (BowIndex, default_vocabulary_path,
                           load_vocabulary, train_vocabulary)
from ..backend.loopclosing import LoopCloser
from ..backend.mapping import LocalMapper
from ..backend.mapstate import SlamMap
from ..backend.optim import pose_optimization
from ..backend.pnp import pnp_ransac
from ..geometry import camera as cam_mod
from ..geometry.twoview import two_view_reconstruct
from ..ops import matching
from ..ops.image import level0
from ..ops.stereo import stereo_match_features
from ..parallel.dist_ba import Mesh
from ..utils.profiling import StageTimer, set_frame
from .extractor import OrbExtractor
from .framestep import (build_pyramid_stacked, make_carry, pack_cache_np,
                        pack_pred_np, unpack_out)
from .framestep_graph import FrameStepper


def _depth_at(depth, uv):
    """Depth map values at the pixels nearest to uv [N, 2], clamped into
    the map. np.round rounds half to even, as the JAX package's lookups
    do, so both seed the same pixels."""
    depth = np.asarray(depth)
    xi = np.clip(np.round(uv[:, 0]).astype(int), 0, depth.shape[1] - 1)
    yi = np.clip(np.round(uv[:, 1]).astype(int), 0, depth.shape[0] - 1)
    return depth[yi, xi]


class Snapshot(NamedTuple):
    """What the frame step tracks against, published in one attribute
    write (the tracking thread reads it without the lock): the cache's map
    point ids, the device cache, the reference keyframe (-1: none) and its
    pose, the cached points' world positions, the event after which the
    cache is ready on the publishing thread's stream (None on the CPU), and
    whether the mapping worker published it."""
    ids: np.ndarray
    cache: torch.Tensor
    ref_kf: int
    R_ref: np.ndarray
    t_ref: np.ndarray
    xyz: np.ndarray
    ready: Optional[torch.cuda.Event]
    from_worker: bool

    def ready_cache(self):
        """The device cache, ready on this thread's stream: a snapshot
        published on another stream is waited for, and its memory kept
        until this stream is done with it."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.cache.device)
            stream.wait_event(self.ready)
            self.cache.record_stream(stream)
        return self.cache


class State(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackerConfig:
    """The JAX package's tracker settings, with its defaults."""
    n_features: int = 512
    keypoint_mode: str = "grid"
    n_levels: int = 4
    scale_factor: float = 2.0
    fast_th: float = 20.0
    fast_th_min: float = 7.0
    max_track: int = 512          # direct-tracking cache capacity
    cache_refill_below: int = 150
    min_align_points: int = 30
    min_track_inliers: int = 30
    min_init_matches: int = 100
    kf_ratio: float = 0.75        # inliers < 0.75 * ref-KF tracked
    kf_min_gap: int = 3
    kf_max_gap: int = 30
    th_depth: float = 35.0        # close/far split in baseline units
    ba_window: int = 6
    enable_loop_closing: bool = True
    enable_relocalization: bool = True
    vocab_branching: int = 8
    vocab_depth: int = 3
    # "auto": the shipped offline vocabulary (ygz_tpu_torch/data/orb_vocab.npz,
    # k=10 L=5, 99,478 words) when present, else trained in-system on the
    # init descriptors; a path loads that file; None forces training
    vocab_path: Optional[str] = "auto"
    # the mapping tail on a worker thread (the reference's LocalMapping
    # thread): tracking returns the pre-BA pose of a keyframe, and BA
    # corrections land through the shared map under a lock
    async_mapping: bool = False
    # track_batch: B consecutive frames per chunk. 1 = per-frame
    track_batch: int = 8
    # chunks track_batch keeps in flight: chunk N+1 is dispatched against
    # the snapshot that held before chunk N's keyframes were consumed, so
    # keyframe/mapping effects lag up to (pipeline_depth - 1) more chunks
    pipeline_depth: int = 2
    # distributed bundle adjustment: shard global BA over N shards
    # (landmark-block sharding, parallel/dist_ba.py): the first N cards of
    # a CUDA tracker, N shards on the CPU for a CPU one. 0/1 = dense.
    mesh_devices: int = 0


@dataclass
class FrameRecord:
    """Per-frame trajectory entry: the live world->cam pose at track time,
    plus the pose relative to its reference keyframe so later map
    corrections propagate into the exported trajectory."""
    ts: float
    R: np.ndarray
    t: np.ndarray
    state: str
    ref_kf: int = -1
    R_r: np.ndarray = None
    t_r: np.ndarray = None


class MonoTracker:
    def __init__(self, cam: cam_mod.Camera, cfg: TrackerConfig = None,
                 device="cuda"):
        self.cam = cam
        self.cfg = cfg or TrackerConfig()
        self.device = torch.device(device)
        self.intr = (cam.fx, cam.fy, cam.cx, cam.cy)
        self.extractor = OrbExtractor(
            n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
            scale_factor=self.cfg.scale_factor, fast_th=self.cfg.fast_th,
            fast_th_min=self.cfg.fast_th_min, mode=self.cfg.keypoint_mode)
        self.map = SlamMap(max_feat=1024)
        mesh = None
        n = self.cfg.mesh_devices
        if n and n > 1:
            if self.device.type == "cuda":
                k = torch.cuda.device_count()
                if k < n:
                    raise ValueError(f"mesh_devices={n} but only {k} "
                                     f"devices visible")
                mesh = Mesh([torch.device("cuda", i) for i in range(n)])
            else:
                mesh = Mesh([self.device] * n)
        self.mapper = LocalMapper(cam, n_levels=self.cfg.n_levels,
                                  window=self.cfg.ba_window,
                                  device=self.device, mesh=mesh)
        self.state = State.NOT_INITIALIZED
        self.frame_id = -1
        self.trajectory: list[FrameRecord] = []
        # undistortion remap [2, H, W] on the device (None: no distortion)
        self._remap = (torch.stack(cam_mod.undistort_remap_grid(
            cam, self.device)) if cam.has_distortion else None)
        self._init_feats = None
        self._init_pyr = None
        self._init_ts = None
        self._last_R = None
        self._last_t = None
        self._vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self._cache = np.zeros(0, np.int64)   # map point ids in the cache
        self._snap: Optional[Snapshot] = None
        self._snap_used = None   # the snapshot the last frame tracked
        self._carry = None    # framestep.FrameCarry on the device
        self.debug = {}
        self._cur_depth = None    # this frame's depth map (RGB-D)
        self.timer = StageTimer()
        self._last_kf = -1
        self._last_kf_frame = -1
        self._kf_ref_tracked = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        # place recognition: vocabulary loaded (or trained) at map init
        self.bow_index: BowIndex = None
        self.loop_closer: LoopCloser = None
        self.n_loops_closed = 0
        # relocalization's PnP RANSAC draws on the CPU, so a CUDA run draws
        # the same hypotheses as a CPU one
        self._reloc_gen = torch.Generator()
        self._reloc_gen.manual_seed(0)
        # localization-only: track against the frozen map, no KFs/mapping
        # (reference ActivateLocalizationMode)
        self.localization_only = False
        # the frame step's trip to the device, made at the first tracked
        # frame and kept across reset() (the graph is captured once)
        self._stepper: Optional[FrameStepper] = None

        # async mapping (the reference's LocalMapping thread). The lock
        # guards the map's arrays; the mapping tail holds it while it
        # mutates the map, and the tracking thread for the map reads of its
        # rare paths (cache refill, fallback, relocalization). The worker
        # runs each job on its own CUDA stream.
        self._map_lock = threading.RLock()
        self._map_queue: queue.Queue = queue.Queue()
        self._map_worker = None
        self._map_worker_error = None
        self._map_stream = None
        if self.cfg.async_mapping:
            if self.device.type == "cuda":
                self._map_stream = torch.cuda.Stream(self.device)
            self._map_worker = threading.Thread(
                target=self._mapping_worker, daemon=True,
                name="ygz-mapping")
            self._map_worker.start()

    def _mapping_worker(self):
        # bind the queue and the stream once: reset() swaps in fresh ones
        # while this (old) thread may still be draining its jobs
        q = self._map_queue
        stream = self._map_stream
        while True:
            job = q.get()
            if job is None:
                q.task_done()
                return
            try:
                if stream is None:
                    job()
                else:
                    with torch.cuda.stream(stream):
                        job()
            except Exception as e:   # surfaced by wait_mapping_idle
                self._map_worker_error = e
            finally:
                q.task_done()

    def wait_mapping_idle(self):
        """Block until the mapping queue drains; raise the worker's error,
        if a job failed."""
        self._map_queue.join()
        if self._map_worker_error is not None:
            err = self._map_worker_error
            self._map_worker_error = None
            raise err

    def _tail_idle(self) -> bool:
        """True when no mapping-tail work is queued or in flight."""
        return (self._map_worker is None
                or self._map_queue.unfinished_tasks == 0)

    @contextmanager
    def _locked(self):
        """Hold the map lock. The wait to take it is a stage of its own:
        mapping.lock_wait on the worker, track.lock_wait on any other
        thread (a re-entry of the RLock takes no time)."""
        lock = self._map_lock
        with self.timer.stage(
                "mapping.lock_wait"
                if threading.current_thread() is self._map_worker
                else "track.lock_wait"):
            lock.acquire()
        try:
            yield
        finally:
            lock.release()

    def _join_mapper(self):
        """Order this thread's stream after the mapping stream's work, before
        it reads device tensors the worker made (keyframe feature mirrors).
        Called with the map lock held."""
        if self._map_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(
                self._map_stream)

    def _record_event(self):
        """A CUDA event recorded on this thread's current stream (None on
        the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def reset(self, keep_trajectory: bool = True):
        """Clear map and tracking state (reference Tracking::Reset). Jobs
        queued against the old map drop themselves; one in flight finishes
        first (the map lock); the old worker stops after its queue."""
        with self._locked():
            traj = self.trajectory if keep_trajectory else []
            # bake relative-pose records to absolute against the dying map
            for rec in traj:
                if rec.ref_kf >= 0:
                    rec.R, rec.t = self.recovered_pose(rec)
                    rec.ref_kf, rec.R_r, rec.t_r = -1, None, None
            fid = self.frame_id
            if self._map_worker is not None:
                self._map_queue.put(None)
            keep = (self._map_lock, self._stepper)
            self._reinit()
            self._map_lock, self._stepper = keep
            self.trajectory = traj
            self.frame_id = fid

    def _reinit(self):
        self.__init__(self.cam, self.cfg, self.device)

    # ------------------------------------------------------------------ utils
    def _t(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def _build_pyramid(self, img):
        """Stacked [SH, W] pyramid (+ undistort) of a host frame."""
        return build_pyramid_stacked(self._t(img), self._remap,
                                     self.cfg.n_levels, self.cfg.scale_factor)

    @staticmethod
    def _feats_to_dict(feats):
        return {k: getattr(feats, k).cpu().numpy()
                for k in ("uv", "level", "angle", "desc", "valid")}

    @staticmethod
    def _pose_np(R, t):
        return R.cpu().numpy(), t.cpu().numpy()

    # ------------------------------------------------------------------ entry
    def track(self, img, ts: float, depth=None):
        """Process one grayscale frame. Returns (state, R, t) with (R, t)
        the world->camera pose (identity until initialized). `depth`: an
        optional [H, W] metric depth map aligned with `img` (RGB-D)."""
        with self.timer.stage("track"):
            return self._track(img, ts, depth)

    def _track(self, img, ts, depth):
        self.frame_id += 1
        set_frame(self.frame_id)
        self._cur_depth = depth
        if self.state == State.NOT_INITIALIZED:
            with self.timer.stage("pyramid"):
                pyr = self._build_pyramid(img)
            ok = self._try_initialize(pyr, ts)
            R = self.map.kf_R[self.map.n_kf - 1] if ok else np.eye(3)
            t = self.map.kf_t[self.map.n_kf - 1] if ok else np.zeros(3)
            self._log(ts, R, t)
            return self.state, R, t
        if self.state == State.LOST:
            with self.timer.stage("pyramid"):
                pyr = self._build_pyramid(img)
            relocalized = False
            if self.cfg.enable_relocalization:
                with self.timer.stage("relocalize"):
                    relocalized = self._relocalize(pyr)
            if not relocalized:
                self._log(ts, self._last_R, self._last_t)
                return self.state, self._last_R, self._last_t
            self.state = State.OK
        ok, R, t = self._track_frame(img, ts)
        self._log(ts, R, t)
        return self.state, R, t

    def _log(self, ts, R, t):
        R = np.array(R, np.float32)
        t = np.array(t, np.float32)
        ref, R_r, t_r = -1, None, None
        snap = self._snap
        if self.state == State.OK and snap is not None and snap.ref_kf >= 0:
            # relative pose against the ref KF pose as tracked against
            ref, Rk, tk = snap.ref_kf, snap.R_ref, snap.t_ref
            R_r = R @ Rk.T
            t_r = t - R_r @ tk
        self.trajectory.append(FrameRecord(ts=ts, R=R, t=t,
                                           state=self.state.name, ref_kf=ref,
                                           R_r=R_r, t_r=t_r))

    def recovered_pose(self, rec: FrameRecord):
        """Frame pose with all later map corrections: the logged relative
        pose composed onto the ref KF's CURRENT pose (walking past culled
        KFs)."""
        if rec.ref_kf < 0 or rec.R_r is None:
            return rec.R, rec.t
        with self._locked():
            Rk, tk = self.map.resolve_pose(rec.ref_kf)
        return rec.R_r @ Rk, rec.R_r @ tk + rec.t_r

    def _build_vocabulary(self, desc, doc_ids=None):
        """Vocabulary source (TrackerConfig.vocab_path): the shipped offline
        vocabulary, a given file, or in-system training on `desc`."""
        path = self.cfg.vocab_path
        if path == "auto":
            p = default_vocabulary_path()
            if os.path.exists(p):
                return load_vocabulary(p)
        elif path:
            return load_vocabulary(path)
        return train_vocabulary(desc, branching=self.cfg.vocab_branching,
                                depth=self.cfg.vocab_depth, doc_ids=doc_ids)

    # ----------------------------------------------------------------- init
    def _try_initialize(self, pyr, ts) -> bool:
        feats = self.extractor(pyr)
        if self._init_feats is None:
            if int(feats.valid.sum()) >= self.cfg.min_init_matches:
                self._init_feats = self._feats_to_dict(feats)
                self._init_pyr = pyr
                self._init_ts = ts
            return False
        f0, f1 = self._init_feats, feats
        idx, ok = matching.match_with_windows(
            self._t(f0["desc"]), self._t(f0["valid"]), f1.desc, f1.valid,
            uv_pred1=self._t(f0["uv"]), uv2=f1.uv, radius=100.0,
            max_dist=matching.TH_LOW, ratio=0.9,
            ang1=self._t(f0["angle"]), ang2=f1.angle, mutual=True)
        if int(ok.sum()) < self.cfg.min_init_matches:
            # stale reference: restart bootstrapping from this frame
            self._init_feats = self._feats_to_dict(feats)
            self._init_pyr = pyr
            self._init_ts = ts
            return False
        uv2 = f1.uv[torch.clamp(idx, 0, f1.uv.shape[0] - 1).long()]
        res = two_view_reconstruct(self._t(f0["uv"]), uv2, ok,
                                   self.cam.K.to(self.device), self._gen)
        if not bool(res.ok):
            return False
        self._create_initial_map(res, idx.cpu().numpy(), feats, pyr, ts)
        return True

    def _create_initial_map(self, res, idx, feats1, pyr1, ts1):
        """Two KFs + triangulated points, scaled to median depth 1
        (reference CreateInitialMapMonocular)."""
        good = res.good.cpu().numpy()
        X = res.points.cpu().numpy()
        R1 = res.R.cpu().numpy()
        t1 = res.t.cpu().numpy()
        med = float(np.median(X[good][:, 2]))
        X = X / med
        t1 = t1 / med
        f0 = self._init_feats
        f1 = self._feats_to_dict(feats1)
        smap = self.map
        kf0 = smap.add_keyframe(np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32), f0,
                                ts=self._init_ts, frame_id=self.frame_id - 1,
                                pyramid=self._init_pyr)
        kf1 = smap.add_keyframe(R1, t1, f1, ts=ts1, frame_id=self.frame_id,
                                pyramid=pyr1)
        slots0 = np.nonzero(good)[0]
        slots1 = idx[slots0]
        # only keep points whose reference patch (captured from KF1) is clean
        inb = self.mapper.patch_in_bounds(smap.kf_feat_uv[kf1, slots1],
                                          smap.kf_feat_level[kf1, slots1])
        slots0, slots1 = slots0[inb], slots1[inb]
        ids = smap.alloc_points(len(slots0))
        smap.pt_xyz[ids] = X[slots0]
        smap.pt_valid[ids] = True
        smap.pt_first_kf[ids] = kf0
        smap.pt_desc[ids] = f0["desc"][slots0]
        smap.bind(kf0, slots0, ids)
        smap.bind(kf1, slots1, ids)
        self.mapper.refresh_patches(smap, kf1, pyr1, ids, slots1)
        # initial BA over the 2-KF map, then re-normalize the free scale
        self.mapper.local_ba(smap, kf1)
        med2 = self.mapper.median_depth(smap, kf0)
        smap.pt_xyz[: smap.n_pt] /= med2
        smap.kf_t[:2] /= med2
        self.mapper.refresh_patches(smap, kf1, pyr1, ids, slots1)
        if self.cfg.enable_loop_closing or self.cfg.enable_relocalization:
            desc = np.concatenate([f0["desc"][f0["valid"]],
                                   f1["desc"][f1["valid"]]])
            doc = np.concatenate([np.zeros(int(f0["valid"].sum()), np.int64),
                                  np.ones(int(f1["valid"].sum()), np.int64)])
            self.bow_index = BowIndex(self._build_vocabulary(desc, doc),
                                      max_kf=smap.max_kf, device=self.device)
            self.loop_closer = LoopCloser(self.bow_index, self.cam,
                                          device=self.device)
            for k in (kf0, kf1):
                self._index_keyframe(k)
        smap.kf_parent[kf1] = kf0
        self.state = State.OK
        self._last_kf = kf1
        self._last_kf_frame = self.frame_id
        self._kf_ref_tracked = len(ids)
        self._rebuild_cache()
        self._set_last_frame(pyr1, smap.kf_R[kf1], smap.kf_t[kf1],
                             cache_uv=None)
        self._vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))

    # ------------------------------------------------------------- main track
    def _frame_stepper(self) -> FrameStepper:
        """The frame step for this tracker's shapes, made at the first
        tracked frame and kept across reset()."""
        if self._stepper is None:
            cfg = self.cfg
            self._stepper = FrameStepper(
                self.cam.height, self.cam.width, cfg.max_track, self.intr,
                n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
                min_align=cfg.min_align_points, remap_grid=self._remap,
                device=self.device, pipeline_depth=cfg.pipeline_depth)
        return self._stepper

    def _load_cache(self, snap):
        """snap's cache ready for the frame step to copy: the stepper calls
        this only on a frame that loads a new cache, so the stage
        frame_step.cache_load counts one a copy."""
        with self.timer.stage("frame_step.cache_load"):
            return snap.ready_cache()

    def _tracking_snapshot(self):
        """The snapshot the next frame step tracks against: a thin cache is
        rebuilt first while the mapper is idle (so tracking never waits on
        the tail); the first use of one the worker published calls
        _on_map_corrected."""
        if (len(self._snap.ids) < self.cfg.cache_refill_below
                and self._tail_idle()):
            with self._locked():
                self._join_mapper()
                self._rebuild_cache()
        snap = self._snap
        if snap.from_worker and snap is not self._snap_used:
            self._on_map_corrected()
        self._snap_used = snap
        return snap

    def _track_frame(self, img, ts):
        """Steady-state frame: one fused frame step on the device (a graph
        replay on the card) and ONE readback of its packed output."""
        # external pose prediction (mono-VI: IMU propagation); the step
        # falls back to its on-device velocity model otherwise
        pred = self._predict_pose()
        pred_vec = None if pred is None else \
            pack_pred_np(pred[0], pred[1], True)
        snap = self._tracking_snapshot()
        with self.timer.stage("frame_step"):
            stepper = self._frame_stepper()
            with self.timer.stage("frame_step.dispatch"):
                self._carry, out_fn, pyr_fn = stepper.step(
                    img, self._carry, snap.cache, pred_vec,
                    ready_cache=functools.partial(self._load_cache, snap))
            with self.timer.stage("frame_step.readback"):
                packed = out_fn()
            out = unpack_out(packed, self.cfg.max_track)
        ok, R, t, _ = self._consume_out(out, snap.ids, ts, pyr_fn,
                                        snap_xyz=snap.xyz)
        return ok, R, t

    # ----------------------------------------------------------- batch track
    def track_batch(self, imgs, timestamps):
        """Track consecutive frames in chunks of cfg.track_batch with
        cfg.pipeline_depth chunks in flight. A chunk is B frame steps
        chained through the device carry (FrameStepper.step_batch; B graph
        replays on the card), staged through pinned memory in one copy and
        read back in one; chunk N+1 depends only on the carry and a cache
        snapshot, so it is dispatched before chunk N is consumed.
        Keyframe/mapping effects lag up to B - 1 frames in a chunk plus up
        to pipeline_depth - 1 chunks of snapshot (the reference's async
        LocalMapping shows the same lag); with the async worker a chunk
        tracks the snapshot its last published tail left. Bootstrap, LOST,
        predictor and short-remainder frames take the per-frame path; after
        a failure inside a chunk its remaining frames re-run per frame and
        the chunks dispatched after it are discarded unread.

        Returns a list of (state, R, t) per frame."""
        cfg = self.cfg
        B = cfg.track_batch
        depth = max(1, cfg.pipeline_depth)
        results = []
        i = 0                  # first frame not yet consumed
        next_i = 0             # first frame not yet dispatched
        n_total = len(imgs)
        inflight = []          # [(i0, snap, outs_fn, pyr_fns)], oldest first

        def can_batch(j):
            # the state and the predictor are read at dispatch time: with
            # chunks in flight this speculates that they stay unchanged
            # (clean consumption leaves both; aborts discard speculation)
            return (self.state == State.OK and B > 1 and n_total - j >= B
                    and self._predict_pose() is None)

        def dispatch(j):
            snap = self._tracking_snapshot()
            t0 = time.perf_counter()
            outs_fn, pyr_fns = self._dispatch_chunk(imgs[j: j + B], snap)
            self.timer.add("frame_step", time.perf_counter() - t0, count=0)
            return (j, snap, outs_fn, pyr_fns)

        while i < n_total or inflight:
            while len(inflight) < depth and can_batch(next_i):
                inflight.append(dispatch(next_i))
                next_i += B
            if not inflight:
                results.append(self.track(imgs[i], timestamps[i]))
                i += 1
                next_i = i
                continue

            i0, snap, outs_fn, pyr_fns = inflight.pop(0)
            t0 = time.perf_counter()
            outs = outs_fn()          # ONE [B, packed] readback
            self.timer.add("frame_step", time.perf_counter() - t0, count=B)
            consumed, clean = 0, True
            for b in range(B):
                self.frame_id += 1
                set_frame(self.frame_id)
                self._cur_depth = None
                out_b = unpack_out(outs[b], cfg.max_track)
                ok, R, t, clean = self._consume_out(
                    out_b, snap.ids, timestamps[i0 + b], pyr_fns[b],
                    batch_mode=True, snap_xyz=snap.xyz)
                self._log(timestamps[i0 + b], R, t)
                results.append((self.state, R, t))
                consumed += 1
                if not clean:
                    # a fallback or a loss invalidated the rest of the
                    # chunk: its remaining frames re-run per frame
                    break
            i = i0 + consumed
            if not clean:
                # the host rewrote the carry (fallback / reloc / reset),
                # even on the chunk's last frame: the chunks chained from
                # the old device carry are discarded unread
                inflight.clear()
                next_i = i
        return results

    def _dispatch_chunk(self, frames, snap):
        """Queue B frame steps from the current carry against `snap`.
        Returns (a function giving the [B, packed] numpy outputs, a
        function per frame giving its stacked pyramid)."""
        cache = snap.ready_cache()
        self._carry, outs_fn, pyr_fns = self._frame_stepper().step_batch(
            frames, self._carry, cache)
        return outs_fn, pyr_fns

    def _consume_out(self, out, ids, ts, pyr_fn, batch_mode: bool = False,
                     snap_xyz=None):
        """Host bookkeeping for one frame's readback. `pyr_fn` gives the
        frame's stacked pyramid (a copy the caller may keep; only called on
        keyframe / fallback frames). In batch mode a clean keyframe does
        not rewrite the device carry (the later frames of the chunk already
        tracked past it; BA corrections flow through the map). Returns (ok,
        R, t, clean), clean False when the rest of a chunk must re-run."""
        cfg = self.cfg
        smap = self.map
        n = len(ids)
        n_inliers = int(out.n_inliers)
        tracked = out.tracked[:n]
        visible = out.visible[:n]
        uv = out.uv[:n]
        lvl = out.level[:n]
        self.debug = {
            "n_align_in": int(out.n_align_in), "align_n": int(out.align_n),
            "align_res": float(out.align_res), "n_cache": n,
            "n_visible": int(visible.sum()), "n_aligned": int(tracked.sum()),
            "n_inliers": n_inliers, "viz_uv": uv[tracked]}
        np.add.at(smap.pt_visible, ids[visible], 1)
        np.add.at(smap.pt_found, ids[tracked], 1)
        t_ids, t_uv, t_lvl = ids[tracked], uv[tracked], lvl[tracked]
        # world positions of the tracked points as the snapshot held them
        t_xyz = snap_xyz[:n][tracked] if snap_xyz is not None else None
        R_cur, t_cur = out.R, out.t

        recovered = False  # host changed the pose -> carry must be rewritten
        aborted = False    # batch mode: the later frames are invalid
        if n_inliers < cfg.min_track_inliers:
            pyr = pyr_fn()
            aborted = True
            # feature fallback ladder (reference Tracking.cc:563-577)
            fb = self._feature_fallback(pyr, out.R_pred, out.t_pred)
            if fb is not None:
                R_cur, t_cur, t_ids, t_uv, t_lvl = fb
                t_xyz = None   # fallback matches are not snapshot-aligned
                n_inliers = len(t_ids)
                recovered = True
                self.debug["n_inliers_feat"] = n_inliers
                np.add.at(smap.pt_found, t_ids, 1)
                np.add.at(smap.pt_visible, t_ids, 1)
            elif self._on_vision_failed(pyr, ts, out.R_pred, out.t_pred):
                # the IMU kept the state alive (vision-weak mode) — unless
                # the subclass escalated to relocalization and recovered
                # another pose, with the tracking state rebuilt there
                rp = self._recovered_pose_override
                if rp is not None:
                    self._recovered_pose_override = None
                    return True, rp[0], rp[1], False
                self._set_last_frame(pyr, out.R_pred, out.t_pred,
                                     cache_uv=None)
                return True, out.R_pred, out.t_pred, False
            else:
                last_R, last_t = self._last_R, self._last_t
                self.state = State.LOST
                # reset-on-early-loss: a map of <= 5 KFs is not worth
                # relocalizing against
                if smap.n_kf <= 5 and not self.localization_only:
                    self.reset()
                    self.state = State.NOT_INITIALIZED
                return False, last_R, last_t, False
        # sensor fusion (mono-VI: the NavState optimization over the
        # tracked observations and the preintegration factor)
        fused = self._fuse_pose(R_cur, t_cur, t_ids, t_uv, t_lvl, xyz=t_xyz)
        if fused is not None:
            R_cur, t_cur = fused
            recovered = True
        self.state = State.OK
        Rl_inv = self._last_R.T
        self._vel = (np.asarray(R_cur @ Rl_inv, np.float32),
                     np.asarray(t_cur - (R_cur @ Rl_inv) @ self._last_t,
                                np.float32))
        if self._need_new_keyframe(ts, n_inliers, t_ids, R_cur, t_cur):
            with self.timer.stage("keyframe"):
                R_cur, t_cur = self._create_keyframe(pyr_fn(), ts, R_cur,
                                                     t_cur, t_ids, t_uv,
                                                     t_lvl)
            recovered = True
        if recovered and (not batch_mode or aborted):
            # the host changed the pose (fallback / fusion / keyframe BA):
            # rebuild the device carry from host state
            self._set_last_frame(pyr_fn(), R_cur, t_cur,
                                 cache_uv=(t_ids, t_uv))
        elif recovered:
            # clean in-batch keyframe: the device carry keeps the
            # uncorrected chain, so the host pose mirror keeps it too (the
            # corrected pose still goes to the caller and the trajectory)
            self._last_R = np.asarray(out.R, np.float32)
            self._last_t = np.asarray(out.t, np.float32)
        else:
            # the carry already advanced on the device
            self._last_R = np.asarray(R_cur, np.float32)
            self._last_t = np.asarray(t_cur, np.float32)
        return True, R_cur, t_cur, not aborted

    def _need_new_keyframe(self, ts, n_inliers, t_ids, R_cur, t_cur) -> bool:
        """Keyframe decision (reference NeedNewKeyFrame): c1a = long gap;
        c1b = min gap AND mapper idle; c1c = weak tracking or close-point
        starvation (stereo / RGB-D); c2 = tracked fraction below kf_ratio
        of the reference KF. The IMU cTimeGap (> 0.5 s) comes from the
        mono-VI subclass."""
        cfg = self.cfg
        if self.localization_only:
            return False
        gap = self.frame_id - self._last_kf_frame
        if gap < cfg.kf_min_gap:
            return False
        if gap >= cfg.kf_max_gap:               # c1a: hard cap
            return True
        mapper_idle = self._tail_idle()
        if self._kf_time_gap(ts) and mapper_idle:   # cTimeGap (VIO)
            return True
        c1b = mapper_idle
        c1c = (n_inliers < 50
               or self._need_close_points(t_ids, R_cur, t_cur))
        c2 = (n_inliers < cfg.kf_ratio * self._kf_ref_tracked
              or n_inliers < 50)
        if not (c1b or c1c) or not c2:
            return False
        # queue limit: while the mapper is busy, only weak tracking justifies
        # queueing another keyframe (the tail is one job deep)
        return mapper_idle or n_inliers < 50

    def _need_close_points(self, t_ids, R_cur, t_cur, min_close: int = 100,
                           min_candidates: int = 70) -> bool:
        """Stereo / RGB-D c1c term (reference Tracking.cc:1445-1460): few
        tracked close points (z < ThDepth) AND enough close-depth candidates
        that a new keyframe would seed some (estimated from the depth
        source: the direct path extracts no features per frame)."""
        if not self._depth_source_available() or len(t_ids) == 0:
            return False
        Xc = self.map.pt_xyz[t_ids] @ np.asarray(R_cur).T + np.asarray(t_cur)
        if int((Xc[:, 2] < self._th_depth()).sum()) >= min_close:
            return False
        return self._close_candidates() >= min_candidates

    def _close_candidates(self) -> int:
        """Estimated feature-rate close-depth candidates in this frame:
        RGB-D samples its depth map on a 16-px grid scaled to the feature
        budget; stereo (no depth map) assumes they exist (the keyframe's
        disparity search decides)."""
        depth = self._cur_depth
        if depth is None or not hasattr(depth, "shape"):
            return 1 << 30
        d = np.asarray(depth)[::16, ::16]
        frac = float(((d > 0.1) & (d < self._th_depth())).mean())
        return int(frac * self.cfg.n_features)

    def _set_last_frame(self, pyr, R, t, cache_uv):
        """Rebuild the device carry from host state (init / fallback /
        keyframe): the last pose, velocity, and the alignment points."""
        smap = self.map
        cap = self.cfg.max_track
        self._last_R = np.array(R, np.float32)
        self._last_t = np.array(t, np.float32)
        uv = np.zeros((cap, 2), np.float32)
        Xc = np.zeros((cap, 3), np.float32)
        valid = np.zeros(cap, bool)
        if cache_uv is None:
            # fresh after init: project the cached map points
            ids = self._cache
            Xc_all = smap.pt_xyz[ids] @ self._last_R.T + self._last_t
            uvp = np.stack([
                self.cam.fx * Xc_all[:, 0] / Xc_all[:, 2] + self.cam.cx,
                self.cam.fy * Xc_all[:, 1] / Xc_all[:, 2] + self.cam.cy], -1)
            m = min(len(ids), cap)
            uv[:m] = uvp[:m]
            Xc[:m] = Xc_all[:m]
        else:
            ids, uvs = cache_uv
            m = min(len(ids), cap)
            uv[:m] = uvs[:m]
            Xc[:m] = smap.pt_xyz[ids[:m]] @ self._last_R.T + self._last_t
        valid[:m] = Xc[:m, 2] > 0.1
        self._carry = make_carry(pyr, self._last_R, self._last_t, uv, Xc,
                                 valid, Rv=self._vel[0], tv=self._vel[1])

    def _rebuild_cache(self):
        """Refill the direct cache with local-map points (reference
        SearchLocalPointsDirect) and upload their tracking state once."""
        smap = self.map
        if smap.n_kf == 0:
            return
        ref_kf = self._last_kf if self._last_kf >= 0 else smap.n_kf - 1
        pts = smap.points_in_kfs(smap.local_window(ref_kf, 10))
        if len(pts) > self.cfg.max_track:
            pts = pts[np.argsort(-smap.pt_obs[pts])[: self.cfg.max_track]]
        self._cache = pts
        self._upload_cache()

    def _upload_cache(self):
        """Pack the cached points' tracking state (CACHE_COLS layout) into
        one device tensor and publish the snapshot. Called under the map
        lock (or before the worker exists)."""
        smap = self.map
        ids = self._cache
        pad = self.cfg.max_track - len(ids)

        def g(a):
            return np.concatenate(
                [a[ids], np.zeros((pad,) + a.shape[1:], a.dtype)])

        xyz = g(smap.pt_xyz)
        packed = pack_cache_np(
            xyz, g(smap.pt_valid), g(smap.pt_patch), g(smap.pt_ref_uv),
            g(smap.pt_ref_level), g(smap.pt_ref_R), g(smap.pt_ref_t))
        self._cache_dev = self._t(packed)
        self._cache_xyz_host = xyz
        self._publish_snapshot()

    def _publish_snapshot(self):
        """Publish the Snapshot the frame step tracks against."""
        smap = self.map
        ref = self._last_kf
        if 0 <= ref < smap.n_kf:
            Rk, tk = smap.kf_R[ref].copy(), smap.kf_t[ref].copy()
        else:
            ref, Rk, tk = -1, np.eye(3, dtype=np.float32), \
                np.zeros(3, np.float32)
        self._snap = Snapshot(self._cache, self._cache_dev, ref, Rk, tk,
                              self._cache_xyz_host, self._record_event(),
                              threading.current_thread() is self._map_worker)

    # ------------------------------------------------ feature-method fallbacks
    def _match_points_to_feats(self, pt_ids, R, t, f, radius, ratio=0.9,
                               max_dist=matching.TH_HIGH, cap=1024):
        """Project map points with (R, t) and window-match their
        descriptors against the frame's features (batched
        ORBmatcher::SearchByProjection). Returns (point ids, slots)."""
        smap = self.map
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        if len(pt_ids) == 0:
            return empty
        Xc = smap.pt_xyz[pt_ids] @ R.T + t
        z = Xc[:, 2]
        zc = np.maximum(z, 1e-6)
        uvp = np.stack([self.cam.fx * Xc[:, 0] / zc + self.cam.cx,
                        self.cam.fy * Xc[:, 1] / zc + self.cam.cy],
                       -1).astype(np.float32)
        inb = ((z > 0.1) & (uvp[:, 0] > 10) & (uvp[:, 0] < self.cam.width - 10)
               & (uvp[:, 1] > 10) & (uvp[:, 1] < self.cam.height - 10))
        pt_ids = np.asarray(pt_ids)[inb]
        uvp = uvp[inb]
        if len(pt_ids) == 0:
            return empty
        n = min(len(pt_ids), cap)
        descA = np.zeros((cap, 256), np.uint8)
        uvA = np.zeros((cap, 2), np.float32)
        vA = np.zeros(cap, bool)
        descA[:n] = smap.pt_desc[pt_ids[:n]]
        uvA[:n] = uvp[:n]
        vA[:n] = True
        idx, ok = matching.match_with_windows(
            self._t(descA), self._t(vA), self._t(f["desc"]),
            self._t(f["valid"]), uv_pred1=self._t(uvA), uv2=self._t(f["uv"]),
            radius=radius, max_dist=max_dist, ratio=ratio, mutual=True)
        idx = idx.cpu().numpy()[:n]
        rows = np.nonzero(ok.cpu().numpy()[:n])[0]
        return pt_ids[:n][rows], idx[rows].astype(np.int64)

    def _pose_opt_matches(self, pt_ids, slots, f, R0, t0):
        """Pose-only GN over point->feature matches. Returns (result,
        per-match inlier mask, n used)."""
        cap = self.cfg.max_track
        n = min(len(pt_ids), cap)
        X = np.zeros((cap, 3), np.float32)
        uv = np.zeros((cap, 2), np.float32)
        is2 = np.ones(cap, np.float32)
        val = np.zeros(cap, bool)
        X[:n] = self.map.pt_xyz[pt_ids[:n]]
        uv[:n] = f["uv"][slots[:n]]
        is2[:n] = 0.25 ** f["level"][slots[:n]]
        val[:n] = True
        res = pose_optimization(
            self._t(X), self._t(uv), self._t(is2), self._t(val),
            self._t(R0, torch.float32), self._t(t0, torch.float32), self.intr)
        return res, res.inliers.cpu().numpy()[:n], n

    def _feature_fallback(self, pyr, R_pred, t_pred):
        """Escalation on direct-tracking failure: extract features once,
        then motion model -> reference KF -> feature local-map tracking.
        Returns (R, t, pt_ids, uv, lvl) or None (-> LOST)."""
        if self.map.n_kf == 0:
            return None
        f = self._feats_to_dict(self.extractor(pyr))
        pose = self._track_with_motion_model(f, R_pred, t_pred)
        self.debug["fb_motion"] = pose is not None
        if pose is None:
            pose = self._track_reference_keyframe(f)
            self.debug["fb_refkf"] = pose is not None
        if pose is None:
            return None
        out = self._track_local_map_features(f, *pose)
        self.debug["fb_localmap"] = out is not None
        return out

    def _track_with_motion_model(self, f, R_pred, t_pred,
                                 min_matches: int = 20,
                                 min_inliers: int = 10):
        """Window-match the cached points at the predicted pose; widen the
        window when matches are scarce or the consensus is weak."""
        with self._locked():
            ids = self._cache.copy()
        best_n, best_res = 0, None
        for radius in (15.0, 30.0):
            pt_ids, slots = self._match_points_to_feats(
                ids, R_pred, t_pred, f, radius=radius, ratio=0.9)
            if len(pt_ids) < min_matches:
                continue
            res, _, _ = self._pose_opt_matches(pt_ids, slots, f, R_pred,
                                               t_pred)
            n_inl = int(res.n_inliers)
            if n_inl > best_n:
                best_n, best_res = n_inl, res
            if n_inl >= min_inliers and n_inl >= 0.6 * len(pt_ids):
                return self._pose_np(res.R, res.t)
        if best_res is None or best_n < min_inliers:
            return None
        return self._pose_np(best_res.R, best_res.t)

    def _frame_groups(self, f):
        """Quantize a frame's descriptors and return their FeatureVector
        group ids (cached in f["groups"]): the frame side of node-gated
        SearchByBoW."""
        if self.bow_index is None:
            return None
        if "groups" not in f:
            wid, _ = self.bow_index.quantize(f["desc"], f["valid"])
            f["groups"] = self.bow_index.groups_of(wid)
        return f["groups"]

    def _kf_groups(self, kf):
        """Device group ids of keyframe kf's feature slots, or None when
        the BoW index does not hold it."""
        bow = self.bow_index
        if bow is None or kf >= len(bow.kf_valid) or not bow.kf_valid[kf]:
            return None
        return self._t(bow.feat_groups(kf))

    def _track_reference_keyframe(self, f, min_matches: int = 15,
                                  min_inliers: int = 10):
        """Node-gated BoW match against the reference KF's bound features
        (ORBmatcher::SearchByBoW: a group-gated mutual NN with the 0.7
        ratio) + pose opt from the last pose."""
        kf = self._last_kf
        smap = self.map
        # the newest keyframe's descriptors are placeholders while the
        # worker runs its deferred extraction: take the newest ready one
        while kf >= 0 and (not smap.kf_valid[kf]
                           or smap.kf_feat_pending[kf]):
            kf -= 1
        if kf < 0:
            return None
        g1 = self._kf_groups(kf)
        g2 = None if g1 is None else self._t(self._frame_groups(f))
        with self._locked():
            bound = smap.kf_feat_pt[kf] >= 0
            if int(bound.sum()) < min_matches:
                return None
            self._join_mapper()
            fK = self.mapper.kf_dev_feats(smap, kf)
            idx, ok = matching.match_with_windows(
                fK["desc"], self._t(bound), self._t(f["desc"]),
                self._t(f["valid"]), max_dist=matching.TH_LOW, ratio=0.7,
                ang1=fK["angle"], ang2=self._t(f["angle"]), mutual=True,
                groups1=g1, groups2=g2)
            idx = idx.cpu().numpy()
            rows = np.nonzero(ok.cpu().numpy())[0]
            if len(rows) < min_matches:
                return None
            pt_ids = smap.kf_feat_pt[kf, rows]
            slots = idx[rows]
            good = smap.pt_valid[pt_ids]
            pt_ids, slots = pt_ids[good], slots[good]
        if len(pt_ids) < min_matches:
            return None
        res, _, _ = self._pose_opt_matches(pt_ids, slots, f, self._last_R,
                                           self._last_t)
        if int(res.n_inliers) < min_inliers:
            return None
        return self._pose_np(res.R, res.t)

    def _track_local_map_features(self, f, R, t):
        """Feature-method TrackLocalMap: project the local map with the
        recovered pose, window-match, final pose opt. Returns (R, t,
        pt_ids, uv, lvl) or None."""
        with self._locked():
            self._join_mapper()
            self._rebuild_cache()
            ids = self._cache.copy()
        pt_ids, slots = self._match_points_to_feats(ids, R, t, f,
                                                    radius=8.0, ratio=0.8)
        if len(pt_ids) < self.cfg.min_track_inliers:
            return None
        res, inl, n = self._pose_opt_matches(pt_ids, slots, f, R, t)
        if int(res.n_inliers) < self.cfg.min_track_inliers:
            return None
        rows = np.nonzero(inl)[0]
        R_cur, t_cur = self._pose_np(res.R, res.t)
        return (R_cur, t_cur, pt_ids[:n][rows],
                f["uv"][slots[:n][rows]].astype(np.float32),
                f["level"][slots[:n][rows]].astype(np.int32))

    # ---------------------------------------------------------- relocalization
    def _relocalize(self, pyr) -> bool:
        """BoW candidates + EPnP RANSAC (reference Tracking::Relocalization):
        per candidate keyframe, node-gated matches -> PnP -> pose GN on the
        matches -> projection search over the candidate's local map until
        >= 50 inliers. Holds the map lock: it reads the index and the
        keyframes the worker writes."""
        if self.bow_index is None:
            return False
        with self._locked():
            self._join_mapper()
            return self._relocalize_locked(pyr)

    def _relocalize_locked(self, pyr) -> bool:
        smap = self.map
        f = self._feats_to_dict(self.extractor(pyr))
        wid, bow = self.bow_index.quantize(f["desc"], f["valid"])
        f["groups"] = self.bow_index.groups_of(wid)
        for kf in self.bow_index.reloc_candidates(bow, max_candidates=5):
            bound = smap.kf_feat_pt[kf] >= 0
            if bound.sum() < 15:
                continue
            fK = self.mapper.kf_dev_feats(smap, kf)
            idx, ok = matching.match_with_windows(
                self._t(f["desc"]), self._t(f["valid"]), fK["desc"],
                self._t(bound), max_dist=matching.TH_LOW, ratio=0.75,
                mutual=True, ang1=self._t(f["angle"]), ang2=fK["angle"],
                groups1=self._t(f["groups"]), groups2=self._kf_groups(kf))
            idx = idx.cpu().numpy()
            rows = np.nonzero(ok.cpu().numpy())[0]
            if len(rows) < 10:
                continue
            pt_ids = smap.kf_feat_pt[kf, idx[rows]]
            good = smap.pt_valid[pt_ids]
            rows, pt_ids = rows[good], pt_ids[good]
            if len(rows) < 10:
                continue
            cap = 512
            n = min(len(rows), cap)
            X = np.zeros((cap, 3), np.float32)
            uv = np.zeros((cap, 2), np.float32)
            valid = np.zeros(cap, bool)
            X[:n] = smap.pt_xyz[pt_ids[:n]]
            uv[:n] = f["uv"][rows[:n]]
            valid[:n] = True
            res = pnp_ransac(self._t(X), self._t(uv), self._t(valid),
                             self.intr, self._reloc_gen, min_inliers=15)
            if not bool(res.ok):
                continue
            R, t = self._pose_np(res.R, res.t)
            # verify with a pose GN on the BoW matches, then widen by
            # projection search until >= 50 inliers
            opt, _, _ = self._pose_opt_matches(pt_ids[:n], rows[:n], f, R, t)
            n_inl = int(opt.n_inliers)
            if n_inl < 10:
                continue
            R, t = self._pose_np(opt.R, opt.t)
            for radius in (10.0, 20.0):
                if n_inl >= 50:
                    break
                local_pts = smap.points_in_kfs(smap.local_window(kf, 10))
                m_ids, m_slots = self._match_points_to_feats(
                    local_pts, R, t, f, radius=radius, ratio=0.85)
                if len(m_ids) < 20:
                    continue
                opt, _, _ = self._pose_opt_matches(m_ids, m_slots, f, R, t)
                n_inl = int(opt.n_inliers)
                R, t = self._pose_np(opt.R, opt.t)
            if n_inl < 50:
                continue
            self._vel = (np.eye(3, dtype=np.float32),
                         np.zeros(3, np.float32))
            self._last_kf = kf
            self._rebuild_cache()
            self._set_last_frame(pyr, R, t, cache_uv=None)
            return True
        return False

    # -------------------------------------------------------------- keyframes
    def _extract_kf_features(self, pyr, uv_pad, lvl_pad, val_pad):
        """Descriptors at the tracked positions + fresh features in the
        unoccupied image area."""
        ang, desc, nf = self.extractor.extract_keyframe(
            pyr, self._t(uv_pad), self._t(lvl_pad), self._t(val_pad))
        nf = self._feats_to_dict(nf)
        feats = {
            "uv": np.concatenate([uv_pad, nf["uv"]]),
            "level": np.concatenate([lvl_pad, nf["level"]]),
            "angle": np.concatenate([ang.cpu().numpy(), nf["angle"]]),
            "desc": np.concatenate([desc.cpu().numpy(), nf["desc"]]),
            "valid": np.concatenate([val_pad, nf["valid"]]),
        }
        feats["ur"] = self._feature_ur(feats, pyr)
        return feats

    def _extract_into_kf(self, smap, kf, pyr, uv_pad, lvl_pad, val_pad):
        """The worker's half of a deferred keyframe extraction: the full
        feature set, written into the (already added) keyframe's rows
        before its mapping tail, so triangulation, fusion and BoW see
        complete descriptors. Dropped when reset() swapped the map."""
        feats = self._extract_kf_features(pyr, uv_pad, lvl_pad, val_pad)
        with self._locked():
            if smap is not self.map or kf >= smap.n_kf:
                return
            mm = min(len(feats["uv"]), smap.max_feat)
            smap.kf_feat_uv[kf, :mm] = feats["uv"][:mm]
            smap.kf_feat_level[kf, :mm] = feats["level"][:mm]
            smap.kf_feat_desc[kf, :mm] = feats["desc"][:mm]
            smap.kf_feat_angle[kf, :mm] = feats["angle"][:mm]
            smap.kf_feat_valid[kf, :mm] = feats["valid"][:mm]
            smap.kf_feat_ur[kf, :mm] = feats["ur"][:mm]
            smap.kf_feat_pending[kf] = False
            smap.kf_feat_version[kf] += 1

    def _create_keyframe(self, pyr, ts, R, t, tracked_ids, tracked_uv,
                         tracked_lvl):
        """Insert a keyframe and run its mapping tail: inline (returns the
        KF's post-BA pose) or queued to the worker (returns its pre-BA
        pose). With the worker, a monocular keyframe's extraction is
        deferred to it too: the tracking thread records the skeleton (pose
        and tracked binds) only."""
        smap = self.map
        cfg = self.cfg
        cap = cfg.max_track
        m = min(len(tracked_ids), cap)
        uv_pad = np.zeros((cap, 2), np.float32)
        lvl_pad = np.zeros(cap, np.int32)
        val_pad = np.zeros(cap, bool)
        uv_pad[:m] = tracked_uv[:m]
        lvl_pad[:m] = tracked_lvl[:m]
        val_pad[:m] = True
        # depth-seeded modes extract inline (this frame's depth seeds the
        # keyframe's points now)
        defer = (self._map_worker is not None
                 and not self._depth_source_available()
                 and not self.localization_only)
        if defer:
            feats = {"uv": uv_pad, "level": lvl_pad, "valid": val_pad,
                     "angle": np.zeros(cap, np.float32),
                     "desc": np.zeros((cap, 256), np.uint8),
                     "ur": np.full(cap, -1.0, np.float32)}
        else:
            feats = self._extract_kf_features(pyr, uv_pad, lvl_pad, val_pad)
        with self._locked():
            kf = smap.add_keyframe(R, t, feats, ts=ts,
                                   frame_id=self.frame_id, pyramid=pyr)
            # placeholder descriptor rows until the worker's extraction:
            # matching against them fails silently, so consumers skip them
            smap.kf_feat_pending[kf] = defer
            smap.bind(kf, np.arange(m), tracked_ids[:m])
            if self._depth_source_available():
                self._create_depth_points(smap, kf, pyr)
            self._last_kf = kf
            self._last_kf_frame = self.frame_id
            self._kf_ref_tracked = int((smap.kf_feat_pt[kf] >= 0).sum())
            self._publish_snapshot()
        # the mono-VI tracker records the keyframe's IMU window here, before
        # the worker can see the keyframe
        self._on_keyframe_created(kf, ts)
        if self._map_worker is None:
            self._mapping_tail(smap, kf, pyr)
            return smap.kf_R[kf].copy(), smap.kf_t[kf].copy()
        # the worker's stream starts after the keyframe's pyramid exists
        ready = self._record_event()
        frame = self.frame_id

        def tail_job():
            set_frame(frame)
            self.timer.add("mapping.queue_wait", time.perf_counter() - put_t,
                           start_ns=put_ns)
            with self.timer.stage("mapping.job"):
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    pyr.record_stream(stream)
                if defer:
                    with self.timer.stage("mapping.extract"):
                        self._extract_into_kf(smap, kf, pyr, uv_pad,
                                              lvl_pad, val_pad)
                self._mapping_tail(smap, kf, pyr)

        put_t, put_ns = time.perf_counter(), time.time_ns()
        self._map_queue.put(tail_job)
        # tracking keeps the pre-BA pose; corrections land through the map
        return smap.kf_R[kf].copy(), smap.kf_t[kf].copy()

    def stats(self) -> dict:
        """Structured counters: state, map size, loops closed, per-stage
        mean ms and the BA capacity drops."""
        smap = self.map
        return {
            "state": self.state.name,
            "frame_id": self.frame_id,
            "n_kf": int(smap.kf_valid[: smap.n_kf].sum()),
            "n_pt": int(smap.pt_valid[: smap.n_pt].sum()),
            "n_loops_closed": self.n_loops_closed,
            "cache_size": len(self._cache),
            "stage_ms": self.timer.mean_ms(),
            "ba_dropped": dict(self.mapper.dropped),
        }

    def _index_keyframe(self, kf):
        """Quantize keyframe kf and add it to the BoW index; returns its
        bow vector."""
        smap = self.map
        wid, bow = self.bow_index.quantize(smap.kf_feat_desc[kf],
                                           smap.kf_feat_valid[kf])
        self.bow_index.add_keyframe(kf, bow, feat_wid=wid)
        return bow

    def _mapping_tail(self, smap, kf, pyr):
        """LocalMapping duties for one keyframe of `smap`: triangulate,
        fuse, local BA, cull, refresh the direct patches, place recognition
        and loop closing, rebuild the cache. Inline or on the worker; holds
        the map lock throughout. A job queued before reset() swapped the
        map (or whose keyframe is gone) drops itself."""
        with self.timer.stage("mapping_tail"), self._locked():
            if smap is not self.map or kf >= smap.n_kf \
                    or not smap.kf_valid[kf]:
                return
            with self.timer.stage("mt_triangulate"):
                cov = smap.covisibility(kf)
                # skip partners whose deferred extraction has not run yet
                cov = np.where(smap.kf_feat_pending[: len(cov)], 0, cov)
                order = np.argsort(-cov)[:3]
                partners = [int(p) for p in order
                            if cov[p] > 0
                            or (p == self._last_kf
                                and not smap.kf_feat_pending[p])]
                self.mapper.create_points_multi(smap, kf, partners, pyr)
            with self.timer.stage("mt_fuse"):
                self.mapper.search_in_neighbors(smap, kf)
                smap.assign_parent(kf)
                self.mapper.update_distinctive_descriptors(smap, kf)
            with self.timer.stage("mt_local_ba"):
                self._run_local_ba(smap, kf)
            with self.timer.stage("mt_cull"):
                self.mapper.cull_points(smap)
                n_culled = self._cull_keyframes(smap, kf)
            if n_culled and self.bow_index is not None:
                # a culled keyframe must leave the BoW index too
                m = min(len(self.bow_index.kf_valid), smap.n_kf)
                self.bow_index.kf_valid[:m] &= smap.kf_valid[:m]
            # refresh direct patches of ALL points bound to this KF with the
            # POST-BA geometry
            with self.timer.stage("mt_patches"):
                slots = np.nonzero(smap.kf_feat_pt[kf] >= 0)[0]
                self.mapper.refresh_patches(smap, kf, pyr,
                                            smap.kf_feat_pt[kf, slots], slots)
            if self.bow_index is not None:
                self._place_recognition(kf, pyr)
            self._rebuild_cache()
            if self._map_worker is not None and kf == self._last_kf:
                # C-ref15: the keyframe decision's reference count covers
                # the points this tail bound to the reference keyframe, as
                # the reference's TrackedMapPoints does, not only the
                # tracked ones it was created with (the JAX count stays at
                # a weak keyframe's few inliers, and no keyframe follows
                # until kf_max_gap)
                self._kf_ref_tracked = int((smap.kf_feat_pt[kf] >= 0).sum())

    # -------------------------------------------------------- sensor hooks
    # The mono-VI tracker (frontend/vi_tracker.py) overrides these.
    _recovered_pose_override = None

    def _predict_pose(self):
        """Pose prediction override (mono-VI: IMU propagation). Return
        (R_pred, t_pred) or None to use the velocity model."""
        return None

    def _fuse_pose(self, R_cur, t_cur, ids, uv, lvl, xyz=None):
        """Sensor-fusion refinement of the visually tracked pose. `xyz`:
        the tracked points' world positions as the frame step's snapshot
        held them (None: read the live map). Return (R, t) or None to keep
        the visual pose."""
        return None

    def _on_vision_failed(self, pyr, ts, R_pred, t_pred) -> bool:
        """Called when direct tracking and the fallback ladder fail. Return
        True to keep tracking on the predicted pose (IMU dead-reckoning);
        False -> LOST."""
        return False

    def _kf_time_gap(self, ts) -> bool:
        """IMU cTimeGap (mono-VI: a keyframe after 0.5 s)."""
        return False

    def _on_keyframe_created(self, kf, ts):
        """Called after a keyframe is added, before its mapping tail."""

    def _on_map_corrected(self):
        """Called before the first frame that tracks against a snapshot the
        async worker published after a mapping tail (its BA moved the
        map)."""

    def _run_local_ba(self, smap, kf):
        """Local BA of the mapping tail; the mono-VI tracker swaps in the
        NavState window BA once VINS-initialized."""
        self.mapper.local_ba(smap, kf)

    def _cull_keyframes(self, smap, kf):
        """Keyframe culling of the mapping tail; the mono-VI tracker adds
        the IMU-chain guards and merges culled keyframes' IMU windows."""
        return self.mapper.cull_keyframes(smap, kf)

    def _place_recognition(self, kf, pyr):
        """Index the keyframe; with loop closing on, test it for a loop and,
        on an accepted one, correct it, then run a global BA (the
        reference's RunGlobalBundleAdjustment) and refresh the keyframe's
        patches against the corrected map."""
        smap = self.map
        with self.timer.stage("mt_loop"):
            bow = self._index_keyframe(kf)
            closed = (self.cfg.enable_loop_closing
                      and self.loop_closer.process_keyframe(smap, kf, bow))
        if not closed:
            return
        self.n_loops_closed += 1
        with self.timer.stage("global_ba"):
            self.mapper.global_ba(smap)
        slots = np.nonzero(smap.kf_feat_pt[kf] >= 0)[0]
        self.mapper.refresh_patches(smap, kf, pyr, smap.kf_feat_pt[kf, slots],
                                    slots)
        self._vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))

    # ------------------------------------------------------------ depth seeds
    def _feature_ur(self, f, pyr):
        """Per-feature right-image u coordinate u_r (the reference's
        mvuRight); -1 = monocular. The RGB-D (depth lookup) and stereo
        (disparity search) trackers override it; these feed the 3-row
        (u, v, u_r) BA edges."""
        return np.full(len(f["uv"]), -1.0, np.float32)

    def _depth_source_available(self) -> bool:
        return self._cur_depth is not None

    def _feature_depths(self, smap, kf, slots):
        """Per-slot metric depths for depth-seeded point creation: a lookup
        in the frame's depth map (the stereo tracker overrides it)."""
        return _depth_at(self._cur_depth, smap.kf_feat_uv[kf, slots])

    def _th_depth(self) -> float:
        """Metric close/far threshold: bf / fx * ThDepth (reference
        Tracking.cc mThDepth); a wide absolute default when bf is unset."""
        if self.cam.bf > 0:
            return self.cam.bf / self.cam.fx * self.cfg.th_depth
        return 40.0

    def _create_depth_points(self, smap, kf, pyr, min_points: int = 100):
        """Map points for the unbound features of kf with a valid depth.
        Close points (z < ThDepth) are always inserted, far ones nearest
        first until `min_points` in all (reference CreateNewKeyFrame's
        close/far policy). Returns the points created."""
        unbound = smap.kf_feat_valid[kf] & (smap.kf_feat_pt[kf] < 0)
        slots = np.nonzero(unbound)[0]
        if len(slots) == 0:
            return 0
        d = self._feature_depths(smap, kf, slots)
        uv = smap.kf_feat_uv[kf, slots]
        lvl = smap.kf_feat_level[kf, slots]
        ok = (d > 0.1) & np.isfinite(d) & self.mapper.patch_in_bounds(uv, lvl)
        slots, uv, d = slots[ok], uv[ok], d[ok]
        if len(slots) == 0:
            return 0
        order = np.argsort(d)                   # nearest first
        keep = (d[order] < self._th_depth()) | (np.arange(len(order))
                                                < min_points)
        sel = order[keep]
        slots, uv, d = slots[sel], uv[sel], d[sel]
        xn = np.stack([(uv[:, 0] - self.cam.cx) / self.cam.fx,
                       (uv[:, 1] - self.cam.cy) / self.cam.fy], -1)
        Xc = np.concatenate([xn * d[:, None], d[:, None]], -1)
        Xw = (Xc - smap.kf_t[kf]) @ smap.kf_R[kf]     # R^T (Xc - t)
        ids = smap.alloc_points(len(slots))
        smap.pt_xyz[ids] = Xw.astype(np.float32)
        smap.pt_valid[ids] = True
        smap.pt_first_kf[ids] = kf
        smap.pt_desc[ids] = smap.kf_feat_desc[kf, slots]
        smap.bind(kf, slots, ids)
        self.mapper.refresh_patches(smap, kf, pyr, ids, slots)
        return len(slots)


class RgbdTracker(MonoTracker):
    """RGB-D tracking: instant metric initialization from the depth map
    (reference Tracking::StereoInitialization), then the same direct
    pipeline; new map points are seeded from depth at every keyframe, with
    triangulation as a complement for far features."""

    # Without Camera.bf the depth would seed points but give no 3-row BA
    # edges, and local BA's scale would drift (pinned only by the fixed
    # ring): a virtual baseline turns every depth into a pseudo-stereo u_r
    VIRTUAL_BASELINE_M = 0.08

    def __init__(self, cam: cam_mod.Camera, cfg: TrackerConfig = None,
                 device="cuda"):
        if cam.bf <= 0:
            cam = cam._replace(bf=self.VIRTUAL_BASELINE_M * cam.fx)
        super().__init__(cam, cfg, device=device)

    def _try_initialize(self, pyr, ts) -> bool:
        if not self._depth_source_available():
            return False
        smap = self.map
        f = self._feats_to_dict(self.extractor(pyr))
        if int(f["valid"].sum()) < 100:
            return False
        f["ur"] = self._feature_ur(f, pyr)
        kf0 = smap.add_keyframe(np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32), f, ts=ts,
                                frame_id=self.frame_id, pyramid=pyr)
        n = self._create_depth_points(smap, kf0, pyr)
        if n < 50:
            return False
        if self.cfg.enable_loop_closing or self.cfg.enable_relocalization:
            self.bow_index = BowIndex(
                self._build_vocabulary(f["desc"][f["valid"]]),
                max_kf=smap.max_kf, device=self.device)
            self.loop_closer = LoopCloser(self.bow_index, self.cam,
                                          device=self.device)
            self._index_keyframe(kf0)
        self.state = State.OK
        self._last_kf = kf0
        self._last_kf_frame = self.frame_id
        self._kf_ref_tracked = n
        self._rebuild_cache()
        self._set_last_frame(pyr, smap.kf_R[kf0], smap.kf_t[kf0],
                             cache_uv=None)
        self._vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        return True

    def _feature_ur(self, f, pyr):
        """Pseudo-stereo from the depth map: u_r = u - bf / z where z > 0.1
        (reference Frame::ComputeStereoFromRGBD)."""
        if self._cur_depth is None:
            return super()._feature_ur(f, pyr)
        uv = np.asarray(f["uv"])
        z = _depth_at(self._cur_depth, uv)
        ok = np.asarray(f["valid"]) & (z > 0.1) & np.isfinite(z)
        ur = uv[:, 0] - self.cam.bf / np.maximum(z, 1e-6)
        return np.where(ok, ur, -1.0).astype(np.float32)


class StereoTracker(RgbdTracker):
    """Stereo tracking on rectified, undistorted pairs: feature depths come
    from the batched disparity search (ops/stereo.py; the reference's
    Frame::ComputeStereoMatches). Initialization and point seeding reuse
    the depth-seeded path, with the metric scale from the baseline."""

    _cur_right = None     # this frame's right image

    def __init__(self, cam: cam_mod.Camera, cfg: TrackerConfig = None,
                 device="cuda"):
        # the depths are bf / disparity: a rig without its baseline would
        # get RgbdTracker's virtual one and a wrong metric scale
        if cam.bf <= 0:
            raise ValueError("StereoTracker needs Camera.bf (baseline * fx) "
                             "of the rectified pair")
        super().__init__(cam, cfg, device=device)

    def track(self, img, ts: float, depth=None, right=None):
        self._cur_right = right
        return super().track(img, ts, depth=depth)

    def _depth_source_available(self) -> bool:
        return self._cur_right is not None

    def _feature_ur(self, f, pyr):
        """Disparity search of every feature against this frame's right
        image, on the tracker's device; u_r = u - disparity."""
        if self._cur_right is None:
            return MonoTracker._feature_ur(self, f, pyr)
        with self.timer.stage("stereo_match"):
            disp, ok = stereo_match_features(
                level0(pyr, self.cam.height),
                self._t(np.asarray(self._cur_right, np.float32)),
                self._t(f["uv"]), self._t(f["valid"]))
            disp = disp.cpu().numpy()
            ok = ok.cpu().numpy() & (disp > 0.1)
        ur = np.asarray(f["uv"])[:, 0] - disp
        return np.where(ok, ur, -1.0).astype(np.float32)

    def _feature_depths(self, smap, kf, slots):
        """Depths from the stored stereo u_r: d = bf / (u - u_r)."""
        ur = smap.kf_feat_ur[kf, slots]
        disp = smap.kf_feat_uv[kf, slots, 0] - ur
        d = np.where((ur >= 0) & (disp > 0.1),
                     self.cam.bf / np.maximum(disp, 1e-3), -1.0)
        return d.astype(np.float32)
