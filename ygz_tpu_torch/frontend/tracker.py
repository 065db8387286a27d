"""Monocular tracking front-end: host state machine over batched device steps.

Port of ``ygz_tpu/frontend/tracker.py::MonoTracker`` for the monocular VO
main path: initialize (ORB + two-view) -> per frame the fused step
(sparse alignment seeded by the last frame, direct local-map tracking with a
point cache, pose GN) -> keyframe decision -> synchronous mapping tail
(triangulation, fusion, local BA, culling, patch refresh). When direct
tracking fails, the feature fallback ladder (motion model -> reference KF
-> feature local map) runs before the tracker declares itself LOST.

Not ported yet (ROADMAP queue A): relocalization and BoW, loop closing,
the async mapping worker, ``track_batch``, the octree keypoint mode,
multi-device BA, and the stereo/RGB-D/VI subclasses.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from ..backend.mapping import LocalMapper
from ..backend.mapstate import SlamMap
from ..backend.optim import pose_optimization
from ..geometry import camera as cam_mod
from ..geometry.twoview import two_view_reconstruct
from ..ops import matching
from ..utils.profiling import StageTimer
from .extractor import OrbExtractor
from .framestep import (build_pyramid_stacked, frame_step, make_carry,
                        pack_cache_np, pack_pred_np, unpack_out)


class State(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackerConfig:
    """The JAX package's tracker settings. The port accepts the monocular
    VO subset: keypoint_mode 'grid', mesh_devices <= 1, loop closing,
    relocalization and async mapping off (their defaults here); anything
    else raises NotImplementedError. track_batch is accepted and unused."""
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
    ba_window: int = 6
    enable_loop_closing: bool = False
    enable_relocalization: bool = False
    async_mapping: bool = False
    track_batch: int = 8
    mesh_devices: int = 0

    def check_supported(self):
        unsupported = {
            "keypoint_mode": (self.keypoint_mode != "grid",
                              "19 (periphery: select_octree)"),
            "mesh_devices": (self.mesh_devices > 1, "20 (distributed BA)"),
            "enable_loop_closing": (self.enable_loop_closing,
                                    "16 (loop closing)"),
            "enable_relocalization": (self.enable_relocalization,
                                      "15 (relocalization)"),
            "async_mapping": (self.async_mapping,
                              "19 (periphery: the async mapping worker)"),
        }
        for name, (bad, item) in unsupported.items():
            if bad:
                raise NotImplementedError(
                    f"TrackerConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet: ROADMAP queue A, item {item}")


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
        self.cfg.check_supported()
        self.device = torch.device(device)
        self.intr = (cam.fx, cam.fy, cam.cx, cam.cy)
        self.extractor = OrbExtractor(
            n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
            scale_factor=self.cfg.scale_factor, fast_th=self.cfg.fast_th,
            fast_th_min=self.cfg.fast_th_min, mode=self.cfg.keypoint_mode)
        self.map = SlamMap(max_feat=1024)
        self.mapper = LocalMapper(cam, n_levels=self.cfg.n_levels,
                                  window=self.cfg.ba_window,
                                  device=self.device)
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
        self._snap = None     # (ids, device cache, ref kf, Rk, tk, xyz)
        self._carry = None    # framestep.FrameCarry on the device
        self._no_pred = torch.as_tensor(pack_pred_np(), device=self.device)
        self.debug = {}
        self.timer = StageTimer()
        self._last_kf = -1
        self._last_kf_frame = -1
        self._kf_ref_tracked = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)

    def reset(self, keep_trajectory: bool = True):
        """Clear map and tracking state (reference Tracking::Reset)."""
        traj = self.trajectory if keep_trajectory else []
        # bake relative-pose records to absolute against the dying map
        for rec in traj:
            if rec.ref_kf >= 0:
                rec.R, rec.t = self.recovered_pose(rec)
                rec.ref_kf, rec.R_r, rec.t_r = -1, None, None
        fid = self.frame_id
        self.__init__(self.cam, self.cfg, self.device)
        self.trajectory = traj
        self.frame_id = fid

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
    def track(self, img, ts: float):
        """Process one grayscale frame. Returns (state, R, t) with (R, t)
        the world->camera pose (identity until initialized)."""
        self.frame_id += 1
        if self.state == State.NOT_INITIALIZED:
            with self.timer.stage("pyramid"):
                pyr = self._build_pyramid(img)
            ok = self._try_initialize(pyr, ts)
            R = self.map.kf_R[self.map.n_kf - 1] if ok else np.eye(3)
            t = self.map.kf_t[self.map.n_kf - 1] if ok else np.zeros(3)
            self._log(ts, R, t)
            return self.state, R, t
        if self.state == State.LOST:
            # relocalization is not ported: a LOST tracker stays LOST
            self._log(ts, self._last_R, self._last_t)
            return self.state, self._last_R, self._last_t
        ok, R, t = self._track_frame(img, ts)
        self._log(ts, R, t)
        return self.state, R, t

    def _log(self, ts, R, t):
        R = np.array(R, np.float32)
        t = np.array(t, np.float32)
        ref, R_r, t_r = -1, None, None
        snap = self._snap
        if self.state == State.OK and snap is not None and snap[2] >= 0:
            # relative pose against the ref KF pose as tracked against
            ref, Rk, tk = snap[2], snap[3], snap[4]
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
        Rk, tk = self.map.resolve_pose(rec.ref_kf)
        return rec.R_r @ Rk, rec.R_r @ tk + rec.t_r

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
    def _track_frame(self, img, ts):
        """Steady-state frame: one fused frame step on the device and ONE
        readback of its packed output."""
        cfg = self.cfg
        if len(self._snap[0]) < cfg.cache_refill_below:
            self._rebuild_cache()
        snap = self._snap
        ids, dev = snap[0], snap[1]
        with self.timer.stage("frame_step"):
            self._carry, out = frame_step(
                self._t(img), self._carry, dev, self._no_pred, self._remap,
                self.intr, n_levels=cfg.n_levels,
                scale_factor=cfg.scale_factor, min_align=cfg.min_align_points)
            out = unpack_out(out.cpu().numpy(), cfg.max_track)
        return self._consume_out(out, ids, ts, snap_xyz=snap[5])

    def _consume_out(self, out, ids, ts, snap_xyz=None):
        """Host bookkeeping for one frame's readback. Returns (ok, R, t)."""
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
        R_cur, t_cur = out.R, out.t
        pyr = self._carry.pyr          # this frame's stacked pyramid

        recovered = False  # host changed the pose -> carry must be rewritten
        if n_inliers < cfg.min_track_inliers:
            # feature fallback ladder (reference Tracking.cc:563-577)
            fb = self._feature_fallback(pyr, out.R_pred, out.t_pred)
            if fb is None:
                last_R, last_t = self._last_R, self._last_t
                self.state = State.LOST
                # reset-on-early-loss: a map of <= 5 KFs is not worth keeping
                if smap.n_kf <= 5:
                    self.reset()
                    self.state = State.NOT_INITIALIZED
                return False, last_R, last_t
            R_cur, t_cur, t_ids, t_uv, t_lvl = fb
            n_inliers = len(t_ids)
            recovered = True
            self.debug["n_inliers_feat"] = n_inliers
            np.add.at(smap.pt_found, t_ids, 1)
            np.add.at(smap.pt_visible, t_ids, 1)
        self.state = State.OK
        Rl_inv = self._last_R.T
        self._vel = (np.asarray(R_cur @ Rl_inv, np.float32),
                     np.asarray(t_cur - (R_cur @ Rl_inv) @ self._last_t,
                                np.float32))
        if self._need_new_keyframe(n_inliers):
            with self.timer.stage("keyframe"):
                R_cur, t_cur = self._create_keyframe(pyr, ts, R_cur, t_cur,
                                                     t_ids, t_uv, t_lvl)
            recovered = True
        if recovered:
            self._set_last_frame(pyr, R_cur, t_cur, cache_uv=(t_ids, t_uv))
        else:
            # the carry already advanced on the device
            self._last_R = np.asarray(R_cur, np.float32)
            self._last_t = np.asarray(t_cur, np.float32)
        return True, R_cur, t_cur

    def _need_new_keyframe(self, n_inliers) -> bool:
        """Keyframe decision (reference NeedNewKeyFrame) for the synchronous
        monocular tracker: the mapper is always idle, so after the minimum
        gap a KF is due at the hard cap or when tracking weakens (c2)."""
        cfg = self.cfg
        gap = self.frame_id - self._last_kf_frame
        if gap < cfg.kf_min_gap:
            return False
        if gap >= cfg.kf_max_gap:
            return True
        return (n_inliers < cfg.kf_ratio * self._kf_ref_tracked
                or n_inliers < 50)

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
        one device tensor and publish the snapshot."""
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
        """Snapshot the frame step tracks against: cache ids, device cache,
        reference KF and its pose."""
        smap = self.map
        ref = self._last_kf
        if 0 <= ref < smap.n_kf:
            Rk, tk = smap.kf_R[ref].copy(), smap.kf_t[ref].copy()
        else:
            ref, Rk, tk = -1, np.eye(3, dtype=np.float32), \
                np.zeros(3, np.float32)
        self._snap = (self._cache, self._cache_dev, ref, Rk, tk,
                      self._cache_xyz_host)

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

    def _track_reference_keyframe(self, f, min_matches: int = 15,
                                  min_inliers: int = 10):
        """Mutual descriptor match against the reference KF's bound
        features (no BoW node gate: the vocabulary is not ported) + pose
        opt from the last pose."""
        kf = self._last_kf
        smap = self.map
        while kf >= 0 and not smap.kf_valid[kf]:
            kf -= 1
        if kf < 0:
            return None
        bound = smap.kf_feat_pt[kf] >= 0
        if int(bound.sum()) < min_matches:
            return None
        fK = self.mapper.kf_dev_feats(smap, kf)
        idx, ok = matching.match_with_windows(
            fK["desc"], self._t(bound), self._t(f["desc"]),
            self._t(f["valid"]), max_dist=matching.TH_LOW, ratio=0.7,
            ang1=fK["angle"], ang2=self._t(f["angle"]), mutual=True)
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
        feats["ur"] = np.full(len(feats["uv"]), -1.0, np.float32)
        return feats

    def _create_keyframe(self, pyr, ts, R, t, tracked_ids, tracked_uv,
                         tracked_lvl):
        """Insert a keyframe, run the mapping tail, and return the KF's
        post-BA pose."""
        smap = self.map
        cap = self.cfg.max_track
        m = min(len(tracked_ids), cap)
        uv_pad = np.zeros((cap, 2), np.float32)
        lvl_pad = np.zeros(cap, np.int32)
        val_pad = np.zeros(cap, bool)
        uv_pad[:m] = tracked_uv[:m]
        lvl_pad[:m] = tracked_lvl[:m]
        val_pad[:m] = True
        feats = self._extract_kf_features(pyr, uv_pad, lvl_pad, val_pad)
        kf = smap.add_keyframe(R, t, feats, ts=ts, frame_id=self.frame_id,
                               pyramid=pyr)
        smap.bind(kf, np.arange(m), tracked_ids[:m])
        self._last_kf = kf
        self._last_kf_frame = self.frame_id
        self._kf_ref_tracked = int((smap.kf_feat_pt[kf] >= 0).sum())
        self._publish_snapshot()
        self._mapping_tail(kf, pyr)
        return smap.kf_R[kf].copy(), smap.kf_t[kf].copy()

    def _mapping_tail(self, kf, pyr):
        """LocalMapping duties for one keyframe: triangulate, fuse, local
        BA, cull, refresh the direct patches, rebuild the cache."""
        smap = self.map
        with self.timer.stage("mapping_tail"):
            with self.timer.stage("mt_triangulate"):
                cov = smap.covisibility(kf)
                order = np.argsort(-cov)[:3]
                partners = [int(p) for p in order
                            if cov[p] > 0 or p == self._last_kf]
                self.mapper.create_points_multi(smap, kf, partners, pyr)
            with self.timer.stage("mt_fuse"):
                self.mapper.search_in_neighbors(smap, kf)
                smap.assign_parent(kf)
                self.mapper.update_distinctive_descriptors(smap, kf)
            with self.timer.stage("mt_local_ba"):
                self.mapper.local_ba(smap, kf)
            with self.timer.stage("mt_cull"):
                self.mapper.cull_points(smap)
                self.mapper.cull_keyframes(smap, kf)
            # refresh direct patches of ALL points bound to this KF with the
            # POST-BA geometry
            with self.timer.stage("mt_patches"):
                slots = np.nonzero(smap.kf_feat_pt[kf] >= 0)[0]
                self.mapper.refresh_patches(smap, kf, pyr,
                                            smap.kf_feat_pt[kf, slots], slots)
            self._rebuild_cache()
