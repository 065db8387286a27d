"""Monocular-inertial tracking (mono-VI).

Port of ``ygz_tpu/frontend/vi_tracker.py``, the reference's VIO layer on
top of the monocular tracker (Tracking.cc GrabImageMonoVI,
PredictNavStateByIMU, TrackLocalMap*WithIMU; LocalMapping::TryInitVIO):

  * before VINS init: monocular visual tracking while IMU windows accumulate
    per keyframe (a keyframe at least every 0.5 s);
  * VINS init (imu/vins_init.py) recovers gyro bias, metric scale, gravity
    and accelerometer bias; the whole map and trajectory are rescaled to
    metric, NavStates are instantiated along the keyframe chain, and a
    full-chain NavState BA runs;
  * after init: IMU propagation predicts each frame's pose, the frame step
    refines it visually, and the 15-DoF NavState optimizer fuses vision,
    preintegration and the marginalized prior (backend/vio_optim.py); each
    keyframe runs the NavState window BA;
  * when vision fails, the state is propagated by IMU alone for at most
    DR_MAX_S, then relocalization takes over; the first fused update after
    an outage re-anchors to vision when the dead-reckoned state is more
    than DR_REANCHOR_GAP_M away.

The IMU numerics run on the tracker's device; the filter's state (the
NavState at the last frame, biases, prior) is host numpy, as in the JAX
package. With ``async_mapping`` the keyframe chain is written under the
map lock, VINS init runs against a drained mapping queue, and frames run
on the per-frame path (``track_batch`` refuses batching under the IMU
predictor, as the JAX package does).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..backend.vio_optim import (vio_pose_optimization,
                                 vio_pose_optimization_pair, vio_window_ba)
from ..geometry import camera as cam_mod
from ..imu.navstate import NavState
from ..imu.preintegration import PreintState, predict_navstate, preintegrate
from ..imu.vins_init import vins_initialize
from .tracker import MonoTracker, TrackerConfig

FRAME_IMU_CAP = 64
KF_IMU_CAP = 512


def _pack_window(samples, prev_t, cap):
    """samples: [(t, gyro[3], acc[3])] -> padded arrays (om, ac, dts,
    valid)."""
    n = min(len(samples), cap)
    om = np.zeros((cap, 3), np.float32)
    ac = np.zeros((cap, 3), np.float32)
    dts = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    t_prev = prev_t
    for i in range(n):
        t, g, a = samples[i]
        om[i] = g
        ac[i] = a
        dts[i] = np.clip(t - t_prev, 1e-4, 0.05)
        valid[i] = True
        t_prev = t
    return om, ac, dts, valid


class MonoViTracker(MonoTracker):
    # vision-recovery consistency gate: max position gap (m) between the
    # dead-reckoned state and the map-anchored visual pose before the
    # inertial chain is declared broken and the filter re-anchors to vision
    # (~3 sigma of honest 1 s preintegration drift)
    DR_REANCHOR_GAP_M = 0.5
    # maximum pure-IMU operation before escalating to relocalization:
    # double-integrated IMU error grows ~t^2, so beyond ~1 s dead-reckoning
    # is no pose estimate (the reference escalates this class of failure to
    # Relocalization, Tracking.cc:684-698, :1826)
    DR_MAX_S = 1.0
    # the NavState window BA (reference LocalMapping.LocalWindowSize)
    W_CAP = 10
    BA_L = 2048
    BA_O = 4096

    def __init__(self, cam: cam_mod.Camera, cfg: TrackerConfig = None,
                 Tbc: np.ndarray = None, gravity_mag: float = 9.810,
                 vins_init_kfs: int = 8, vins_init_time: float = 5.0,
                 device="cuda"):
        super().__init__(cam, cfg, device=device)
        self.Tbc = np.eye(4, dtype=np.float32) if Tbc is None \
            else np.asarray(Tbc, np.float32)
        self.Rbc = self.Tbc[:3, :3]
        self.tbc = self.Tbc[:3, 3]
        # camera-from-body (for the optimizers' reprojection)
        self.Rcb = self.Rbc.T
        self.tcb = -self.Rbc.T @ self.tbc
        self.gravity_mag = gravity_mag
        self.vins_init_kfs = vins_init_kfs
        self.vins_init_time = vins_init_time

        # the reference disables loop CORRECTION under IMU (the Sim3
        # essential-graph rewrite would fight the metric scale and gravity
        # alignment; LoopClosing.cc:70-78). BoW indexing still runs for
        # relocalization.
        self.cfg.enable_loop_closing = False

        self.vio_ready = False
        self.gravity_w: Optional[np.ndarray] = None
        self.bg = np.zeros(3, np.float32)
        self.ba = np.zeros(3, np.float32)
        self._ns: Optional[tuple] = None   # (P, V, R) body state, last frame
        self._pred_body: Optional[tuple] = None   # IMU-propagated (P, V, R)
        self._prior_info = np.eye(15, dtype=np.float32)
        self._has_prior = False
        self._prior_mean = None
        # last frame's (X, uv, is2, valid) for the two-state optimization
        self._prev_obs = None
        # dead-reckoning bookkeeping: start time and frame count of the
        # current vision outage (None / 0 while vision is healthy)
        self._dr_since = None
        self._dr_frames = 0
        self._imu_frame = []        # samples since the last frame
        self._imu_since_kf = []     # samples since the last keyframe
        self._frame_pre: Optional[PreintState] = None
        self._last_frame_ts = None
        self._kf_imu = {}           # kf id -> packed window (since prev KF)
        self._kf_raw = {}           # kf id -> raw (t, gyro, acc) samples
        self._kf_order = []
        self._kf_ns = {}            # kf id -> (P, V, R) after VINS init
        self.vins_scale = None
        self._init_kwargs = dict(Tbc=Tbc, gravity_mag=gravity_mag,
                                 vins_init_kfs=vins_init_kfs,
                                 vins_init_time=vins_init_time)

    def recovered_pose(self, rec):
        """VI frames export the LIVE fused pose: loop correction and global
        BA are off under IMU, and composing fused frame poses onto the
        window BA's keyframe poses measured 3-30x worse in the JAX package
        (the reference's own VI export is keyframe NavStates only,
        SaveKeyFrameTrajectoryNavState)."""
        return rec.R, rec.t

    def _reinit(self):
        self.__init__(self.cam, self.cfg, device=self.device,
                      **self._init_kwargs)

    # ------------------------------------------------------------------ utils
    def _preintegrate(self, windows, bg, ba):
        """Preintegrate packed windows [(om, ac, dts, valid)] as one batch
        on the device (bg, ba: [3] host arrays)."""
        om, ac, dts, valid = (np.stack(a) for a in zip(*windows))
        n = int(valid.sum(-1).max()) if valid.size else 0
        with self.timer.stage("preint"):
            return preintegrate(self._t(om), self._t(ac), self._t(dts),
                                self._t(valid), self._t(bg, torch.float32),
                                self._t(ba, torch.float32), n_steps=n)

    # ------------------------------------------------------------------ entry
    def track(self, img, ts: float, imu=None, depth=None):
        """imu: iterable of (t, gyro[3], acc[3]) with t <= ts, since the
        previous frame."""
        if imu is not None:
            self._imu_frame = list(imu)
            self._imu_since_kf.extend(self._imu_frame)
        # the frame's preintegration feeds only the initialized filter
        if self.vio_ready:
            prev_ts = self._last_frame_ts if self._last_frame_ts is not None \
                else (self._imu_frame[0][0] if self._imu_frame else ts)
            self._frame_pre = self._preintegrate(
                [_pack_window(self._imu_frame, prev_ts, FRAME_IMU_CAP)],
                self.bg, self.ba).take(0)
        out = super().track(img, ts, depth=depth)
        # start the keyframe-IMU chain at the map-initialization keyframe
        if not self._kf_order and self.map.n_kf >= 2:
            self._kf_order = [self.map.n_kf - 1]
            self._imu_since_kf = []
        self._last_frame_ts = ts
        self._imu_frame = []
        # maintain the body NavState estimate at the (now) last frame
        self._update_navstate_from_pose()
        return out

    # ----------------------------------------------------------- conversions
    def _cam_to_body(self, R_cw, t_cw):
        R_wc = R_cw.T
        p_wc = -R_wc @ t_cw
        R_wb = R_wc @ self.Rbc.T
        P_wb = p_wc + R_wc @ (-self.Rbc.T @ self.tbc)
        return R_wb, P_wb

    def _body_to_cam(self, R_wb, P_wb):
        R_wc = R_wb @ self.Rbc
        p_wc = P_wb + R_wb @ self.tbc
        R_cw = R_wc.T
        t_cw = -R_cw @ p_wc
        return R_cw.astype(np.float32), t_cw.astype(np.float32)

    def _update_navstate_from_pose(self):
        if self._last_R is None:
            return
        if self._ns is None or not self.vio_ready:
            R_wb, P_wb = self._cam_to_body(self._last_R, self._last_t)
            self._ns = (P_wb.astype(np.float32), np.zeros(3, np.float32),
                        R_wb.astype(np.float32))

    # ------------------------------------------------------------ vio hooks
    def _predict_pose(self):
        if not self.vio_ready or self._ns is None:
            return None
        P, V, R = self._ns
        z = self._t(np.zeros(3, np.float32))
        ns = NavState(P=self._t(P), V=self._t(V), R=self._t(R),
                      bg=self._t(self.bg), ba=self._t(self.ba), dbg=z, dba=z)
        ns2 = predict_navstate(ns, self._frame_pre,
                               self._t(self.gravity_w, torch.float32))
        h = torch.cat([ns2.P, ns2.V, ns2.R.reshape(9)]).cpu().numpy()
        self._pred_body = (h[0:3], h[3:6], h[6:15].reshape(3, 3))
        return self._body_to_cam(self._pred_body[2], self._pred_body[0])

    def _gather_obs(self, ids, uv, lvl, xyz=None):
        """Pad tracked observations to the fixed cap for the optimizers.
        `xyz`: the positions the frame step tracked against; None reads the
        live map under the lock (an unlocked read could see half of a
        worker's BA commit)."""
        cap = self.cfg.max_track
        n = min(len(ids), cap)
        X = np.zeros((cap, 3), np.float32)
        uvp = np.zeros((cap, 2), np.float32)
        is2 = np.ones(cap, np.float32)
        val = np.zeros(cap, bool)
        if xyz is not None:
            X[:n] = xyz[:n]
        else:
            with self._locked():
                X[:n] = self.map.pt_xyz[ids[:n]]
        uvp[:n] = uv[:n]
        is2[:n] = 0.25 ** lvl[:n]
        val[:n] = True
        return X, uvp, is2, val

    def _state_t(self, P, V, R, bg, ba):
        return tuple(self._t(np.asarray(a, np.float32))
                     for a in (P, V, R, bg, ba))

    def _fuse_pose(self, R_cur, t_cur, ids, uv, lvl, xyz=None):
        if not self.vio_ready or self._ns is None:
            return None
        if self._dr_frames > 0:
            # first fused update after a dead-reckoning outage: gate the
            # open-loop inertial state against the map-anchored visual pose
            R_vis, P_vis = self._cam_to_body(R_cur, t_cur)
            P_dr = self._ns[0]
            gap = float(np.linalg.norm(P_vis - P_dr))
            self.debug["dr_gap"] = gap
            self._dr_since = None
            self._dr_frames = 0
            if gap > self.DR_REANCHOR_GAP_M:
                # inertial chain broken: re-anchor at the visual pose; keep
                # the dead-reckoned velocity only if it is still sane
                V_dr = self._ns[1]
                V = V_dr if float(np.linalg.norm(V_dr)) < 10.0 \
                    else np.zeros(3, np.float32)
                self._ns = (P_vis.astype(np.float32),
                            np.asarray(V, np.float32),
                            R_vis.astype(np.float32))
                self._has_prior = False
                self._prev_obs = None
                self.debug["dr_reanchored"] = gap
                return None     # adopt the visual pose unfused this frame
        P0, V0, R0 = self._ns
        R_wb, P_wb = self._cam_to_body(R_cur, t_cur)
        # velocity init: the IMU propagation
        Vc = V0 if self._pred_body is None else self._pred_body[1]

        X, uvp, is2, val = self._gather_obs(ids, uv, lvl, xyz=xyz)
        cur0 = self._state_t(P_wb, Vc, R_wb, self.bg, self.ba)
        prev = self._state_t(P0, V0, R0, self.bg, self.ba)
        prior_mean = self._prior_mean if self._has_prior else prev
        common = dict(Rcb=self._t(self.Rcb), tcb=self._t(self.tcb),
                      intr=self.intr,
                      gw=self._t(self.gravity_w, torch.float32))
        bias_lin = (self._t(self.bg), self._t(self.ba))
        obs = (self._t(X), self._t(uvp), self._t(is2), self._t(val))
        with self.timer.stage("vio_fuse"):
            if self._prev_obs is not None:
                # the reference semantics: two free NavStates + the
                # marginal prior on the previous one, reprojection on both
                # frames, the previous state Schur-marginalized out
                res = vio_pose_optimization_pair(
                    cur0, prev, self._frame_pre, bias_lin, prior_mean,
                    self._t(self._prior_info), self._has_prior,
                    *(self._t(a) for a in self._prev_obs), *obs, **common)
                info = res.prior_info
            else:
                # no previous-frame observations (first frame after init or
                # a reset): single-state optimization, previous held fixed
                res = vio_pose_optimization(
                    cur0, prev, self._frame_pre, bias_lin, prior_mean,
                    self._t(self._prior_info), self._has_prior, *obs,
                    **common)
                info = None
            flat = [res.P, res.V, res.R.reshape(9), res.bg, res.ba]
            if info is not None:
                flat.append(info.reshape(225))
            h = torch.cat(flat).cpu().numpy()      # one readback
        P1, V1, R1 = h[0:3], h[3:6], h[6:15].reshape(3, 3)
        self.bg = h[15:18].astype(np.float32)
        self.ba = h[18:21].astype(np.float32)
        if info is not None:
            # the marginal excludes the current frame's vision rows, so it
            # carries undiscounted into the next step
            self._prior_mean = self._state_t(P1, V1, R1, self.bg, self.ba)
            self._prior_info = h[21:246].reshape(15, 15)
            self._has_prior = True
        else:
            self._has_prior = False
        self._ns = (P1, V1, R1)
        # the current observations become the next frame's previous-frame
        # reprojection set
        self._prev_obs = (X, uvp, is2, val)
        return self._body_to_cam(R1, P1)

    def _kf_time_gap(self, ts) -> bool:
        """cTimeGap (reference Tracking.cc:1402-1525): with the IMU running,
        a keyframe after 0.5 s keeps the preintegration links short. From
        the first frame on: before VINS init it feeds the initializer its
        keyframe chain."""
        if self._last_kf < 0:
            return False
        return ts - float(self.map.kf_ts[self._last_kf]) > 0.5

    def _on_vision_failed(self, pyr, ts, R_pred, t_pred) -> bool:
        if not self.vio_ready:
            return False
        if self._dr_since is None:
            self._dr_since = ts
        if ts - self._dr_since > self.DR_MAX_S:
            # dead-reckoning budget exhausted: try relocalization against
            # the map right now; failing that, go LOST (the tracker then
            # relocalizes on the next frames)
            self.debug["dr_escalated"] = True
            self._dr_since = None
            self._dr_frames = 0
            if self.cfg.enable_relocalization:
                with self.timer.stage("relocalize"):
                    ok = self._relocalize(pyr)
                if ok:
                    # hand the recovered pose (not the dead-reckoned
                    # prediction) back to the frame consumer
                    self._recovered_pose_override = (self._last_R.copy(),
                                                     self._last_t.copy())
                    return True
            return False        # -> LOST
        # IMU dead-reckoning: adopt the propagated state
        self._dr_frames += 1
        if self._pred_body is not None:
            P, V, R = self._pred_body
            self._ns = (P.astype(np.float32), V.astype(np.float32),
                        R.astype(np.float32))
        self._has_prior = False
        self._prev_obs = None
        return True

    def _relocalize(self, pyr) -> bool:
        """Relocalization also RE-ANCHORS the inertial filter: fusing the
        next frame against a divergent NavState would drag the recovered
        pose away again."""
        ok = super()._relocalize(pyr)
        if ok and self.vio_ready:
            R_wb, P_wb = self._cam_to_body(self._last_R, self._last_t)
            self._ns = (P_wb.astype(np.float32), np.zeros(3, np.float32),
                        R_wb.astype(np.float32))
            self._has_prior = False
            self._prev_obs = None
            self._dr_since = None
            self._dr_frames = 0
        return ok

    # ------------------------------------------------------------- keyframes
    def _on_keyframe_created(self, kf, ts):
        """Record this keyframe's IMU window before its mapping tail is run
        or queued (the worker's window BA must see a complete chain); the
        chain is shared with the worker under the map lock."""
        with self._locked():
            prev_t = self.map.kf_ts[self._kf_order[-1]] if self._kf_order \
                else (self._imu_since_kf[0][0] if self._imu_since_kf else ts)
            self._kf_imu[kf] = _pack_window(self._imu_since_kf, prev_t,
                                            KF_IMU_CAP)
            self._kf_raw[kf] = list(self._imu_since_kf)
            self._kf_order.append(kf)
            self._imu_since_kf = []

    def _on_map_corrected(self):
        """The worker's window BA moved the map under the filter: the
        marginal prior and the previous frame's landmarks belong to the
        map before it, so drop them, as the synchronous tail does right
        after its keyframe's BA."""
        self._has_prior = False
        self._prev_obs = None

    def _create_keyframe(self, pyr, ts, R, t, tracked_ids, tracked_uv,
                         tracked_lvl):
        super()._create_keyframe(pyr, ts, R, t, tracked_ids, tracked_uv,
                                 tracked_lvl)
        kf = self._last_kf
        if not self.vio_ready:
            if self._map_worker is not None:
                # VINS init rewrites the whole map (rescale): run it only
                # against a drained mapping queue
                self.wait_mapping_idle()
            with self.timer.stage("vins_init"), self._locked():
                self._try_vins_init()
        # the window BA at this keyframe rewrote poses and points: the
        # carried marginal prior and the previous frame's landmark snapshot
        # are stale against it (the reference likewise drops the frame
        # prior right after a keyframe, Tracking.cc:1264-1340)
        self._has_prior = False
        self._prev_obs = None
        # VINS init may have rescaled the map and run the NavState BA
        return self.map.kf_R[kf].copy(), self.map.kf_t[kf].copy()

    def _cull_keyframes(self, smap, kf):
        """KeyFrameCulling with the reference's VIO guards (LocalMapping.cc
        :1439-1450): never cull the direct previous chain keyframe of the
        current one, keyframes within 0.15 s of it, or the last 10 chain
        keyframes. A culled keyframe's IMU samples are prepended to its
        successor's window (KeyFrame::AppendIMUDataToFront)."""
        protect = set()
        if self._kf_order:
            if len(self._kf_order) >= 2 and self._kf_order[-1] == kf:
                protect.add(self._kf_order[-2])
            ts_cur = smap.kf_ts[kf]
            for k in self._kf_order:
                if smap.kf_ts[k] >= ts_cur - 0.15:
                    protect.add(k)
            protect.update(self._kf_order[-10:])
        n = self.mapper.cull_keyframes(smap, kf, protect=protect)
        if n:
            self._merge_culled_imu(smap)
        return n

    def _merge_culled_imu(self, smap):
        """Rebuild the keyframe IMU chain after culling: each dead keyframe's
        raw samples are prepended to the next surviving keyframe's window,
        which is re-packed against its new predecessor's timestamp."""
        order = self._kf_order
        if all(smap.kf_valid[k] for k in order):
            return
        pending = []
        new_order = []
        for k in order:
            if smap.kf_valid[k]:
                if pending:
                    self._kf_raw[k] = pending + self._kf_raw.get(k, [])
                    if new_order:
                        prev_t = smap.kf_ts[new_order[-1]]
                    elif self._kf_raw[k]:
                        prev_t = self._kf_raw[k][0][0]
                    else:
                        prev_t = smap.kf_ts[k]
                    self._kf_imu[k] = _pack_window(self._kf_raw[k], prev_t,
                                                   KF_IMU_CAP)
                    pending = []
                new_order.append(k)
            else:
                pending = pending + self._kf_raw.pop(k, [])
                self._kf_imu.pop(k, None)
                self._kf_ns.pop(k, None)
        # trailing pending samples (the last chain keyframe culled) can only
        # occur if the culler ignored the protect set: they are dropped
        self._kf_order = new_order

    def _kf_preints(self, bg):
        """The chain links' preintegrations at gyro bias bg, as one batch
        [len(chain) - 1]."""
        return self._preintegrate([self._kf_imu[k] for k in self._kf_order[1:]],
                                  bg, np.zeros(3, np.float32))

    def _try_vins_init(self):
        smap = self.map
        kfs = self._kf_order
        if len(kfs) < self.vins_init_kfs:
            return
        if smap.kf_ts[kfs[-1]] - smap.kf_ts[kfs[0]] < self.vins_init_time:
            return
        # pre-init visual global BA (the reference runs one before every
        # TryInitVIO estimate, LocalMapping.cc:212): the least-squares
        # solves are sensitive to pose noise
        self.mapper.global_ba(smap)
        R_wc = [smap.kf_R[k].T for k in kfs]
        c_w = np.stack([-smap.kf_R[k].T @ smap.kf_t[k] for k in kfs])
        res = vins_initialize(
            c_w, R_wc, self._kf_preints(np.zeros(3, np.float32)),
            lambda bg: self._kf_preints(np.asarray(bg, np.float32)),
            self.Tbc)
        if not res.ok or res.scale <= 0.01:
            return
        # sanity: recovered gravity magnitude near g
        if abs(np.linalg.norm(res.gravity_w) - self.gravity_mag) > 2.0:
            return
        # quality gate: a large disagreement between the step-2 linear scale
        # and the step-3 refined one, or a high normalized residual, means
        # the window's excitation cannot pin the scale; retry at the next
        # keyframe (the reference waits 15 s of data instead)
        s_ratio = res.scale / max(res.scale_linear, 1e-9)
        if res.res_norm > 0.25 or not (0.7 < s_ratio < 1.4):
            self.debug["vins_init_rejected"] = (float(res.res_norm),
                                                float(s_ratio))
            return

        s = res.scale
        # rescale the whole map to metric (reference TryInitVIO :516-531)
        smap.pt_xyz[: smap.n_pt] *= s
        smap.kf_t[: smap.n_kf] *= s
        smap.sync_ref_poses()
        # and the trajectory log: the absolute snapshots and the
        # keyframe-relative translations (Tracking.cc:421-426)
        for rec in self.trajectory:
            rec.t = rec.t * s
            if rec.t_r is not None:
                rec.t_r = rec.t_r * s
        # the host pose and velocity mirrors; the device carry is rebuilt
        # from them and the rescaled points after this keyframe
        # (MonoTracker._consume_out -> _set_last_frame)
        self._last_t = self._last_t * s
        Rv, tv = self._vel
        self._vel = (Rv, tv * s)
        self.bg = res.bg
        self.ba = res.ba
        self.gravity_w = res.gravity_w.astype(np.float32)
        self.vins_scale = s

        # velocity at the last frame from the scaled displacement
        if len(self.trajectory) >= 2:
            a = self.trajectory[-2]
            b = self.trajectory[-1]
            ca = -a.R.T @ a.t  # records already rescaled above
            cb = -b.R.T @ b.t
            dt = max(b.ts - a.ts, 1e-3)
            v = (cb - ca) / dt
        else:
            v = np.zeros(3, np.float32)
        R_wb, P_wb = self._cam_to_body(self._last_R, self._last_t)
        self._ns = (P_wb.astype(np.float32), v.astype(np.float32),
                    R_wb.astype(np.float32))
        self._has_prior = False
        self.vio_ready = True

        # NavStates over the whole chain (the reference sets P/V/R/bias for
        # every keyframe at init, LocalMapping.cc:437-505; velocities by
        # finite differences of the now-metric positions)
        body = [self._cam_to_body(smap.kf_R[k], smap.kf_t[k]) for k in kfs]
        for i, k in enumerate(kfs):
            R_b, P_b = body[i]
            j = min(i + 1, len(kfs) - 1)
            h = max(i, j - 1)
            dt = max(float(smap.kf_ts[kfs[j]] - smap.kf_ts[kfs[h]]), 1e-3)
            V_b = (body[j][1] - body[h][1]) / dt
            self._kf_ns[k] = (P_b.astype(np.float32), V_b.astype(np.float32),
                              R_b.astype(np.float32))
        # post-init FULL-CHAIN NavState BA (the reference's
        # GlobalBundleAdjustmentNavState, LocalMapping.cc:615-713); W in
        # buckets, a chain longer than the largest truncated to its newest
        # 128 keyframes
        chain = [k for k in kfs if smap.kf_valid[k] and k in self._kf_ns]
        W_gba = next((w for w in (10, 16, 24, 32, 48, 64, 96, 128)
                      if w >= len(chain)), 128)
        chain = chain[-W_gba:]
        self._navstate_ba(smap, kfs[-1], chain, W_gba, iters=10)
        self._last_R, self._last_t = self._body_to_cam(self._ns[2],
                                                       self._ns[0])
        # the direct cache holds pre-rescale geometry
        self._rebuild_cache()

    # ------------------------------------------------------- VI window BA
    def _run_local_ba(self, smap, kf):
        if not self.vio_ready:
            return super()._run_local_ba(smap, kf)
        # record this keyframe's NavState: the live fused state while
        # tracking is still on its frame (always, with the synchronous
        # tail); otherwise derived from the stored pose and a finite
        # difference of the chain positions
        if kf not in self._kf_ns:
            if (self._ns is not None
                    and self.frame_id == int(smap.kf_frame_id[kf])):
                P, V, R = self._ns
                self._kf_ns[kf] = (P.copy(), V.copy(), R.copy())
            else:
                R_b, P_b = self._cam_to_body(smap.kf_R[kf], smap.kf_t[kf])
                prev = [k for k in self._kf_order
                        if k != kf and k in self._kf_ns]
                if prev:
                    kp = prev[-1]
                    dt = max(float(smap.kf_ts[kf] - smap.kf_ts[kp]), 1e-3)
                    _, P_prev = self._cam_to_body(smap.kf_R[kp],
                                                  smap.kf_t[kp])
                    V = ((P_b - P_prev) / dt).astype(np.float32)
                else:
                    V = np.zeros(3, np.float32)
                self._kf_ns[kf] = (P_b.astype(np.float32), V,
                                   R_b.astype(np.float32))
        chain = [k for k in self._kf_order
                 if k in self._kf_ns and smap.kf_valid[k]][-self.W_CAP:]
        if len(chain) < 3:
            return super()._run_local_ba(smap, kf)
        self._navstate_ba(smap, kf, chain, self.W_CAP)

    def _navstate_ba(self, smap, kf, chain, W, iters: int = 8):
        """Joint NavState + landmark BA over `chain` (<= W, padded).
        W = W_CAP is the reference's IMU local-window BA
        (LocalBundleAdjustmentNavState); W sized to the whole chain is the
        post-VINS-init GlobalBundleAdjustmentNavState."""
        n = len(chain)
        Pw = np.zeros((W, 3), np.float32)
        Vw = np.zeros((W, 3), np.float32)
        Rw = np.tile(np.eye(3, dtype=np.float32), (W, 1, 1))
        for i, k in enumerate(chain):
            Pw[i], Vw[i], Rw[i] = self._kf_ns[k]
        # pad by replicating the last state (links masked out)
        Pw[n:], Vw[n:], Rw[n:] = Pw[n - 1], Vw[n - 1], Rw[n - 1]
        bgw = np.tile(self.bg, (W, 1)).astype(np.float32)
        baw = np.tile(self.ba, (W, 1)).astype(np.float32)
        fixed = np.zeros(W, bool)
        fixed[0] = True          # the oldest window keyframe anchors the gauge
        fixed[n:] = True
        link_w = np.array([1.0] * (n - 1) + [0.0] * (W - n), np.float32)

        pt_ids = smap.points_in_kfs(chain)
        if len(pt_ids) == 0:
            return
        # the chain links' preintegrations at the current biases, padded
        # with identity links
        pre = self._preintegrate([self._kf_imu[k] for k in chain[1:]],
                                 self.bg, self.ba)
        pad = PreintState.zero((W - n,), device=self.device)
        pad = pad._replace(cov=torch.eye(9, device=self.device).expand(
            W - n, 9, 9))
        pre_fields = tuple(torch.cat([a, b]) for a, b in zip(pre, pad))

        if len(pt_ids) > self.BA_L:
            self.mapper.dropped["local_ba_points"] += len(pt_ids) - self.BA_L
            pt_ids = pt_ids[np.argsort(-smap.pt_obs[pt_ids])[: self.BA_L]]
        o_kf, o_pt, o_uv, o_lvl, _ = smap.observations(chain, pt_ids)
        if len(o_kf) > self.BA_O:
            # support-ranked capacity cut + counter (no silent caps)
            self.mapper.dropped["local_ba_obs"] += len(o_kf) - self.BA_O
            order = np.argsort(-smap.pt_obs[pt_ids[o_pt]],
                               kind="stable")[: self.BA_O]
            o_kf, o_pt, o_uv, o_lvl = (o_kf[order], o_pt[order],
                                       o_uv[order], o_lvl[order])
        L, O = self.BA_L, self.BA_O
        pts = np.zeros((L, 3), np.float32)
        ptv = np.zeros(L, bool)
        pts[: len(pt_ids)] = smap.pt_xyz[pt_ids]
        ptv[: len(pt_ids)] = True
        n_o = len(o_kf)
        obs_k = np.zeros(O, np.int64)
        obs_l = np.zeros(O, np.int64)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_w = np.zeros(O, np.float32)
        obs_k[:n_o] = o_kf
        obs_l[:n_o] = o_pt
        obs_uv[:n_o] = o_uv
        obs_w[:n_o] = 0.25 ** o_lvl

        with self.timer.stage("vio_ba"):
            res = vio_window_ba(
                self._t(Pw), self._t(Vw), self._t(Rw), self._t(bgw),
                self._t(baw), self._t(fixed), pre_fields,
                self._t(self.bg), self._t(self.ba), self._t(pts),
                self._t(ptv), self._t(obs_k), self._t(obs_l), self._t(obs_uv),
                self._t(obs_w), self._t(self.Rcb), self._t(self.tcb),
                self.intr, self._t(self.gravity_w, torch.float32),
                n_win=W, n_points=L, iters=iters, link_w=self._t(link_w))
            h = torch.cat([res.P.reshape(-1), res.V.reshape(-1),
                           res.R.reshape(-1),
                           res.points.reshape(-1)]).cpu().numpy()
        newP = h[: 3 * W].reshape(W, 3)
        newV = h[3 * W: 6 * W].reshape(W, 3)
        newR = h[6 * W: 15 * W].reshape(W, 3, 3)
        points = h[15 * W:].reshape(L, 3)
        for i, k in enumerate(chain):
            if fixed[i]:
                continue
            self._kf_ns[k] = (newP[i].copy(), newV[i].copy(), newR[i].copy())
            smap.set_pose(k, *self._body_to_cam(newR[i], newP[i]))
        smap.pt_xyz[pt_ids] = points[: len(pt_ids)]
        smap.sync_ref_poses()
        # keep the live frame NavState in sync with its (current) keyframe,
        # while tracking is still on that keyframe's frame
        if (chain[-1] == kf and not fixed[n - 1]
                and self.frame_id == int(smap.kf_frame_id[kf])):
            self._ns = self._kf_ns[kf]
