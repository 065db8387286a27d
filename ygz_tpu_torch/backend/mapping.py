"""Local mapping: triangulation of new points, fusion, local BA, culling.

Port of ``ygz_tpu/backend/mapping.py::LocalMapper``: the keyframe tail
and the global BA after a loop closure, dense or, with a mesh, through the
landmark-block-sharded distributed step (``parallel/dist_ba.py``).
The map stays host-resident numpy (``backend/mapstate.py``); each step
moves the rows it needs to ``self.device``, runs batched tensor numerics,
and writes the results back.
"""
from __future__ import annotations

import numpy as np
import torch

from .mapstate import REF_PATCH, SlamMap
from .optim import CHI2_MONO, local_bundle_adjustment
from ..frontend.direct_tracker import (capture_ref_patches_core,
                                       refine_matches_core)
from ..geometry.triangulation import triangulate_dlt, triangulation_checks
from ..ops import matching

BA_P = 8       # local BA pose capacity
BA_L = 2048    # landmark capacity
BA_O = 4096    # observation capacity


def _bucket(n, opts):
    """The smallest capacity in opts that holds n (the largest if none)."""
    for o in opts:
        if n <= o:
            return o
    return opts[-1]


def _retriangulate(PA, PB, uvA, uvB, RA, tA, RB, tB, K, med_depth, vmask):
    """Re-triangulate refined pairs and re-run the acceptance gates."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    X2 = triangulate_dlt(PA, PB, uvA, uvB)
    good, _ = triangulation_checks(
        RA, tA, RB, tB, X2, uvA, uvB, fx, fy, cx, cy,
        sigma2=1.0, reproj_chi2=CHI2_MONO, min_parallax_cos=0.99996)
    zA = (X2 @ RA.T + tA)[:, 2]
    good = (good & vmask & (zA > 0.05 * med_depth)
            & (zA < 20.0 * med_depth))
    return X2, good


def _fundamental_from_poses(RA, tA, RB, tB, K):
    """F with x_B^T F x_A = 0 for world->cam poses of A and B."""
    R = RB @ RA.T
    t = tB - R @ tA
    z = torch.zeros((), dtype=t.dtype, device=t.device)
    tx = torch.stack([torch.stack([z, -t[2], t[1]]),
                      torch.stack([t[2], z, -t[0]]),
                      torch.stack([-t[1], t[0], z])])
    Kinv = torch.linalg.inv(K)
    return Kinv.T @ tx @ R @ Kinv


def _projection(K, R, t):
    return K @ torch.cat([R, t[:, None]], 1)


def _epipolar_match_core(descA, uvA, levelA, validA,
                         descB, uvB, levelB, validB,
                         RA, tA, RB, tB, K, baseline_med_depth,
                         angA=None, angB=None):
    """Epipolar-gated mutual Hamming matching (+ rotation histogram) and
    DLT triangulation between two keyframes. Returns (idxB_for_A [NA],
    good [NA], Xw [NA, 3])."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    F = _fundamental_from_poses(RA, tA, RB, tB, K)
    l = torch.cat([uvA, torch.ones_like(uvA[:, :1])], -1) @ F.T   # [NA, 3]
    num = (l[:, None, 0] * uvB[None, :, 0] + l[:, None, 1] * uvB[None, :, 1]
           + l[:, None, 2]) ** 2
    den = torch.clamp(l[:, 0] ** 2 + l[:, 1] ** 2, min=1e-12)[:, None]
    sigma2B = (2.0 ** levelB.to(torch.float32)) ** 2
    pen = torch.where(num / den < 3.84 * sigma2B[None, :],
                      torch.zeros_like(num), torch.full_like(num,
                                                             matching.BIG))
    d = matching.hamming_matrix(descA, descB, validA, validB) + pen
    idx, ok = matching.nn_match(d, max_dist=matching.TH_LOW, ratio=0.6)
    idx21, _ = matching.nn_match(d.T, max_dist=matching.TH_LOW, ratio=0.6)
    idx, mok = matching.mutual_filter(idx, idx21)
    ok = ok & mok
    if angA is not None and angB is not None:
        ok = matching.rotation_consistency(angA, angB, idx, ok)
        idx = torch.where(ok, idx, torch.full_like(idx, -1))
    uvBm = uvB[torch.clamp(idx, 0, uvB.shape[0] - 1).long()]
    Xw = triangulate_dlt(_projection(K, RA, tA), _projection(K, RB, tB),
                         uvA, uvBm)
    good, _ = triangulation_checks(
        RA, tA, RB, tB, Xw, uvA, uvBm, fx, fy, cx, cy,
        sigma2=1.0, reproj_chi2=CHI2_MONO, min_parallax_cos=0.999976)
    zA = (Xw @ RA.T + tA)[:, 2]
    good = (good & ok & (zA > 0.05 * baseline_med_depth)
            & (zA < 20.0 * baseline_med_depth))
    return idx, good, Xw


def _triangulate_multi(descA, uvA, lvlA, validA, angA, RA, tA, pyrA,
                       partners, K, med_depth, n_levels: int):
    """Multi-partner triangulation: per partner, epipolar match + DLT +
    direct subpixel refinement of the B side (KLT of A's patches in B's
    pyramid) + re-triangulation + gates. `partners` is a list of dicts
    (desc, uv, level, valid, angle, R, t, pyr) or None for an empty slot.
    Returns (idx [P, NA], good [P, NA], X [P, NA, 3])."""
    NA = descA.shape[0]
    dev = uvA.device
    intr = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    # the A-side uv DEFINES each candidate; its patch is captured once
    patches = capture_ref_patches_core(pyrA, uvA, lvlA, n_levels)
    RA_n = RA.expand(NA, 3, 3)
    tA_n = tA.expand(NA, 3)
    PA = _projection(K, RA, tA)
    idx_o, good_o, X_o = [], [], []
    for q in partners:
        if q is None:
            idx_o.append(torch.full((NA,), -1, dtype=torch.int32, device=dev))
            good_o.append(torch.zeros(NA, dtype=torch.bool, device=dev))
            X_o.append(torch.zeros(NA, 3, device=dev))
            continue
        idx, good, Xw = _epipolar_match_core(
            descA, uvA, lvlA, validA, q["desc"], q["uv"], q["level"],
            q["valid"], RA, tA, q["R"], q["t"], K, med_depth, angA,
            q["angle"])
        uv_ref, ref_ok = refine_matches_core(
            q["pyr"], q["R"], q["t"], Xw, good, patches, uvA, lvlA,
            RA_n, tA_n, intr, n_levels)
        X2, g2 = _retriangulate(PA, _projection(K, q["R"], q["t"]), uvA,
                                uv_ref, RA, tA, q["R"], q["t"], K, med_depth,
                                good & ref_ok)
        idx_o.append(idx)
        good_o.append(g2)
        X_o.append(X2)
    return torch.stack(idx_o), torch.stack(good_o), torch.stack(X_o)


class LocalMapper:
    """Synchronous local mapping over the struct-of-arrays map."""

    MAX_PARTNERS = 3
    FUSE_CAP = 1024     # candidate-point pad per fuse target
    FUSE_TARGETS = 6    # target-axis bucket for the batched fuse

    def __init__(self, cam, n_levels: int = 4, window: int = 6,
                 device="cuda", mesh=None):
        self.cam = cam
        self.n_levels = n_levels
        self.window = window
        self.device = torch.device(device)
        # optional parallel.dist_ba.Mesh: global BA shards its landmark
        # axis across it, one step per (P, L, O_shard, phases) bucket in
        # _dist_ba_cache. None: the dense solve on self.device.
        self.mesh = mesh
        self._dist_ba_cache = {}
        self.K = cam.K.numpy()
        self.K_dev = cam.K.to(self.device)
        self.intr = (cam.fx, cam.fy, cam.cx, cam.cy)
        self.bf = float(cam.bf)
        # device copies of each keyframe's feature rows, keyed by
        # kf_feat_version (rows are immutable until re-extraction)
        self._dev_feats = {}
        # capacity-drop accounting: landmarks/observations shed by a
        # fixed-capacity BA or descriptor-update problem
        self.dropped = {"local_ba_points": 0, "local_ba_obs": 0,
                        "desc_update_points": 0, "global_ba_points": 0,
                        "global_ba_obs": 0}

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    # -------------------------------------------------- device feature rows
    def kf_dev_feats(self, smap: SlamMap, k: int) -> dict:
        """Device tensors of KF k's feature rows (FIFO-capped cache)."""
        ver = int(smap.kf_feat_version[k])
        ent = self._dev_feats.get(k)
        if ent is None or ent[0] != ver:
            ent = (ver, {
                "desc": self._t(smap.kf_feat_desc[k]),
                "uv": self._t(smap.kf_feat_uv[k]),
                "level": self._t(smap.kf_feat_level[k]),
                "angle": self._t(smap.kf_feat_angle[k]),
                "valid": self._t(smap.kf_feat_valid[k]),
            })
            self._dev_feats[k] = ent
            while len(self._dev_feats) > 32:
                self._dev_feats.pop(next(iter(self._dev_feats)))
        return ent[1]

    # ------------------------------------------------------------ triangulate
    def create_points_multi(self, smap: SlamMap, kf_new: int, partners,
                            pyramid_new):
        """Triangulate new points against up to MAX_PARTNERS partner KFs;
        per candidate feature of the new KF the strongest-covisibility
        partner with an accepted match wins. Returns points created."""
        partners = [int(p) for p in partners
                    if smap.kf_valid[p] and not smap.kf_feat_pending[p]
                    and smap.kf_pyr[p] is not None][: self.MAX_PARTNERS]
        if not partners:
            return 0
        unboundA = smap.kf_feat_valid[kf_new] & (smap.kf_feat_pt[kf_new] < 0)
        if unboundA.sum() < 8:
            return 0
        med_depth = self.median_depth(smap, kf_new)
        NA = smap.max_feat
        P = self.MAX_PARTNERS
        fA = self.kf_dev_feats(smap, kf_new)
        slots = [None] * P
        for j, p in enumerate(partners):
            unB = smap.kf_feat_valid[p] & (smap.kf_feat_pt[p] < 0)
            if unB.sum() < 8:
                continue
            fB = self.kf_dev_feats(smap, p)
            slots[j] = {"desc": fB["desc"], "uv": fB["uv"],
                        "level": fB["level"], "angle": fB["angle"],
                        "valid": self._t(unB), "R": self._t(smap.kf_R[p]),
                        "t": self._t(smap.kf_t[p]), "pyr": smap.kf_pyr[p]}
        if all(s is None for s in slots):
            return 0
        idx, good, X = _triangulate_multi(
            fA["desc"], fA["uv"], fA["level"], self._t(unboundA),
            fA["angle"], self._t(smap.kf_R[kf_new]),
            self._t(smap.kf_t[kf_new]), pyramid_new, slots, self.K_dev,
            float(med_depth), self.n_levels)
        idx = idx.cpu().numpy()
        good = good.cpu().numpy()
        X = X.cpu().numpy()
        # strongest-covisibility partner (list order) wins per slot
        chosen = np.full(NA, -1, np.int64)
        for j in range(P - 1, -1, -1):
            chosen[good[j]] = j
        slotsA = np.nonzero(chosen >= 0)[0]
        if len(slotsA) == 0:
            return 0
        inb = self.patch_in_bounds(smap.kf_feat_uv[kf_new, slotsA],
                                   smap.kf_feat_level[kf_new, slotsA])
        slotsA = slotsA[inb]
        if len(slotsA) == 0:
            return 0
        cj = chosen[slotsA]
        slotsB = idx[cj, slotsA]
        ids = smap.alloc_points(len(slotsA))
        smap.pt_xyz[ids] = X[cj, slotsA]
        smap.pt_valid[ids] = True
        smap.pt_first_kf[ids] = kf_new
        smap.pt_desc[ids] = smap.kf_feat_desc[kf_new, slotsA]
        smap.bind(kf_new, slotsA, ids)
        for j, p in enumerate(partners):
            m = cj == j
            if m.any():
                smap.bind(p, slotsB[m], ids[m])
        # direct-tracking patches are captured by the caller AFTER local BA
        return len(slotsA)

    def patch_in_bounds(self, uv, lvl):
        """True where a REF_PATCH capture at (uv, level) stays in-image."""
        margin = (REF_PATCH / 2 + 2) * (2.0 ** lvl.astype(np.float32))
        w, h = self.cam.width, self.cam.height
        return ((uv[:, 0] >= margin) & (uv[:, 0] < w - margin)
                & (uv[:, 1] >= margin) & (uv[:, 1] < h - margin))

    def refresh_patches(self, smap: SlamMap, kf: int, pyramid, pt_ids, slots):
        """(Re)capture stored ref patches for points bound to `slots` of kf;
        points whose patch would cross the border keep their old state."""
        pt_ids = np.asarray(pt_ids)
        slots = np.asarray(slots)
        if len(pt_ids) == 0:
            return
        uv = smap.kf_feat_uv[kf, slots]
        lvl = smap.kf_feat_level[kf, slots]
        ok = self.patch_in_bounds(uv, lvl)
        pt_ids, slots, uv, lvl = pt_ids[ok], slots[ok], uv[ok], lvl[ok]
        if len(pt_ids) == 0:
            return
        patches = capture_ref_patches_core(pyramid, self._t(uv),
                                           self._t(lvl), self.n_levels)
        smap.pt_patch[pt_ids] = patches.cpu().numpy()
        smap.pt_ref_uv[pt_ids] = uv
        smap.pt_ref_level[pt_ids] = lvl
        smap.pt_ref_kf[pt_ids] = kf
        smap.pt_ref_R[pt_ids] = smap.kf_R[kf]
        smap.pt_ref_t[pt_ids] = smap.kf_t[kf]

    def update_distinctive_descriptors(self, smap: SlamMap, kf: int,
                                       max_obs: int = 8):
        """Refresh pt_desc of the points observed by `kf` to their
        min-median-Hamming observation descriptor."""
        binds = smap.kf_feat_pt[kf]
        pt_ids = np.unique(binds[binds >= 0])
        pt_ids = pt_ids[smap.pt_valid[pt_ids]]
        if len(pt_ids) == 0:
            return
        win = smap.local_window(kf, self.window + 4)
        n = len(pt_ids)
        cap = 2048
        if n > cap:
            self.dropped["desc_update_points"] += n - cap
            pt_ids = pt_ids[np.argsort(-smap.pt_obs[pt_ids])[:cap]]
            n = cap
        loc = np.full(smap.max_pt, -1, np.int64)
        loc[pt_ids] = np.arange(n)
        stack = np.zeros((n, max_obs, 256), np.uint8)
        valid = np.zeros((n, max_obs), bool)
        count = np.zeros(n, np.int32)
        for k in win:
            if smap.kf_feat_pending[k]:
                continue
            bk = smap.kf_feat_pt[k]
            slots = np.nonzero(bk >= 0)[0]
            lp = loc[bk[slots]]
            keep = (lp >= 0) & (count[np.maximum(lp, 0)] < max_obs)
            slots, lp = slots[keep], lp[keep]
            first = np.unique(lp, return_index=True)[1]
            slots, lp = slots[first], lp[first]
            col = count[lp]
            stack[lp, col] = smap.kf_feat_desc[k, slots]
            valid[lp, col] = True
            count[lp] += 1
        multi = count >= 2
        if not multi.any():
            return
        _, desc = matching.distinctive_descriptors_packed(
            self._t(np.packbits(stack, axis=-1)), self._t(valid))
        smap.pt_desc[pt_ids[multi]] = desc.cpu().numpy()[multi]

    def median_depth(self, smap: SlamMap, kf: int) -> float:
        pts = smap.kf_feat_pt[kf]
        pts = pts[pts >= 0]
        if len(pts) == 0:
            return 1.0
        Xc = smap.pt_xyz[pts] @ smap.kf_R[kf].T + smap.kf_t[kf]
        return float(np.median(Xc[:, 2]))

    # ------------------------------------------------------------------- BA
    def local_ba(self, smap: SlamMap, kf: int):
        """Window local BA (reference Optimizer::LocalBundleAdjustment)."""
        win = smap.local_window(kf, self.window)
        if len(win) < 2:
            return
        pt_ids = smap.points_in_kfs(win)
        if len(pt_ids) == 0:
            return
        if len(pt_ids) > BA_L:
            self.dropped["local_ba_points"] += len(pt_ids) - BA_L
            pt_ids = pt_ids[np.argsort(-smap.pt_obs[pt_ids])[:BA_L]]
        # fixed ring: KFs outside the window that observe window points
        in_win = np.zeros(smap.n_kf, bool)
        in_win[win] = True
        obs_per_kf = np.isin(smap.kf_feat_pt[: smap.n_kf], pt_ids).sum(1)
        obs_per_kf[in_win] = 0
        ring = np.argsort(-obs_per_kf)[: max(0, BA_P - len(win))]
        ring = [int(k) for k in ring if obs_per_kf[k] >= 10]
        win = win + ring
        o_kf, o_pt, o_uv, o_lvl, o_ur = smap.observations(win, pt_ids)
        if len(o_kf) > BA_O:
            self.dropped["local_ba_obs"] += len(o_kf) - BA_O
            order = np.argsort(-smap.pt_obs[pt_ids[o_pt]],
                               kind="stable")[:BA_O]
            o_kf, o_pt, o_uv, o_lvl, o_ur = (o_kf[order], o_pt[order],
                                             o_uv[order], o_lvl[order],
                                             o_ur[order])
        P = BA_P
        n_free = len(win) - len(ring)
        kfR = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
        kft = np.zeros((P, 3), np.float32)
        fixed = np.ones(P, bool)
        for i, k in enumerate(win[:P]):
            kfR[i] = smap.kf_R[k]
            kft[i] = smap.kf_t[k]
            fixed[i] = i >= n_free
        # gauge anchors: the two oldest KFs stay fixed (7-DoF mono gauge)
        order = np.argsort([smap.kf_frame_id[k] for k in win[:P]])
        fixed[order[0]] = True
        if len(win) >= 4:
            fixed[order[1]] = True

        L, O = BA_L, BA_O
        pts = np.zeros((L, 3), np.float32)
        pt_valid = np.zeros(L, bool)
        pts[: len(pt_ids)] = smap.pt_xyz[pt_ids]
        pt_valid[: len(pt_ids)] = True
        obs_p = np.zeros(O, np.int64)
        obs_l = np.zeros(O, np.int64)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_ur = np.full(O, -1.0, np.float32)
        obs_is2 = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        n_o = len(o_kf)
        obs_p[:n_o] = o_kf
        obs_l[:n_o] = o_pt
        obs_uv[:n_o] = o_uv
        obs_ur[:n_o] = o_ur
        obs_is2[:n_o] = 0.25 ** o_lvl
        obs_valid[:n_o] = o_kf < P

        t = self._t
        res = local_bundle_adjustment(
            t(kfR), t(kft), t(fixed), t(pts), t(pt_valid), t(obs_p),
            t(obs_l), t(obs_uv), t(obs_is2), t(obs_valid), self.intr,
            n_poses=P, n_points=L, obs_ur=t(obs_ur), bf=self.bf)
        newR = res.kf_R.cpu().numpy()
        newt = res.kf_t.cpu().numpy()
        for i, k in enumerate(win[:P]):
            if not fixed[i]:
                smap.set_pose(k, newR[i], newt[i])
        smap.pt_xyz[pt_ids] = res.points.cpu().numpy()[: len(pt_ids)]
        smap.sync_ref_poses()

        # drop observations flagged as outliers
        inl = res.obs_inlier.cpu().numpy()[:n_o]
        for b in np.nonzero(~inl)[0]:
            k = win[o_kf[b]]
            pid = pt_ids[int(o_pt[b])]
            slots = np.nonzero(smap.kf_feat_pt[k] == pid)[0]
            if len(slots):
                smap.kf_feat_pt[k, slots] = -1
                smap.pt_obs[pid] -= len(slots)

    # -------------------------------------------------------------- global BA
    def global_ba(self, smap: SlamMap, phases=(10, 10), max_poses: int = 64):
        """Full-map bundle adjustment (reference GlobalBundleAdjustemnt, run
        after a loop closure) through local_bundle_adjustment. Capacities are
        bucketed; maps larger than the biggest bucket optimize the newest
        `max_poses` keyframes against the rest held fixed."""
        kfs = [k for k in range(smap.n_kf) if smap.kf_valid[k]]
        if len(kfs) < 2:
            return
        free = kfs[-max_poses:] if len(kfs) > max_poses else kfs
        P = _bucket(len(kfs), [8, 16, 32, 64, 128])
        pt_ids = smap.points_in_kfs(kfs)
        L = _bucket(len(pt_ids), [2048, 4096, 8192, 16384])
        if len(pt_ids) > L:
            self.dropped["global_ba_points"] += len(pt_ids) - L
            pt_ids = pt_ids[np.argsort(-smap.pt_obs[pt_ids])[:L]]
        o_kf, o_pt, o_uv, o_lvl, o_ur = smap.observations(kfs[:P], pt_ids)
        O = _bucket(len(o_kf), [8192, 16384, 32768])
        if len(o_kf) > O:
            self.dropped["global_ba_obs"] += len(o_kf) - O
            order = np.argsort(-smap.pt_obs[pt_ids[o_pt]],
                               kind="stable")[:O]
            o_kf, o_pt, o_uv, o_lvl, o_ur = (o_kf[order], o_pt[order],
                                             o_uv[order], o_lvl[order],
                                             o_ur[order])
        kfR = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
        kft = np.zeros((P, 3), np.float32)
        fixed = np.ones(P, bool)
        for i, k in enumerate(kfs[:P]):
            kfR[i] = smap.kf_R[k]
            kft[i] = smap.kf_t[k]
            fixed[i] = k not in free
        fixed[0] = True  # gauge anchor (reference fixes KF0)

        pts = np.zeros((L, 3), np.float32)
        ptv = np.zeros(L, bool)
        pts[: len(pt_ids)] = smap.pt_xyz[pt_ids]
        ptv[: len(pt_ids)] = True
        obs_p = np.zeros(O, np.int64)
        obs_l = np.zeros(O, np.int64)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_ur = np.full(O, -1.0, np.float32)
        obs_is2 = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        n_o = len(o_kf)
        obs_p[:n_o] = o_kf
        obs_l[:n_o] = o_pt
        obs_uv[:n_o] = o_uv
        obs_ur[:n_o] = o_ur
        obs_is2[:n_o] = 0.25 ** o_lvl
        obs_valid[:n_o] = True

        if self.mesh is not None:
            res = self._global_ba_dist(kfR, kft, fixed, pts, ptv, obs_p,
                                       obs_l, obs_uv, obs_ur,
                                       obs_is2 * obs_valid, P, L,
                                       phases=tuple(phases))
        else:
            t = self._t
            res = local_bundle_adjustment(
                t(kfR), t(kft), t(fixed), t(pts), t(ptv), t(obs_p),
                t(obs_l), t(obs_uv), t(obs_is2), t(obs_valid), self.intr,
                n_poses=P, n_points=L, phases=tuple(phases),
                obs_ur=t(obs_ur), bf=self.bf)
        newR = res.kf_R.cpu().numpy()
        newt = res.kf_t.cpu().numpy()
        for i, k in enumerate(kfs[:P]):
            if not fixed[i]:
                smap.set_pose(k, newR[i], newt[i])
        smap.pt_xyz[pt_ids] = res.points.cpu().numpy()[: len(pt_ids)]
        smap.sync_ref_poses()

    def _global_ba_dist(self, kfR, kft, fixed, pts, ptv, obs_p, obs_l,
                        obs_uv, obs_ur, obs_w, P, L, phases=(10, 10)):
        """Landmark-block-sharded global BA over self.mesh (one step per
        (P, L, O_shard, phases) bucket). Stereo/RGB-D 3-row edges and the
        phased chi2-outlier drops are first-class, as in the dense solve."""
        from ..parallel.dist_ba import (make_distributed_ba,
                                        partition_obs_by_landmark)

        n_dev = self.mesh.size
        obs_w = obs_w.astype(np.float32)
        op, ol, ouv, our, ow, O_shard = partition_obs_by_landmark(
            obs_p, obs_l, obs_uv, obs_w, L, n_dev, obs_ur=obs_ur)
        Ob = _bucket(O_shard, [1024, 2048, 4096, 8192, 16384, 32768])
        if Ob != O_shard:
            op, ol, ouv, our, ow, O_shard = partition_obs_by_landmark(
                obs_p, obs_l, obs_uv, obs_w, L, n_dev, pad_to=Ob,
                obs_ur=obs_ur)
        key = (P, L, O_shard, tuple(phases))
        if key not in self._dist_ba_cache:
            self._dist_ba_cache[key] = make_distributed_ba(
                self.mesh, n_poses=P, n_points=L, phases=tuple(phases))
        return self._dist_ba_cache[key](
            kfR, kft, ~fixed, pts, ptv, op, ol, ouv, our, ow,
            tuple(np.float32(v) for v in self.intr), np.float32(self.bf))

    # ------------------------------------------------------------------ fuse
    def bind_map_points(self, smap: SlamMap, kf: int, radius: float = 4.0):
        """Project local-map points into the new KF; bind matches on unbound
        features and fuse duplicates on bound ones (the point with fewer
        observations merges into the stronger; reference SearchInNeighbors
        -> ORBmatcher::Fuse + MapPoint::Replace)."""
        win = smap.local_window(kf, self.window + 4)
        pts = smap.points_in_kfs([k for k in win if k != kf])
        return self.project_and_fuse(smap, kf, pts, radius=radius)

    def search_in_neighbors(self, smap: SlamMap, kf: int,
                            radius: float = 4.0, n_direct: int = 10,
                            n_hop2: int = 5, n_reverse: int = 5):
        """Two-hop SearchInNeighbors: fuse the neighbourhood's points into
        the new KF and the new KF's points into its strongest neighbours,
        both directions in one batched match."""
        direct = [k for k in smap.local_window(kf, n_direct + 1)
                  if k != kf and not smap.kf_feat_pending[k]]
        targets = set(direct)
        for k in direct:
            targets.update(smap.local_window(k, n_hop2 + 1))
        targets.discard(kf)
        targets = [k for k in targets
                   if smap.kf_valid[k] and not smap.kf_feat_pending[k]]
        pts = smap.points_in_kfs(targets)
        binds = smap.kf_feat_pt[kf]
        cur_pts = np.unique(binds[binds >= 0])
        cur_pts = cur_pts[smap.pt_valid[cur_pts]]
        fuse_t = [kf]
        fuse_p = [pts]
        rev = direct[:n_reverse]
        if len(cur_pts):
            fuse_t += rev
            fuse_p += [cur_pts] * len(rev)
        return self.fuse_into_targets(smap, fuse_t, fuse_p, radius=radius)

    def _fuse_prepare(self, smap: SlamMap, kf: int, pts):
        """Filter + project candidate points into `kf`. Returns (pts [n],
        descA, uvA, vA padded to FUSE_CAP) or None."""
        pts = np.asarray(pts)
        pts = pts[smap.pt_valid[pts]]
        pts = pts[~np.isin(pts, smap.kf_feat_pt[kf])]
        if len(pts) == 0:
            return None
        Xc = smap.pt_xyz[pts] @ smap.kf_R[kf].T + smap.kf_t[kf]
        z = Xc[:, 2]
        zc = np.maximum(z, 1e-6)
        uv = np.stack([self.cam.fx * Xc[:, 0] / zc + self.cam.cx,
                       self.cam.fy * Xc[:, 1] / zc + self.cam.cy],
                      -1).astype(np.float32)
        inb = ((z > 0.1) & (uv[:, 0] > 10) & (uv[:, 0] < self.cam.width - 10)
               & (uv[:, 1] > 10) & (uv[:, 1] < self.cam.height - 10))
        pts, uv = pts[inb], uv[inb]
        if len(pts) == 0:
            return None
        cap = self.FUSE_CAP
        n = min(len(pts), cap)
        descA = np.zeros((cap, 256), np.uint8)
        uvA = np.zeros((cap, 2), np.float32)
        vA = np.zeros(cap, bool)
        descA[:n] = smap.pt_desc[pts[:n]]
        uvA[:n] = uv[:n]
        vA[:n] = True
        return pts[:n], descA, uvA, vA

    def _fuse_apply(self, smap: SlamMap, kf: int, pts, idx, ok):
        """Bind fresh matches; Replace-fuse duplicates (weaker into the
        stronger point)."""
        rows = np.nonzero(ok)[0]
        if len(rows) == 0:
            return 0
        slot_pt = smap.kf_feat_pt[kf, idx[rows]]
        fresh = slot_pt < 0
        smap.bind(kf, idx[rows][fresh], pts[rows][fresh])
        for r in np.nonzero(~fresh)[0]:
            a = int(pts[rows[r]])
            b = int(slot_pt[r])
            if a == b or not (smap.pt_valid[a] and smap.pt_valid[b]):
                continue
            keep, drop = (a, b) if smap.pt_obs[a] >= smap.pt_obs[b] \
                else (b, a)
            smap.replace_point(drop, keep)
        return len(rows)

    def project_and_fuse(self, smap: SlamMap, kf: int, pts,
                         radius: float = 4.0):
        """Project candidate landmarks into keyframe `kf` and fuse (no
        rotation histogram: the reference's Fuse has none)."""
        return self.fuse_into_targets(smap, [kf], [pts], radius=radius)

    def fuse_into_targets(self, smap: SlamMap, targets, pts_per_target,
                          radius: float = 4.0):
        """project_and_fuse over several targets as ONE batched window
        match (matching.match_with_windows_batch)."""
        preps, metas = [], []
        for t, pts in zip(targets, pts_per_target):
            prep = self._fuse_prepare(smap, t, pts)
            if prep is not None:
                metas.append(t)
                preps.append(prep)
        if not preps:
            return 0
        preps = preps[: self.FUSE_TARGETS]
        metas = metas[: self.FUSE_TARGETS]
        fT = [self.kf_dev_feats(smap, t) for t in metas]
        idx, ok = matching.match_with_windows_batch(
            self._t(np.stack([p[1] for p in preps])),
            self._t(np.stack([p[3] for p in preps])),
            torch.stack([f["desc"] for f in fT]),
            torch.stack([f["valid"] for f in fT]),
            self._t(np.stack([p[2] for p in preps])),
            torch.stack([f["uv"] for f in fT]),
            radius=radius, max_dist=matching.TH_LOW, ratio=0.9)
        idx = idx.cpu().numpy()
        ok = ok.cpu().numpy()
        n = 0
        for i, t in enumerate(metas):
            m = len(preps[i][0])
            n += self._fuse_apply(smap, t, preps[i][0], idx[i][:m], ok[i][:m])
        return n

    # ---------------------------------------------------------------- culling
    def cull_keyframes(self, smap: SlamMap, kf: int, min_id_gap: int = 3,
                       protect=None):
        """Cull redundant covisible KFs: >= 90% of a KF's points observed
        by >= 3 other keyframes. The newest KFs and KF0 are kept."""
        win = smap.local_window(kf, self.window + 4)
        culled = 0
        for k in win:
            if k == kf or k == 0 or k >= smap.n_kf - min_id_gap:
                continue
            if (protect is not None and k in protect) or not smap.kf_valid[k]:
                continue
            binds = smap.kf_feat_pt[k]
            pids = binds[binds >= 0]
            if len(pids) < 20 or (smap.pt_obs[pids] >= 4).mean() < 0.9:
                continue
            # freeze the culled pose relative to a surviving parent;
            # covisibility must be read BEFORE the bindings are cleared
            parent = int(smap.kf_parent[k])
            if parent < 0 or not smap.kf_valid[parent]:
                cov = smap.covisibility(k)
                cov = np.where(smap.kf_valid[: smap.n_kf], cov, 0)
                cov[k] = 0
                parent = int(np.argmax(cov)) if cov.max() > 0 else 0
            smap.mark_culled(k, parent)
            # re-home points whose direct-tracking reference this KF is
            refugees = np.unique(pids[smap.pt_ref_kf[pids] == k])
            smap.kf_feat_pt[k, np.nonzero(binds >= 0)[0]] = -1
            np.add.at(smap.pt_obs, pids, -1)
            smap.kf_valid[k] = False
            smap.kf_pyr[k] = None
            for newref in smap.local_window(kf, self.window + 4):
                if not smap.kf_valid[newref] or len(refugees) == 0:
                    continue
                sl = np.nonzero(np.isin(smap.kf_feat_pt[newref], refugees))[0]
                if len(sl) and smap.kf_pyr[newref] is not None:
                    ids = smap.kf_feat_pt[newref, sl]
                    self.refresh_patches(smap, newref, smap.kf_pyr[newref],
                                         ids, sl)
                    refugees = refugees[~np.isin(refugees, ids)]
            if len(refugees):
                smap.kill_points(refugees)
            culled += 1
        return culled

    def cull_points(self, smap: SlamMap, recent_window: int = 3):
        """Found-ratio + observation-count culling (MapPointCulling)."""
        if smap.n_pt == 0:
            return 0
        ids = np.arange(smap.n_pt)
        ratio = smap.pt_found[ids] / np.maximum(smap.pt_visible[ids], 1)
        age = smap.n_kf - 1 - smap.pt_first_kf[ids]
        bad = smap.pt_valid[ids] & (
            ((ratio < 0.25) & (smap.pt_visible[ids] > 8))
            | ((age >= 2) & (smap.pt_obs[ids] <= 2)))
        smap.kill_points(ids[bad])
        return int(bad.sum())
