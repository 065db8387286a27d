"""Loop detection + Sim3 computation + loop correction.

Port of ``ygz_tpu/backend/loopclosing.py`` (the reference LoopClosing
thread): DetectLoop (BoW candidates above the minimum covisible score,
3-consecutive-KF consistency), ComputeSim3 (node-gated descriptor matches
-> Sim3 RANSAC -> Sim3-guided re-matching -> Horn refinement), CorrectLoop
(essential-graph optimization with the loop edge, point remap,
SearchAndFuse). The map bookkeeping is host numpy as in the JAX package;
matching, Sim3 RANSAC and the pose graph run on ``device``. RANSAC draws
from a CPU ``torch.Generator`` seeded with 7 (the JAX ``PRNGKey(7)``), so a
CUDA run draws the same hypotheses as a CPU one.

After a correction the tracker runs a global BA (``frontend/tracker.py``
``_mapping_tail``), as the reference spawns RunGlobalBundleAdjustment.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bow import BowIndex
from .mapping import _bucket
from .mapstate import SlamMap
from .posegraph import optimize_pose_graph, optimize_pose_graph_cg
from ..geometry.sim3 import horn_sim3, sim3_ransac
from ..ops import matching

MAX_PG_NODES = 256   # dense solve up to here; PCG beyond


class LoopCloser:
    def __init__(self, bow: BowIndex, cam, consistency: int = 3,
                 min_matches: int = 20, covis_weight: int = 30,
                 device="cuda"):
        self.bow = bow
        self.cam = cam
        self.device = torch.device(device)
        self.consistency_th = consistency
        self.min_matches = min_matches
        self.covis_weight = covis_weight
        self._consistent_groups = []  # list of (set_of_kfs, count)
        self.last_loop_kf = -1
        # accepted loop edges (i, j, R, t, s), kept for every later
        # essential-graph solve
        self.loop_edges = []
        # one dict per accepted loop: candidate, Sim3 inliers, scale
        self.events = []
        self.n_detect = 0
        self._gen = torch.Generator()
        self._gen.manual_seed(7)

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------- detection
    def detect(self, smap: SlamMap, kf: int, bow_vec) -> Optional[int]:
        """Returns a loop-candidate KF id after the consistency check, or
        None (reference trigger: >= 10 KFs since the last loop)."""
        self.n_detect += 1
        if kf < 10 or kf - self.last_loop_kf < 10:
            return None
        cov = smap.covisibility(kf)
        covisible = set(np.nonzero(cov > 0)[0].tolist()) | {kf}
        # candidates must beat the least-similar covisible view (weight >=
        # 15, else any covisible, else 1.0 = block)
        scores = self.bow.scores(bow_vec)
        n_bow = len(scores)
        strong = [k for k in covisible
                  if k != kf and k < n_bow and cov[k] >= 15]
        if not strong:
            strong = [k for k in covisible if k != kf and k < n_bow]
        min_score = min((scores[k] for k in strong), default=1.0)
        cands = self.bow.loop_candidates(
            bow_vec, min_score=min_score,
            exclude={k for k in covisible if k < n_bow})
        if not cands:
            self._consistent_groups = []
            return None
        # a candidate's covisibility group must reappear consistency_th
        # times over consecutive KFs (ConsistentGroup logic)
        new_groups = []
        accepted = None
        for c in cands:
            group = set(np.nonzero(smap.covisibility(c) > 0)[0].tolist()) | {c}
            count = 1
            for g, n in self._consistent_groups:
                if group & g:
                    count = max(count, n + 1)
            new_groups.append((group, count))
            if count >= self.consistency_th and accepted is None:
                accepted = c
        self._consistent_groups = new_groups
        return accepted

    # ------------------------------------------------------------- sim3
    def compute_sim3(self, smap: SlamMap, kf: int, cand: int):
        """Match map points of kf vs cand, robust Sim3 cand->kf.

        Returns (R, t, s, n_inliers) with S mapping cand-camera coords to
        kf-camera coords, or None."""
        bk = smap.kf_feat_pt[kf] >= 0
        bc = smap.kf_feat_pt[cand] >= 0
        if bk.sum() < self.min_matches or bc.sum() < self.min_matches:
            return None
        # node-gated SearchByBoW between the two keyframes
        gk = gc = None
        if self.bow.kf_valid[kf] and self.bow.kf_valid[cand]:
            gk = self._t(self.bow.feat_groups(kf))
            gc = self._t(self.bow.feat_groups(cand))
        idx, ok = matching.match_with_windows(
            self._t(smap.kf_feat_desc[kf]), self._t(bk),
            self._t(smap.kf_feat_desc[cand]), self._t(bc),
            max_dist=matching.TH_LOW, ratio=0.75, mutual=True,
            ang1=self._t(smap.kf_feat_angle[kf]),
            ang2=self._t(smap.kf_feat_angle[cand]),
            groups1=gk, groups2=gc)
        idx = idx.cpu().numpy()
        slots_k = np.nonzero(ok.cpu().numpy())[0]
        if len(slots_k) < self.min_matches:
            return None
        slots_c = idx[slots_k]
        pk = smap.kf_feat_pt[kf, slots_k]
        pc = smap.kf_feat_pt[cand, slots_c]
        # 3-D positions in each KF's camera frame
        Xk = smap.pt_xyz[pk] @ smap.kf_R[kf].T + smap.kf_t[kf]
        Xc = smap.pt_xyz[pc] @ smap.kf_R[cand].T + smap.kf_t[cand]
        n = len(Xk)
        pad = max(0, 64 - n)
        Xk = np.pad(Xk, ((0, pad), (0, 0)))
        Xc = np.pad(Xc, ((0, pad), (0, 0)))
        mask = np.array([True] * n + [False] * pad)
        R, t, s, inl, ni = sim3_ransac(
            self._t(Xc), self._t(Xk), self._t(mask), self._gen,
            num_iters=300, th_b=0.05)
        if int(ni) < self.min_matches:
            return None
        R, t, s = R.cpu().numpy(), t.cpu().numpy(), float(s)

        # SearchBySim3: project the loop-side local map through S into kf's
        # image and re-match (a much wider correspondence set)
        Xc2, Xk2 = self._guided_matches(smap, kf, cand, (R, t, s))
        inl_np = inl.cpu().numpy()[:n]
        Xc_all = np.concatenate([Xc[:n][inl_np], Xc2])
        Xk_all = np.concatenate([Xk[:n][inl_np], Xk2])
        # final acceptance: >= 40 matches after the Sim3-guided projection
        if len(Xc_all) < 2 * self.min_matches:
            return None
        # inlier-iterated Horn refinement (OptimizeSim3's role)
        R, t, s, ni = self._refine_sim3(Xc_all, Xk_all, (R, t, s))
        if ni < 2 * self.min_matches:
            return None
        return R, t, s, ni

    def _guided_matches(self, smap: SlamMap, kf: int, cand: int, S_ck,
                        radius: float = 8.0, cap: int = 1024):
        """Sim3-guided 3D-3D correspondences: cand-side local-map points
        projected through S_ck into kf's image, window-gated descriptor
        match against kf's bound features. Returns (Xc [M,3], Xk [M,3]) in
        the two cameras' frames."""
        empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
        pts_c = smap.points_in_kfs(smap.local_window(cand, 8))
        if len(pts_c) == 0:
            return empty
        R, t, s = S_ck
        Xc = smap.pt_xyz[pts_c] @ smap.kf_R[cand].T + smap.kf_t[cand]
        Xk_pred = s * (Xc @ R.T) + t
        z = Xk_pred[:, 2]
        uv = np.stack([self.cam.fx * Xk_pred[:, 0] / np.maximum(z, 1e-6)
                       + self.cam.cx,
                       self.cam.fy * Xk_pred[:, 1] / np.maximum(z, 1e-6)
                       + self.cam.cy], -1).astype(np.float32)
        inb = ((z > 0.05) & (uv[:, 0] > 0) & (uv[:, 0] < self.cam.width)
               & (uv[:, 1] > 0) & (uv[:, 1] < self.cam.height))
        pts_c, Xc, uv = pts_c[inb], Xc[inb], uv[inb]
        if len(pts_c) == 0:
            return empty
        m = min(len(pts_c), cap)
        descA = np.zeros((cap, 256), np.uint8)
        uvA = np.zeros((cap, 2), np.float32)
        vA = np.zeros(cap, bool)
        descA[:m] = smap.pt_desc[pts_c[:m]]
        uvA[:m] = uv[:m]
        vA[:m] = True
        idx, ok = matching.match_with_windows(
            self._t(descA), self._t(vA), self._t(smap.kf_feat_desc[kf]),
            self._t(smap.kf_feat_pt[kf] >= 0), uv_pred1=self._t(uvA),
            uv2=self._t(smap.kf_feat_uv[kf]), radius=radius,
            max_dist=matching.TH_HIGH, ratio=0.9, mutual=True)
        idx = idx.cpu().numpy()[:m]
        rows = np.nonzero(ok.cpu().numpy()[:m])[0]
        if len(rows) == 0:
            return empty
        pk = smap.kf_feat_pt[kf, idx[rows]]
        good = smap.pt_valid[pk]
        rows, pk = rows[good], pk[good]
        Xk = smap.pt_xyz[pk] @ smap.kf_R[kf].T + smap.kf_t[kf]
        return Xc[rows].astype(np.float32), Xk.astype(np.float32)

    def _refine_sim3(self, Xc, Xk, S0, iters: int = 3, th: float = 0.08):
        """Alternate a Horn fit and relative-residual gating
        (|S(Xc) - Xk| < th * depth)."""
        R, t, s = S0
        ni = len(Xc)
        for _ in range(iters):
            pred = s * (Xc @ np.asarray(R).T) + np.asarray(t)
            err = np.linalg.norm(pred - Xk, axis=-1)
            keep = err < th * np.maximum(np.abs(Xk[:, 2]), 0.5)
            ni = int(keep.sum())
            if ni < 4:
                return np.asarray(R), np.asarray(t), float(s), ni
            R_, t_, s_ = horn_sim3(self._t(Xc), self._t(Xk), self._t(keep))
            R, t, s = R_.cpu().numpy(), t_.cpu().numpy(), float(s_)
        return R, t, s, ni

    # ------------------------------------------------------------- correction
    def correct(self, smap: SlamMap, kf: int, cand: int, S_ck):
        """Apply the loop: essential-graph optimization with the loop edge.

        S_ck = (R, t, s): cand-camera -> kf-camera similarity. Edges:
        consecutive-KF odometry + strong covisibility (weight >=
        covis_weight) + every loop edge accepted so far + the new one. Node
        Sim3 = (R_kw, t_kw, 1). Dense solve up to MAX_PG_NODES nodes, the
        matrix-free PCG beyond."""
        K = smap.n_kf
        Rn = smap.kf_R[:K].copy()
        tn = smap.kf_t[:K].copy()

        cons_i = np.arange(K - 1, dtype=np.int32)
        cons_j = cons_i + 1
        C = smap.covisibility_matrix()
        cov_i, cov_j = np.nonzero(np.triu(C, k=2) >= self.covis_weight)
        ei_est = np.concatenate([cons_i, cov_i.astype(np.int32)])
        ej_est = np.concatenate([cons_j, cov_j.astype(np.int32)])
        # S_ji = S_j S_i^-1 at unit scales: R_ji = Rj Ri^T, t_ji = tj - R_ji ti
        Rji = np.einsum("nab,ncb->nac", Rn[ej_est], Rn[ei_est])
        tji = tn[ej_est] - np.einsum("nab,nb->na", Rji, tn[ei_est])

        Rm, tm, sm = S_ck
        loops = self.loop_edges + [(int(cand), int(kf),
                                    np.asarray(Rm, np.float32),
                                    np.asarray(tm, np.float32), float(sm))]
        n_est = len(ei_est)
        E = _bucket(n_est + len(loops), [2048, 8192, 32768])
        if n_est + len(loops) > E:  # keep all loop edges; drop covisibility
            n_est = E - len(loops)
        ei = np.zeros(E, np.int32)
        ej = np.zeros(E, np.int32)
        eR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        et = np.zeros((E, 3), np.float32)
        es = np.ones(E, np.float32)
        ew = np.zeros(E, np.float32)
        ei[:n_est] = ei_est[:n_est]
        ej[:n_est] = ej_est[:n_est]
        eR[:n_est] = Rji[:n_est]
        et[:n_est] = tji[:n_est]
        ew[:n_est] = 1.0
        for n, (i, j, R_, t_, s_) in enumerate(loops):
            ei[n_est + n] = i
            ej[n_est + n] = j
            eR[n_est + n] = R_
            et[n_est + n] = t_
            es[n_est + n] = s_
            ew[n_est + n] = 5.0

        NK = _bucket(K, [64, 128, 256, 512, 1024, 2048, 4096])
        Rn_p = np.tile(np.eye(3, dtype=np.float32), (NK, 1, 1))
        tn_p = np.zeros((NK, 3), np.float32)
        Rn_p[:K] = Rn
        tn_p[:K] = tn
        fixed = np.ones(NK, bool)   # padding nodes stay fixed
        fixed[:K] = False
        fixed[cand] = True  # the loop-origin side anchors the gauge
        fixed[0] = True

        solver = (optimize_pose_graph if NK <= MAX_PG_NODES
                  else optimize_pose_graph_cg)
        t_ = self._t
        res = solver(t_(Rn_p), t_(tn_p), t_(np.ones(NK, np.float32)), t_(ei),
                     t_(ej), t_(eR), t_(et), t_(es), t_(ew), t_(fixed),
                     n_nodes=NK, iters=25)
        newR = res.R.cpu().numpy()[:K]
        newt = res.t.cpu().numpy()[:K]
        news = res.s.cpu().numpy()[:K]

        # remap points through their reference KF's correction:
        # X' = S_new^-1 (S_old (X))
        pts = np.nonzero(smap.pt_valid[: smap.n_pt])[0]
        refs = smap.pt_ref_kf[pts]
        ok = (refs >= 0) & (refs < K)
        pts, refs = pts[ok], refs[ok]
        if len(pts):
            Xc_old = (np.einsum("nab,nb->na", smap.kf_R[refs],
                                smap.pt_xyz[pts]) + smap.kf_t[refs])
            Xw_new = np.einsum("nba,nb->na", newR[refs],
                               Xc_old - newt[refs]) / news[refs][:, None]
            smap.pt_xyz[pts] = Xw_new.astype(np.float32)

        # write back SE3 poses: Tcw = [R, t/s]
        smap.kf_R[:K] = newR
        smap.kf_t[:K] = newt / news[:, None]
        smap.sync_ref_poses()
        # fuse duplicate landmarks across the (now aligned) loop seam
        self.search_and_fuse(smap, kf, cand)
        self.loop_edges.append(loops[-1])
        self.last_loop_kf = kf
        return True

    def search_and_fuse(self, smap: SlamMap, kf: int, cand: int,
                        radius: float = 4.0, neighborhood: int = 8):
        """Project the loop-side landmarks into the current-side keyframes
        and fuse duplicates, the loop-side point replacing the current-side
        one (reference LoopClosing::SearchAndFuse + ORBmatcher::Fuse).
        Returns the number of fused points."""
        loop_pts = smap.points_in_kfs(smap.local_window(cand, neighborhood))
        n_fused = 0
        for k in smap.local_window(kf, neighborhood):
            pts = loop_pts[smap.pt_valid[loop_pts]]
            pts = pts[~np.isin(pts, smap.kf_feat_pt[k])]
            if len(pts) == 0:
                continue
            R, t = smap.kf_R[k], smap.kf_t[k]
            Xc = smap.pt_xyz[pts] @ R.T + t
            z = Xc[:, 2]
            uv = np.stack([self.cam.fx * Xc[:, 0] / np.maximum(z, 1e-6)
                           + self.cam.cx,
                           self.cam.fy * Xc[:, 1] / np.maximum(z, 1e-6)
                           + self.cam.cy], -1).astype(np.float32)
            inb = ((z > 0.1) & (uv[:, 0] > 10)
                   & (uv[:, 0] < self.cam.width - 10)
                   & (uv[:, 1] > 10) & (uv[:, 1] < self.cam.height - 10))
            pts, uv = pts[inb], uv[inb]
            if len(pts) == 0:
                continue
            cap = 1024
            n = min(len(pts), cap)
            descA = np.zeros((cap, 256), np.uint8)
            uvA = np.zeros((cap, 2), np.float32)
            vA = np.zeros(cap, bool)
            descA[:n] = smap.pt_desc[pts[:n]]
            uvA[:n] = uv[:n]
            vA[:n] = True
            idx, ok = matching.match_with_windows(
                self._t(descA), self._t(vA), self._t(smap.kf_feat_desc[k]),
                self._t(smap.kf_feat_valid[k]), uv_pred1=self._t(uvA),
                uv2=self._t(smap.kf_feat_uv[k]), radius=radius,
                max_dist=matching.TH_LOW, ratio=0.9, mutual=True)
            idx = idx.cpu().numpy()[:n]
            rows = np.nonzero(ok.cpu().numpy()[:n])[0]
            if len(rows) == 0:
                continue
            slot_pt = smap.kf_feat_pt[k, idx[rows]]
            fresh = slot_pt < 0
            smap.bind(k, idx[rows][fresh], pts[:n][rows[fresh]])
            for r in np.nonzero(~fresh)[0]:
                lp = int(pts[:n][rows[r]])
                cp = int(slot_pt[r])
                if lp == cp or not (smap.pt_valid[lp] and smap.pt_valid[cp]):
                    continue
                smap.replace_point(cp, lp)   # the loop-side point wins
                n_fused += 1
        return n_fused

    # ------------------------------------------------------------- entry
    def process_keyframe(self, smap: SlamMap, kf: int, bow_vec) -> bool:
        cand = self.detect(smap, kf, bow_vec)
        if cand is None:
            return False
        s3 = self.compute_sim3(smap, kf, cand)
        if s3 is None:
            return False
        R, t, s, ni = s3
        ok = self.correct(smap, kf, cand, (R, t, s))
        if ok:
            self.events.append({"kf": int(kf), "cand": int(cand),
                                "n_inliers": int(ni),
                                "sim3_scale": round(float(s), 4)})
        return ok
