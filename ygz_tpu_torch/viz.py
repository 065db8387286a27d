"""Offline visualization: tracked-frame overlays and map/trajectory renders.

Port of ``ygz_tpu/viz.py``, the headless counterpart of the reference's GUI
stack (FrameDrawer: the 2-D tracked-feature overlay with its state; MapDrawer:
map points, keyframes and the covisibility graph; Viewer: the Pangolin
window thread). These render to numpy RGB images, PNG files and matplotlib
figures. The frame overlay is pure numpy and ``save_png`` writes through
``io/png.py``; only ``draw_map`` needs matplotlib (imported when called,
with the Agg backend when saving).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

GREEN = np.array([40, 220, 60], np.uint8)
BLUE = np.array([80, 120, 255], np.uint8)
RED = np.array([235, 70, 50], np.uint8)


def _to_u8_rgb(img) -> np.ndarray:
    g = np.asarray(img)
    if g.dtype != np.uint8:
        g = np.clip(g, 0, 255).astype(np.uint8)
    if g.ndim == 2:
        g = np.stack([g] * 3, -1)
    return g.copy()


def _stamp_squares(rgb, uv, color, half: int = 3):
    h, w = rgb.shape[:2]
    for x, y in uv:
        xi, yi = int(round(x)), int(round(y))
        if not (half <= xi < w - half and half <= yi < h - half):
            continue
        rgb[yi - half, xi - half: xi + half + 1] = color
        rgb[yi + half, xi - half: xi + half + 1] = color
        rgb[yi - half: yi + half + 1, xi - half] = color
        rgb[yi - half: yi + half + 1, xi + half] = color
    return rgb


def draw_tracked_frame(img, uv, tracked=None, state: str = "OK",
                       n_map_points: int = None) -> np.ndarray:
    """FrameDrawer::DrawFrame equivalent:
    grayscale frame -> RGB with tracked features as green squares (lost /
    untracked candidates in red) and a status strip at the bottom.

    img: [H,W] grayscale (float or uint8). uv: [N,2] level-0 pixel coords.
    tracked: [N] bool (None = all tracked). Returns [H+16, W, 3] uint8.
    """
    rgb = _to_u8_rgb(img)
    uv = np.asarray(uv).reshape(-1, 2)
    if tracked is None:
        tracked = np.ones(len(uv), bool)
    tracked = np.asarray(tracked, bool)
    _stamp_squares(rgb, uv[~tracked], RED)
    _stamp_squares(rgb, uv[tracked], GREEN)

    # status strip (text as a simple intensity banner: state is color-coded
    # — green OK, blue initializing, red lost — with tracked-count tick bar)
    strip = np.zeros((16, rgb.shape[1], 3), np.uint8)
    col = {"OK": GREEN, "NOT_INITIALIZED": BLUE, "LOST": RED}.get(state, BLUE)
    strip[2:6, 2: 2 + min(120, rgb.shape[1] - 4)] = col
    n_tr = int(tracked.sum())
    bar = min(n_tr, rgb.shape[1] - 4)
    strip[9:13, 2: 2 + bar] = GREEN
    return np.concatenate([rgb, strip], axis=0)


def save_png(rgb: np.ndarray, path: str):
    from .io.png import write_png

    write_png(path, rgb)


def draw_map(smap, trajectory=None, path: Optional[str] = None, axes=(0, 2),
             show_covisibility: bool = False, recovered_pose=None):
    """MapDrawer equivalent: 2-D orthographic projection
    of map points (black), keyframes (blue triangles at camera centres),
    the spanning tree (light edges) and the frame trajectory (green).

    smap: backend.mapstate.SlamMap (host numpy arrays). trajectory:
    iterable of FrameRecord.
    axes: which world axes to plot (default X-Z, the reference's top view).
    recovered_pose: optional fn(rec)->(R,t) to apply post-hoc corrections.
    Returns the matplotlib figure; saves to `path` when given.
    """
    import matplotlib
    if path is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    a0, a1 = axes
    fig, ax = plt.subplots(figsize=(7, 7))
    pts = smap.pt_xyz[: smap.n_pt][smap.pt_valid[: smap.n_pt]]
    if len(pts):
        ax.scatter(pts[:, a0], pts[:, a1], s=1.0, c="0.25", alpha=0.45,
                   linewidths=0, label=f"{len(pts)} map points")

    centres = {}
    for k in range(smap.n_kf):
        if not smap.kf_valid[k]:
            continue
        c = -smap.kf_R[k].T @ smap.kf_t[k]
        centres[k] = c
    if centres:
        C = np.stack(list(centres.values()))
        ax.scatter(C[:, a0], C[:, a1], s=18, marker="^", c="#2050c0",
                   label=f"{len(centres)} keyframes", zorder=3)
        # spanning tree edges (reference draws the covisibility graph;
        # the tree is the load-bearing subset)
        for k, c in centres.items():
            p = int(smap.kf_parent[k])
            if p in centres:
                cp = centres[p]
                ax.plot([c[a0], cp[a0]], [c[a1], cp[a1]], c="#90a8e0",
                        lw=0.6, zorder=2)

    if trajectory is not None:
        cs = []
        for rec in trajectory:
            if rec.state != "OK":
                continue
            if recovered_pose is not None:
                R, t = recovered_pose(rec)
            else:
                R, t = rec.R, rec.t
            cs.append(-R.T @ t)
        if cs:
            cs = np.stack(cs)
            ax.plot(cs[:, a0], cs[:, a1], c="#18a040", lw=1.2,
                    label=f"{len(cs)} frames", zorder=4)

    ax.set_aspect("equal")
    ax.set_xlabel("xyz"[a0])
    ax.set_ylabel("xyz"[a1])
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


class DumpViewer:
    """Viewer::Run equivalent for a headless pipeline: call update() per
    frame; writes a frame overlay every `every` frames (the tracker's
    debug["viz_uv"] and state) and a map render at finish() (the map, the
    trajectory and recovered_pose). Drop-in observability for the dataset
    runners (the reference's Pangolin menu/follow-cam interactivity is out
    of scope)."""

    def __init__(self, out_dir: str, every: int = 30):
        self.out_dir = out_dir
        self.every = every
        self.n = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, tracker, img):
        self.n += 1
        if self.n % self.every:
            return
        dbg = tracker.debug or {}
        uv = dbg.get("viz_uv")
        if uv is None:
            uv = np.zeros((0, 2), np.float32)
        rgb = draw_tracked_frame(img, uv, state=tracker.state.name)
        save_png(rgb, os.path.join(self.out_dir, f"frame_{self.n:06d}.png"))

    def finish(self, tracker):
        draw_map(tracker.map, tracker.trajectory,
                 path=os.path.join(self.out_dir, "map.png"),
                 recovered_pose=tracker.recovered_pose)
