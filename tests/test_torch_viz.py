"""The torch port's offline viewer against the JAX reference: the frame
overlay bit for bit, the map render and DumpViewer on a port map and a
port tracker's state."""
import numpy as np
import pytest
import torch

from ygz_tpu import viz as jviz
from ygz_tpu_torch import viz
from ygz_tpu_torch.backend.mapstate import SlamMap
from ygz_tpu_torch.frontend.tracker import FrameRecord, State
from ygz_tpu_torch.io import png


@pytest.mark.parametrize("state", ["OK", "LOST", "NOT_INITIALIZED"])
def test_draw_tracked_frame_matches_jax(state):
    rng = np.random.default_rng(0)
    img = rng.uniform(-20, 280, (120, 160)).astype(np.float32)
    uv = rng.uniform(-5, [165, 125], (300, 2))
    tracked = rng.random(300) > 0.3
    for args in ((img, uv, tracked), (img.astype(np.uint8), uv, None),
                 (img, np.zeros((0, 2)), None)):
        got = viz.draw_tracked_frame(*args, state=state)
        want = jviz.draw_tracked_frame(*args, state=state)
        assert got.dtype == np.uint8 and got.shape == (136, 160, 3)
        np.testing.assert_array_equal(got, want)
    assert (got[-14:-10, 2:122] == {"OK": viz.GREEN, "LOST": viz.RED}.get(
        state, viz.BLUE)).all()


def _port_map():
    smap = SlamMap(max_kf=4, max_pt=64, max_feat=8)
    feats = {"uv": np.zeros((1, 2), np.float32),
             "level": np.zeros(1, np.int32),
             "angle": np.zeros(1, np.float32),
             "desc": np.zeros((1, 256), np.uint8),
             "valid": np.zeros(1, bool)}
    for k in range(3):
        t = np.array([0.1 * k, 0.0, 0.0], np.float32)
        smap.add_keyframe(np.eye(3, dtype=np.float32), t, feats)
        if k:
            smap.kf_parent[k] = k - 1
    ids = smap.alloc_points(20)
    smap.pt_xyz[ids] = np.random.default_rng(1).normal(
        size=(20, 3)).astype(np.float32) + [0, 0, 5]
    smap.pt_valid[ids] = True
    return smap


def test_draw_map_and_save_png(tmp_path):
    smap = _port_map()
    traj = [FrameRecord(ts=0.05 * i, R=np.eye(3, dtype=np.float32),
                        t=np.array([-0.02 * i, 0, 0], np.float32),
                        state="OK" if i != 3 else "LOST")
            for i in range(8)]
    out = tmp_path / "map.png"
    fig = viz.draw_map(smap, traj, path=str(out))
    assert out.exists() and out.stat().st_size > 1000
    labels = fig.axes[0].get_legend_handles_labels()[1]
    assert labels == ["20 map points", "3 keyframes", "7 frames"]
    rgb = viz.draw_tracked_frame(np.zeros((60, 80), np.float32),
                                 np.array([[40.0, 30.0]]))
    viz.save_png(rgb, str(tmp_path / "f.png"))
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "f.png")), rgb)


class _Tracker:
    """What DumpViewer reads of a port tracker."""

    def __init__(self, smap):
        self.map = smap
        self.state = State.OK
        self.debug = {"viz_uv": np.array([[20.0, 30.0], [50.0, 40.0]],
                                         np.float32)}
        self.trajectory = [FrameRecord(ts=0.0, R=np.eye(3, dtype=np.float32),
                                       t=np.zeros(3, np.float32), state="OK",
                                       ref_kf=0)]
        self.calls = 0

    def recovered_pose(self, rec):
        self.calls += 1
        return rec.R, rec.t + 1.0


def test_dump_viewer_writes_overlays_and_the_map(tmp_path):
    tr = _Tracker(_port_map())
    viewer = viz.DumpViewer(str(tmp_path / "viz"), every=2)
    img = np.full((60, 80), 90, np.uint8)
    for _ in range(4):
        viewer.update(tr, img)
    tr.debug = {}
    viewer.update(tr, img)
    viewer.update(tr, torch.zeros(60, 80).numpy())
    names = sorted(p.name for p in (tmp_path / "viz").iterdir())
    assert names == ["frame_000002.png", "frame_000004.png",
                     "frame_000006.png"]
    got = png.read_png(str(tmp_path / "viz" / "frame_000002.png"))
    np.testing.assert_array_equal(got, jviz.draw_tracked_frame(
        img, tr.debug.get("viz_uv", np.array([[20.0, 30.0], [50.0, 40.0]])),
        state="OK"))
    viewer.finish(tr)
    assert (tmp_path / "viz" / "map.png").stat().st_size > 1000
    assert tr.calls == 1
