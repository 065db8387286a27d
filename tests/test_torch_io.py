"""Settings files, dataset readers and the PNG codec of the torch port
against the JAX reference (``ygz_tpu/io``, ``ygz_tpu/native``) and PIL."""
import dataclasses
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ygz_tpu import native as jnative
from ygz_tpu.io import config as jconfig, datasets as jdatasets
from ygz_tpu_torch.io import config as tconfig, datasets as tdatasets, png
from ygz_tpu_torch.utils.synthetic import SmoothScene

from test_io import EUROC_YAML

# the settings of tests/test_cli_e2e.py's tree (SmoothScene defaults)
CLI_YAML = """%YAML:1.0
Camera.fx: 400.0
Camera.fy: 400.0
Camera.cx: 319.5
Camera.cy: 239.5
Camera.width: 640
Camera.height: 480
Camera.fps: 20.0
bUseIMU: 1
test.VINSInitTime: 1.2
Camera.Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0,
          0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0,
          0.0, 0.0, 0.0, 1.0]
"""

TUM_YAML = """%YAML:1.0
---
# TUM fr1 (RGB-D): distortion with k3, a virtual baseline, depth factor
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 40.0
Camera.RGB: 1   # 1 RGB, 0 BGR
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 2.0
ORBextractor.nLevels: 4
"""

KITTI_YAML = """%YAML:1.0
# KITTI 00-02 (stereo, rectified)
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 386.1448
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 2000
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Tracking.KFMinGap: 2
"""

# rational distortion (bUseDistK6), the octree keypoint mode, nested
# mappings and YAML 1.1 scalars (PyYAML reads 1e-5 as a string, 010 as 8)
MISC_YAML = """%YAML:1.0
Camera.fx: 500.0
Camera.fy: 500.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.k1: -0.1
Camera.k2: 1e-5
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.001
Camera.bUseDistK6: 1
Camera.k4: 0.01
Camera.k5: -0.002
Camera.k6: 0.0003
Camera.fps: 25
ORBextractor.keypointMode: octree   # the reference's ORBSLAM keypoints
Tracking:
  CacheFeatures: 200
  KFMaxGap: 12
IMU:
  multiplyG: 1.02
oddities:
  octal: 010
  flag: on
  quoted: 'a # b'
  empty:
Camera.Tbc: [1.0, 0.0, 0.0, 0.01,
             0.0, 1.0, 0.0, 0.0,
             0.0, 0.0, 1.0, -0.02,
             0.0, 0.0, 0.0, 1.0]
"""


def _assert_same_settings(t, j):
    for f in ("fx", "fy", "cx", "cy", "width", "height", "bf"):
        assert getattr(t.camera, f) == getattr(j.camera, f), f
    np.testing.assert_array_equal(t.camera.dist.numpy(),
                                  np.asarray(j.camera.dist))
    for f in dataclasses.fields(j.tracker):
        assert getattr(t.tracker, f.name) == getattr(j.tracker, f.name), \
            f.name
    for f in dataclasses.fields(j.vio):
        np.testing.assert_array_equal(getattr(t.vio, f.name),
                                      getattr(j.vio, f.name), f.name)
    for f in ("fps", "rgb_order", "th_depth", "depth_map_factor"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.raw == j.raw


@pytest.mark.parametrize("text", [EUROC_YAML, CLI_YAML, TUM_YAML, KITTI_YAML,
                                  MISC_YAML],
                         ids=["euroc", "cli", "tum", "kitti", "k6_octree"])
def test_load_settings_matches_jax(text, tmp_path):
    _assert_same_settings(tconfig.load_settings(text),
                          jconfig.load_settings(text))
    path = tmp_path / "settings.yaml"
    path.write_text(text)
    _assert_same_settings(tconfig.load_settings(str(path)),
                          jconfig.load_settings(str(path)))


def test_load_settings_reads_what_the_reference_sets():
    s = tconfig.load_settings(MISC_YAML)
    assert s.tracker.keypoint_mode == "octree"
    assert s.tracker.kf_max_gap == 12 and s.tracker.cache_refill_below == 200
    assert s.camera.dist.tolist() == pytest.approx(
        [-0.1, 1e-5, 0.0, 0.0, 0.001, 0.01, -0.002, 0.0003])
    assert s.vio.Tbc[0, 3] == pytest.approx(0.01)
    assert s.raw["oddities.octal"] == 8 and s.raw["oddities.flag"] is True
    assert s.raw["oddities.quoted"] == "a # b"
    assert s.raw["oddities.empty"] is None
    # Tracking.KFMaxGap defaults to round(fps)
    assert tconfig.load_settings(TUM_YAML).tracker.kf_max_gap == 30


@pytest.mark.parametrize("text,line", [
    ("Camera.fx: 1.0\nCamera.fy 2.0\n", 2),
    ("Camera.fx: 1.0\n\nlist:\n  - 1\n", 4),
    ("a: 1\nb: [1, 2,\n 3\n", 2),
    ("a: 1\nb: !!binary abc\n", 2),
    ("a: 1\nb: [[1], [2]]\n", 2),
], ids=["no_colon", "block_sequence", "unclosed", "tag", "nested"])
def test_unreadable_line_raises_with_its_number(text, line):
    with pytest.raises(ValueError, match=f":{line}: "):
        tconfig.load_settings(text)


def _png(path, arr, mode=None):
    Image.fromarray(arr, mode).save(path) if mode else \
        Image.fromarray(arr).save(path)
    return str(path)


def _frame(rng, h=24, w=32):
    yy, xx = np.mgrid[:h, :w]
    smooth = 120 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 4.0)
    return np.clip(smooth + rng.normal(0, 4, (h, w)), 0, 255).astype(np.uint8)


def _euroc_tree(root, with_gt=True):
    mav = root / "mav0"
    (mav / "cam0" / "data").mkdir(parents=True)
    (mav / "imu0").mkdir(parents=True)
    ts = [1403636579763555584, 1403636579813555456, 1403636579863555584]
    rng = np.random.default_rng(0)
    with open(mav / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t in ts:
            f.write(f"{t},{t}.png\n")
            _png(mav / "cam0" / "data" / f"{t}.png", _frame(rng))
    with open(mav / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp,...\n")
        for i in range(35):
            t = ts[0] - 10 * 5000000 + i * 5000000
            g, a = rng.normal(size=3), rng.normal(size=3)
            f.write(f"{t},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")
    if with_gt:
        gt = mav / "state_groundtruth_estimate0"
        gt.mkdir()
        with open(gt / "data.csv", "w") as f:
            f.write("#ts,px,py,pz,qw,qx,qy,qz\n")
            for i, t in enumerate(ts):
                f.write(f"{t},{0.1 * i},{-0.2 * i},{0.05},1,0,0,0\n")


def _same_frames(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.t, x.img_path, x.depth_path) == (y.t, y.img_path,
                                                   y.depth_path)
        assert len(x.imu) == len(y.imu)
        for s, r in zip(x.imu, y.imu):
            assert s.t == r.t
            np.testing.assert_array_equal(s.gyro, r.gyro)
            np.testing.assert_array_equal(s.acc, r.acc)


@pytest.mark.parametrize("with_gt", [True, False])
def test_euroc_reader_matches_jax(tmp_path, with_gt):
    _euroc_tree(tmp_path, with_gt)
    for root in (tmp_path, tmp_path / "mav0"):
        t = tdatasets.EurocDataset(str(root), with_imu=True)
        j = jdatasets.EurocDataset(str(root), with_imu=True)
        _same_frames(t.frames, j.frames)
        # samples with t <= the frame's (frame 1 is 128 ns before a sample)
        assert [len(f.imu) for f in t.frames] == [11, 9, 11]
        if with_gt:
            for a, b in zip(t.gt, j.gt):
                np.testing.assert_array_equal(a, b)
        else:
            assert t.gt is None and j.gt is None
        for f in t.frames:
            img = f.load()
            assert img.dtype == np.float32
            np.testing.assert_array_equal(img, jnative.decode_gray(
                f.img_path))
    _same_frames(tdatasets.EurocDataset(str(tmp_path)).frames,
                 jdatasets.EurocDataset(str(tmp_path)).frames)


def test_tum_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for name, stamps in [("rgb", [1.00, 1.05, 1.10, 1.15]),
                         ("depth", [1.004, 1.052, 1.40, 1.16])]:
        (tmp_path / name).mkdir()
        with open(tmp_path / f"{name}.txt", "w") as f:
            f.write("# ts path\n")
            for t in stamps:
                p = f"{name}/{t:.4f}.png"
                f.write(f"{t} {p}\n")
                if name == "rgb":
                    _png(tmp_path / p, np.stack([_frame(rng)] * 3, -1)
                         + rng.integers(0, 9, (24, 32, 3)).astype(np.uint8))
                else:
                    _png(tmp_path / p, rng.integers(
                        0, 60000, (24, 32)).astype(np.uint16))
    for kw in ({}, {"with_depth": False}, {"max_dt": 0.001}):
        t = tdatasets.TumRgbdDataset(str(tmp_path), **kw)
        j = jdatasets.TumRgbdDataset(str(tmp_path), **kw)
        _same_frames(t.frames, j.frames)
    t = tdatasets.TumRgbdDataset(str(tmp_path))
    assert len(t) == 3 and t.frames[0].depth_path.endswith("1.0040.png")
    j = jdatasets.TumRgbdDataset(str(tmp_path))
    for a, b in zip(t, j):
        # 16-bit depth: the raw values over the factor, as PIL gives them
        np.testing.assert_array_equal(a.load_depth(), b.load_depth())
        np.testing.assert_array_equal(a.load_depth(1000.0),
                                      b.load_depth(1000.0))
        # RGB frames: the libpng conversion of the JAX native route
        np.testing.assert_array_equal(a.load(), b.load())


def test_kitti_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for root, seq in ((tmp_path / "a", "00"), (tmp_path / "b", "05")):
        seq_dir = root / "sequences" / seq
        for cam in ("image_0", "image_1"):
            (seq_dir / cam).mkdir(parents=True)
            for i in range(3):
                _png(seq_dir / cam / f"{i:06d}.png", _frame(rng))
        (seq_dir / "times.txt").write_text(
            "0.000000e+00\n1.036130e-01\n2.072240e-01\n")
        for cam in ("image_0", "image_1"):
            t = tdatasets.KittiOdometryDataset(str(root), seq=seq, cam=cam)
            j = jdatasets.KittiOdometryDataset(str(root), seq=seq, cam=cam)
            _same_frames(t.frames, j.frames)
        direct = tdatasets.KittiOdometryDataset(str(seq_dir))
        _same_frames(direct.frames, jdatasets.KittiOdometryDataset(
            str(seq_dir)).frames)


def test_png_gray_matches_the_jax_native_route(tmp_path):
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(24, 32), (37, 53), (480, 752)]):
        p = _png(tmp_path / f"g{i}.png", _frame(rng, h, w))
        np.testing.assert_array_equal(png.decode_gray(p),
                                      jnative.decode_gray(p))
        np.testing.assert_array_equal(png.read_png(p),
                                      np.asarray(Image.open(p)))


def test_png_rgb_matches_the_jax_native_route(tmp_path):
    """C-ref13: libpng's rgb_to_gray (the JAX native route) against PIL's
    convert("L") (its fallback) differ on colour pixels; io/png.py and the
    port's loader give libpng's bytes."""
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    rgb[:5] = rgb[:5, :, :1]                  # gray pixels keep their value
    rgba = np.concatenate([rgb, rng.integers(0, 256, (40, 56, 1),
                                             dtype=np.uint8)], -1)
    la = np.stack([rgb[..., 0], rgb[..., 1]], -1)
    for name, arr, mode in (("rgb", rgb, None), ("rgba", rgba, None),
                            ("la", la, "LA")):
        p = _png(tmp_path / f"{name}.png", arr, mode)
        got = png.decode_gray(p)
        np.testing.assert_array_equal(got, jnative.decode_gray(p))
        np.testing.assert_array_equal(png.read_png(p), arr)
    pil = np.asarray(Image.open(str(tmp_path / "rgb.png")).convert("L"))
    assert (png.decode_gray(str(tmp_path / "rgb.png")) != pil).mean() > 0.3


def test_png_16bit_depth_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    d = rng.integers(0, 65536, (30, 44)).astype(np.uint16)
    p = _png(tmp_path / "d.png", d)
    np.testing.assert_array_equal(png.read_png(p), d)
    item = tdatasets.FrameItem(t=0.0, img_path=p, depth_path=p)
    want = jdatasets.FrameItem(t=0.0, img_path=p, depth_path=p)
    np.testing.assert_array_equal(item.load_depth(), want.load_depth())
    # a 16-bit frame read as gray keeps the high byte (png_set_strip_16)
    np.testing.assert_array_equal(png.decode_gray(p), jnative.decode_gray(p))
    np.testing.assert_array_equal(png.decode_gray(p),
                                  (d >> 8).astype(np.float32))


def _filtered_png(path, arr, filters, depth=8, color=0):
    """A PNG whose row r is written with filters[r % len(filters)] (the
    five PNG filter types, by the specification)."""
    h = arr.shape[0]
    raw = arr.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1) \
        .view(np.uint8).astype(np.int32)
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[color] * depth // 8
    out, prior = [], np.zeros(raw.shape[1], np.int32)
    for r in range(h):
        cur, kind = raw[r], filters[r % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(png.SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", arr.shape[1], h,
                                           depth, color, 0, 0, 0)))
        f.write(chunk(b"tEXt", b"Comment\x00ancillary chunks are skipped"))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(out))))
        f.write(chunk(b"IEND", b""))
    return str(path)


@pytest.mark.parametrize("depth,color", [(8, 0), (8, 2), (8, 6), (16, 0),
                                         (16, 2)],
                         ids=["gray8", "rgb8", "rgba8", "gray16", "rgb16"])
def test_png_decodes_all_five_filters(tmp_path, depth, color):
    rng = np.random.default_rng(depth + color)
    ch = {0: 1, 2: 3, 6: 4}[color]
    shape = (17, 23) if ch == 1 else (17, 23, ch)
    arr = rng.integers(0, 2 ** depth, shape).astype(
        np.uint16 if depth == 16 else np.uint8)
    p = _filtered_png(tmp_path / "f.png", arr, [0, 1, 2, 3, 4, 4, 3, 2, 1],
                      depth, color)
    np.testing.assert_array_equal(png.read_png(p), arr)
    # the C unfilter (native/unfilter.cpp) and the Python one agree
    assert png.unfilter_route() == "C"
    np.testing.assert_array_equal(png.read_png(p, force_python=True), arr)
    if depth == 8:
        np.testing.assert_array_equal(png.read_png(p), np.asarray(
            Image.open(p)))
    # the gray conversion, 16-bit colour included, against libpng's
    np.testing.assert_array_equal(png.decode_gray(p), jnative.decode_gray(p))


def test_png_encode_round_trip(tmp_path):
    rng = np.random.default_rng(7)
    for name, arr in (("g8", rng.integers(0, 256, (31, 47), dtype=np.uint8)),
                      ("rgb", rng.integers(0, 256, (31, 47, 3),
                                           dtype=np.uint8)),
                      ("g16", rng.integers(0, 65536, (31, 47)).astype(
                          np.uint16))):
        for filters in ((0,), (0, 1, 2, 3, 4), (4,), "adaptive"):
            p = str(tmp_path / f"{name}.png")
            png.write_png(p, arr, filters=filters)
            np.testing.assert_array_equal(png.read_png(p), arr)
            np.testing.assert_array_equal(
                png.read_png(p, force_python=True), arr)
            np.testing.assert_array_equal(np.asarray(Image.open(p)), arr)
    with pytest.raises(TypeError):
        png.write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "x.png"), arr, filters=(5,))


def test_png_adaptive_filters_take_the_least_sum(tmp_path):
    """filters="adaptive": each row takes the filter type whose bytes, read
    as signed, have the least absolute sum (each type written alone by the
    specification's predictors, _filtered_png); on a rendered frame that is
    mostly Average and Paeth, the types that cost the Python unfilter a
    loop per byte."""
    scene = SmoothScene(seed=11, w=160, h=120, f=100.0, tex_size=600)
    img = scene.render_u8(np.eye(3), np.zeros(3))

    def scanlines(path):
        data = open(path, "rb").read()
        idat = b"".join(b for k, b in png._chunks(data, path)
                        if k == b"IDAT")
        return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
            120, 161)

    png.write_png(str(tmp_path / "a.png"), img, filters="adaptive")
    got = scanlines(str(tmp_path / "a.png"))
    sums = []
    for kind in range(5):
        rows = scanlines(_filtered_png(tmp_path / f"{kind}.png", img,
                                       [kind]))
        sums.append(np.abs(rows[:, 1:].view(np.int8).astype(np.int64))
                    .sum(1))
    sums = np.stack(sums)
    np.testing.assert_array_equal(got[:, 0], sums.argmin(0))
    assert len(set(got[:, 0].tolist())) > 1
    assert np.isin(got[:, 0], (3, 4)).mean() > 0.9
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "a.png")),
                                  img)


def test_png_refuses_palette_and_interlaced(tmp_path):
    pal = Image.fromarray(np.zeros((8, 8), np.uint8)).convert("P")
    pal.save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="palette"):
        png.read_png(str(tmp_path / "p.png"))
    p = _filtered_png(tmp_path / "i.png", np.zeros((8, 8), np.uint8), [0])
    data = bytearray(open(p, "rb").read())
    data[28] = 1                                 # IHDR's interlace method
    crc = zlib.crc32(bytes(data[12:29]))
    data[29:33] = struct.pack(">I", crc)
    (tmp_path / "i.png").write_bytes(bytes(data))
    assert Image.open(p).info.get("interlace") == 1
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(str(tmp_path / "i.png"))
    (tmp_path / "n.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(tmp_path / "n.png"))
