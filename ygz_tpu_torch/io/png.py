"""PNG decode and encode in numpy and the standard library's zlib.

It reads the PNGs of the EuRoC, TUM RGB-D and KITTI trees: 8-bit gray,
8-bit RGB and RGBA, 8-bit gray with alpha, and 16-bit gray, RGB and RGBA,
non-interlaced, with any of the five row filters. Palette and interlaced
files and bit depths below 8 raise. Ancillary chunks are skipped.

``decode_gray`` gives what the native loader gives (``native/loader.cpp``),
bit for bit: alpha is dropped; a colour pixel becomes gray by libpng's
default ``rgb_to_gray`` fixed-point weights (6968, 23434, 2366 in units of
2**-15; close to ITU-R 709), truncated on 8-bit samples and rounded on
16-bit ones; a 16-bit sample keeps its high byte (``png_set_strip_16``).
A pixel whose channels are equal keeps its value.

Rows are unfiltered by ``native/unfilter.cpp`` (a C++ loop with no
libpng, built on first use and called through ctypes) where a C++ compiler
is found, and by numpy and a Python loop otherwise: that loop runs once per
byte of every Average or Paeth row, and libpng, OpenCV and PIL write most
rows of a camera frame with Paeth. ``unfilter_route()`` names the route.

``write_png`` writes 8-bit gray or RGB and 16-bit gray, with filter 0 on
every row, with the filter types it is given in turn, or with libpng's
adaptive choice per row, for the synthesized dataset trees.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 gray, 2 RGB, 4 gray + alpha, 6 RGBA)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# libpng's default rgb_to_gray coefficients (png_set_rgb_to_gray_fixed with
# negative red and green), in units of 2**-15
RGB_TO_GRAY = (6968, 23434, 32768 - 6968 - 23434)


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        yield kind, data[pos + 8: pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth_row(cur, prior, bpp: int):
    """Paeth-filtered row -> raw bytes (in place), byte by byte."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur, prior, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter_py(kinds, data, bpp: int):
    """Filtered rows -> [h, stride] uint8 in numpy and Python."""
    h, stride = data.shape
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = int(kinds[y]), data[y]
        if kind == 0:
            cur = row
        elif kind == 1:     # Sub: a running sum per byte of the pixel
            cur = np.cumsum(row.reshape(-1, bpp), 0, dtype=np.uint8
                            ).reshape(-1)
        elif kind == 2:     # Up
            cur = row + prior
        else:
            buf = bytearray(row.tobytes())
            (_average_row if kind == 3 else _paeth_row)(
                buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        out[y] = cur
        prior = out[y]
    return out


def unfilter_route() -> str:
    """'C' when native/unfilter.cpp built, else 'Python (<why>)'."""
    from .. import native

    fn, why = native.unfilter_fn()
    return "C" if fn is not None else f"Python ({why})"


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str,
              force_python: bool = False):
    """The filtered scanlines -> [h, stride] uint8."""
    from .. import native

    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if not kinds.any():
        return data.copy()
    if (kinds > 4).any():
        raise ValueError(f"{path}: unknown PNG row filter "
                         f"{int(kinds[kinds > 4][0])}")
    fn = None if force_python else native.unfilter_fn()[0]
    if fn is None:
        return _unfilter_py(kinds, data, bpp)
    out = np.empty((h, stride), np.uint8)
    fn(rows.ctypes.data, out.ctypes.data, h, stride, bpp)
    return out


def read_png(path: str, force_python: bool = False) -> np.ndarray:
    """The samples of a PNG file: [H, W] for gray, [H, W, C] otherwise
    (C = 2 gray + alpha, 3 RGB, 4 RGBA); uint8 or uint16 by bit depth.
    force_python unfilters in Python even where the C route built."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} (palette) is not "
                         "supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} is not supported")
    ch = CHANNELS[color]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp, path,
                     force_python)
    if depth == 16:
        rows = rows.view(">u2").astype(np.uint16)
    return rows.reshape(h, w) if ch == 1 else rows.reshape(h, w, ch)


def to_gray8(samples: np.ndarray) -> np.ndarray:
    """read_png's samples -> [H, W] uint8 gray, as the native loader makes
    them (see the module docstring)."""
    if samples.ndim == 3:
        if samples.shape[2] in (2, 4):      # drop alpha
            samples = samples[..., :-1]
        if samples.shape[2] == 3:
            rc, gc, bc = RGB_TO_GRAY
            c = samples.astype(np.uint32)
            r, g, b = c[..., 0], c[..., 1], c[..., 2]
            mix = rc * r + gc * g + bc * b
            if samples.dtype == np.uint16:
                mix = mix + 16384
            gray = np.where((r == g) & (r == b), r, mix >> 15)
        else:
            gray = samples[..., 0]
    else:
        gray = samples
    if samples.dtype == np.uint16:
        return (np.asarray(gray) >> 8).astype(np.uint8)
    return np.asarray(gray).astype(np.uint8)


def decode_gray(path: str, force_python: bool = False) -> np.ndarray:
    """[H, W] float32 gray of a PNG file (0..255)."""
    return to_gray8(read_png(path, force_python)).astype(np.float32)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows, bpp: int, filters):
    """Raw rows [h, stride] uint8 -> filtered scanlines [h, 1 + stride]:
    row r with filters[r % len(filters)], or with "adaptive" the type whose
    bytes, read as signed, have the least absolute sum (libpng's
    heuristic; the first such type on a tie)."""
    h, stride = rows.shape
    x = rows.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, bpp:] = x[:, :-bpp]
    b[1:] = x[:-1]
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    cand = ((x[None] - preds) & 0xFF).astype(np.uint8)
    if isinstance(filters, str):
        if filters != "adaptive":
            raise ValueError(f"filters: 'adaptive' or filter types, got "
                             f"{filters!r}")
        kinds = np.abs(cand.view(np.int8).astype(np.int32)).sum(2).argmin(0)
    else:
        kinds = np.resize(np.asarray(filters, np.int64), h)
        if ((kinds < 0) | (kinds > 4)).any():
            raise ValueError(f"PNG filter types are 0..4, got {filters}")
    out = cand[kinds, np.arange(h)]
    return np.concatenate([kinds[:, None].astype(np.uint8), out], 1)


def write_png(path: str, arr, level: int = 1, filters=(0,)):
    """Write [H, W] uint8 or uint16 gray, or [H, W, 3] uint8 RGB, as a PNG;
    row r with filter type filters[r % len(filters)], or with
    filters="adaptive" as libpng chooses."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8 and arr.ndim == 2:
        depth, color, bpp = 8, 0, 1
    elif arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
        depth, color, bpp = 8, 2, 3
    elif arr.dtype == np.uint16 and arr.ndim == 2:
        depth, color, bpp = 16, 0, 2
        arr = arr.astype(">u2")
    else:
        raise TypeError(f"write_png takes uint8 [H, W] or [H, W, 3], or "
                        f"uint16 [H, W]; got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    rows = _filter_rows(arr.reshape(h, -1).view(np.uint8), bpp, filters)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))
