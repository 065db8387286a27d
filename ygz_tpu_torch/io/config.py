"""Settings files compatible with the reference's cv::FileStorage YAML.

Port of ``ygz_tpu/io/config.py``: the same keys and defaults (the Tracking
ctor's camera intrinsics and distortion, fps, the ORB extractor's
parameters with ``ORBextractor.keypointMode``, Tracking.CacheFeatures and
the VIO block: bUseIMU, Camera.Tbc, LocalMapping.LocalWindowSize,
test.VINSInitTime), filling the port's ``Camera`` and ``TrackerConfig``.

Without PyYAML it reads the subset those files use: the ``%YAML:1.0``
header, ``---``, ``#`` comments, ``key: scalar``, flow sequences
(``[...]``, which may span lines), ``!!opencv-matrix`` blocks and nested
mappings (flattened to dotted keys, as the JAX package's ``_flatten``
does). Scalars resolve as PyYAML's YAML 1.1 resolver resolves them: null,
bool, int, float, else a string. A line it cannot read raises ValueError
with its line number.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

from ..frontend.tracker import TrackerConfig
from ..geometry.camera import Camera


@dataclass
class VioSettings:
    use_imu: bool = False
    Tbc: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    local_window_size: int = 10
    vins_init_time: float = 15.0
    imu_delay_to_image: float = 0.0
    multiply_g: float = 1.0


@dataclass
class Settings:
    camera: Camera
    tracker: TrackerConfig
    vio: VioSettings
    fps: float = 30.0
    rgb_order: int = 1
    th_depth: float = 35.0
    depth_map_factor: float = 1.0
    raw: dict = field(default_factory=dict)


# PyYAML's implicit resolvers (YAML 1.1), sexagesimal forms left out
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_KEY = re.compile(r"^([^\s:#][^:#]*?)\s*:(?:\s+(.*))?$")


def _scalar(text: str):
    """A plain or quoted scalar, resolved as PyYAML resolves it."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.endswith("inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith("nan"):
            return float("nan")
        return float(v)
    return text


def _strip_comment(line: str) -> str:
    """The line without a '#' comment (one at the start or after a space,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str, source: str = "<settings>") -> dict:
    """The cv::FileStorage subset of YAML (module docstring) -> nested
    dicts of scalars and lists."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or (no == 1 and line.startswith("%YAML")) \
                or line.strip() == "---":
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"{source}:{no}: tab in indentation: {raw!r}")
        lines.append((no, len(line) - len(line.lstrip()), line.strip(), raw))

    root: dict = {}
    stack = [(-1, root)]            # (indent, mapping) of the open blocks
    i = 0
    while i < len(lines):
        no, indent, body, raw = lines[i]
        i += 1
        while indent <= stack[-1][0]:
            stack.pop()
        m = _KEY.match(body)
        if not m:
            raise ValueError(f"{source}:{no}: cannot read {raw!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        if value.startswith("!!opencv-matrix"):
            value = value[len("!!opencv-matrix"):].strip()
        if value.startswith("!"):
            raise ValueError(f"{source}:{no}: unsupported tag in {raw!r}")
        target = stack[-1][1]
        if value.startswith("["):
            # a flow sequence, possibly continued on the following lines
            while not value.endswith("]"):
                if i == len(lines):
                    raise ValueError(f"{source}:{no}: unclosed '[' in "
                                     f"{raw!r}")
                value += " " + lines[i][2]
                i += 1
            items = value[1:-1].strip().rstrip(",")
            if "[" in items or "]" in items:
                raise ValueError(f"{source}:{no}: nested sequences are not "
                                 f"supported: {raw!r}")
            target[key] = ([_scalar(v.strip()) for v in items.split(",")]
                           if items else [])
        elif value.startswith(("{", "|", ">", "&", "*")):
            raise ValueError(f"{source}:{no}: cannot read {raw!r}")
        elif value:
            target[key] = _scalar(value)
        elif i < len(lines) and lines[i][1] > indent:
            child: dict = {}
            target[key] = child
            stack.append((indent, child))
        else:
            target[key] = None
    return root


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) and not {"rows", "cols", "data"} <= set(v):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def load_settings(path_or_text: str) -> Settings:
    """Settings from a settings file's path or its text."""
    source = "<settings>"
    if os.path.exists(path_or_text):
        source = path_or_text
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    flat = _flatten(parse_yaml(text, source))

    def get(key, default=None):
        return flat.get(key, default)

    dist = [get("Camera.k1", 0.0), get("Camera.k2", 0.0),
            get("Camera.p1", 0.0), get("Camera.p2", 0.0),
            get("Camera.k3", 0.0)]
    if get("Camera.bUseDistK6", 0):
        dist += [get("Camera.k4", 0.0), get("Camera.k5", 0.0),
                 get("Camera.k6", 0.0)]
    cam = Camera.make(
        fx=get("Camera.fx", 458.654), fy=get("Camera.fy", 457.296),
        cx=get("Camera.cx", 367.215), cy=get("Camera.cy", 248.375),
        width=int(get("Camera.width", 752)),
        height=int(get("Camera.height", 480)),
        dist=np.array(dist, np.float32),
        bf=get("Camera.bf", 0.0))

    tracker = TrackerConfig(
        n_features=int(get("ORBextractor.nFeatures", 512)),
        n_levels=int(get("ORBextractor.nLevels", 4)),
        scale_factor=float(get("ORBextractor.scaleFactor", 2.0)),
        fast_th=float(get("ORBextractor.iniThFAST", 20)),
        fast_th_min=float(get("ORBextractor.minThFAST", 7)),
        cache_refill_below=int(get("Tracking.CacheFeatures", 150)),
        kf_min_gap=int(get("Tracking.KFMinGap", 3)),
        # reference mMaxFrames = fps: force a keyframe at least once per
        # second of camera time (src/Tracking.cc "mMaxFrames = fps")
        kf_max_gap=int(get("Tracking.KFMaxGap",
                           round(float(get("Camera.fps", 30.0))))),
        keypoint_mode=str(get("ORBextractor.keypointMode", "grid")),
        th_depth=float(get("ThDepth", get("Camera.ThDepth", 35.0))),
    )

    vio = VioSettings(
        use_imu=bool(get("bUseIMU", get("test.bUseIMU", 0))),
        local_window_size=int(get("LocalMapping.LocalWindowSize", 10)),
        vins_init_time=float(get("test.VINSInitTime", 15.0)),
        imu_delay_to_image=float(get("Camera.delaytoimu", 0.0)),
        multiply_g=float(get("IMU.multiplyG", 1.0)),
    )
    tbc = get("Camera.Tbc")
    if isinstance(tbc, dict) and "data" in tbc:
        vio.Tbc = np.array(tbc["data"], np.float32).reshape(4, 4)
    elif isinstance(tbc, (list, tuple)):
        vio.Tbc = np.array(tbc, np.float32).reshape(4, 4)

    return Settings(camera=cam, tracker=tracker, vio=vio,
                    fps=float(get("Camera.fps", 30.0)),
                    rgb_order=int(get("Camera.RGB", 1)),
                    th_depth=float(get("ThDepth", get("Camera.ThDepth", 35.0))),
                    depth_map_factor=float(get("DepthMapFactor", 1.0)),
                    raw=flat)
