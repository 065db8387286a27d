"""The benchmark's harness: finds a cell's configuration, traffic mix,
limits and per-layer readers by name, sets the port up, runs the window,
reads the traced slice and judges the timed path's output.

Everything of one configuration, mix, cell or metric is a file of its own:

- ``configs/<config>.json``: the deployment (source, ``sensor``, for a
  mono-inertial rig ``imu_hz``, what was assumed), naming its settings file
  ``configs/<config>.yaml`` in the reference's cv::FileStorage format,
  which the port reads through its own ``ygz_tpu_torch/io/config.py``;
- ``traffic/<mix>.json``: the rate frames are due at, whether the
  mapping worker runs, and the lap the generator renders (its texture from
  the mix's ``texture_seed`` where it names one, else from the run's seed);
- ``workloads/<cell>.json``: the cell's warm-up and traced frames (and, of
  a mono-inertial cell, ``max_vi_init_frames``) and the limits of its
  correctness numbers;
- ``metrics/<metric>.py`` (else ``metrics/<metric less its last dotted
  part>.py``): a ``read(ctx)`` returning the metric or None.

Only the window is timed: set-up renders one lap on the device (with the
right views or the depth maps the sensor needs, or the lap's IMU), builds
the System for the configuration's sensor, initializes it (a mono-inertial
System until VINS initialization has run) and tracks the warm frames, and
drains the mapping worker. The window feeds the sensor's entry
(``ENTRIES``: ``track_monocular``, ``track_stereo``, ``track_rgbd`` or
``track_mono_vi``) one frame at a time, each when it is due, and stops a
run on the card that falls ``STOP_LATE_S`` behind the camera.
"""
from __future__ import annotations

import importlib.util
import json
import re
import statistics
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import reference, scene

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the System entry each sensor's frames are fed through; the runs, the
# fault tests and the controls all take it from here
ENTRIES = {"MONOCULAR": "track_monocular", "STEREO": "track_stereo",
           "RGBD": "track_rgbd", "MONO_VI": "track_mono_vi"}
SENSORS = tuple(ENTRIES)
# the sensors that give the metric scale: a stereo baseline, a depth map,
# an accelerometer
METRIC_SENSORS = ("STEREO", "RGBD", "MONO_VI")
# the 1.25 by which the metric_scale control mis-states a metric sensor's
# scale
CONTROL_SCALE = 1.25
# a benchmark run on the card stops when a frame is fed this many seconds
# after it was due (400 frames at 20 Hz): a program that cannot keep the
# camera's rate would otherwise feed a late window for many minutes. A
# sound monocular run has fed a frame 1.3 s late after a loop closure, so
# the stop stands well above that
STOP_LATE_S = 20.0


# ------------------------------------------------------------------ lookups
def benchmark_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str) -> SimpleNamespace:
    """The cell `name` of BENCHMARK.json with its configuration, mix,
    workload file and metric entries."""
    spec = benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = read_config(ROOT / conf["file"])
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return SimpleNamespace(
        name=name, chips=int(cell["chips"]), config=config,
        traffic=json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        workload=json.loads((BENCH / "workloads" / f"{name}.json")
                            .read_text()),
        end_to_end=e2e, per_layer=per_layer)


def read_config(path) -> dict:
    """A configuration's JSON with `settings_path`, the path of the
    settings file it names, beside it."""
    path = Path(path)
    config = json.loads(path.read_text())
    config["settings_path"] = str(path.parent / config["settings"])
    return config


def sensor_of(config: dict) -> str:
    """The sensor a configuration names (MONOCULAR where it names none)."""
    sensor = config.get("sensor", "MONOCULAR")
    if sensor not in SENSORS:
        raise ValueError(f"sensor {sensor!r}: one of {SENSORS}")
    return sensor


def controls(config: dict) -> list:
    """The correctness controls that mis-state something the configuration
    has: ``pinhole`` where its settings give a lens distortion,
    ``metric_scale`` where its sensor gives the metric scale."""
    dist = camera_dict(settings_numbers(config["settings_path"]))["dist"]
    return ((["pinhole"] if any(dist) else [])
            + (["metric_scale"] if sensor_of(config) in METRIC_SENSORS
               else []))


def metric_reader(name: str):
    """The read(ctx) of metrics/<name>.py, else of metrics/<name less its
    last dotted part>.py."""
    for stem in (name, name.rsplit(".", 1)[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"slam_bench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{BENCH / 'metrics'}")


def settings_numbers(path) -> dict:
    """The scalar `key: number` lines of a settings file, read here so the
    generator takes nothing from the port."""
    text = Path(path).read_text()
    out = {}
    for m in re.finditer(r"^([A-Za-z][\w.]*):\s*([-+0-9.eE]+)\s*(?:#.*)?$",
                         text, re.M):
        out[m.group(1)] = float(m.group(2))
    return out


def settings_matrix(path, key):
    """The numbers of the settings file's matrix `key` (an opencv-matrix's
    `data` or a flow sequence) as a float64 array, or None where the file
    has no such key; read here so the generator takes nothing from the
    port."""
    text = re.sub(r"#.*", "", Path(path).read_text())
    m = re.search(rf"^{re.escape(key)}:[^\[]*?\[([^\]]*)\]", text,
                  re.M | re.S)
    if m is None:
        return None
    return np.array([float(v) for v in m.group(1).split(",") if v.strip()])


def camera_dict(nums: dict, scale: float = 1.0) -> dict:
    """The renderer's camera from the settings (scaled for CPU rehearsals:
    intrinsics, size and bf together, so the baseline keeps its metres;
    distortion unchanged)."""
    return {"fx": nums["Camera.fx"] * scale, "fy": nums["Camera.fy"] * scale,
            "cx": (nums["Camera.cx"] + 0.5) * scale - 0.5,
            "cy": (nums["Camera.cy"] + 0.5) * scale - 0.5,
            "width": int(round(nums["Camera.width"] * scale)),
            "height": int(round(nums["Camera.height"] * scale)),
            "bf": nums.get("Camera.bf", 0.0) * scale,
            "dist": [nums.get(f"Camera.{k}", 0.0)
                     for k in ("k1", "k2", "p1", "p2", "k3")]}


class FellBehind(RuntimeError):
    """A run that is no rehearsal fed a frame more than STOP_LATE_S after it
    was due. `run` is the Run, stopped there."""

    def __init__(self, message, run):
        super().__init__(message)
        self.run = run


# ---------------------------------------------------------------- generator
class Stream:
    """The frames of the cell, in order: global frame j is the lap's frame
    j mod n_lap at timestamp j / fps."""

    def __init__(self, frames, fps, periodic=True):
        self.frames = frames
        self.fps = float(fps)
        self.periodic = periodic
        self.j = 0

    def take(self, n):
        """(frames, timestamps, global ids) of the next n frames."""
        ids = list(range(self.j, self.j + n))
        self.j += n
        if not self.periodic and ids[-1] >= len(self.frames):
            raise RuntimeError("the rehearsal's partial lap ran out")
        frames = [self.frames[j % len(self.frames)] for j in ids]
        return frames, [j / self.fps for j in ids], ids


# ------------------------------------------------------------------- runner
class Run:
    """One run of a cell on `device`: set-up, window, optional traced slice,
    the judgement. `scale`, `lap_frames` and `overrides` (TrackerConfig
    fields) are for CPU rehearsals, and `control` for the correctness
    controls (``readings.py``); the benchmark's own runs leave them. Only
    a run that is no rehearsal stops when it falls behind the camera."""

    CONTROLS = (None, "pinhole", "tf32", "metric_scale")

    def __init__(self, cell, seed, device="cuda", scale=1.0, lap_frames=None,
                 overrides=None, control=None):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.scale = scale
        self.lap_frames = lap_frames
        self.overrides = overrides or {}
        self.rehearsal = scale != 1.0 or lap_frames is not None
        if control not in self.CONTROLS:
            raise ValueError(f"unknown control {control!r}")
        self.control = control
        self.sensor = sensor_of(cell.config)
        if control == "metric_scale" and self.sensor not in METRIC_SENSORS:
            raise ValueError("the metric_scale control mis-states a stereo "
                             "baseline, a depth map or an accelerometer")
        self.cuda = str(device).startswith("cuda")
        self.mix = cell.traffic
        self.records = []        # (global id, state, T_cw) of the window
        self.notes = {}

    # ............................................................ set-up
    def setup(self):
        self.prepare()
        self.initialize()

    def prepare(self):
        """Render the lap and what the sensor needs besides, and build the
        System for the configuration's sensor."""
        import torch

        from ygz_tpu_torch.io.config import load_settings
        from ygz_tpu_torch.system import Sensor, System

        cfgf = self.cell.config
        nums = settings_numbers(cfgf["settings_path"])
        fps = nums["Camera.fps"]
        camd = camera_dict(nums, self.scale)
        if self.sensor == "STEREO" and any(camd["dist"]):
            raise ValueError("a stereo configuration is a rectified pair: "
                             f"its settings give the distortion "
                             f"{camd['dist']}")
        lapd = self.mix["lap"]
        self.lap = scene.Lap(lapd["seconds"], lapd["terms"],
                             scene.lap_phase(self.seed, lapd["seconds"]))
        # a mix with a texture_seed films one fixed scene, as a recorded
        # sequence is one; the run's seed then sets only where the lap starts
        tex_seed = lapd.get("texture_seed", self.seed)
        t0 = time.perf_counter()
        frames = scene.render_lap(self.lap, camd, fps, tex_seed, self.device,
                                  lapd["texture_px"], self.lap_frames)
        # the second input of each frame, indexed as the frames are
        self.side = None
        if self.sensor == "STEREO":
            self.side = scene.render_lap_right(
                self.lap, camd, fps, tex_seed, self.device,
                lapd["texture_px"], self.lap_frames)
        elif self.sensor == "RGBD":
            self.side = scene.render_lap_depth(self.lap, camd, fps,
                                               self.device, self.lap_frames)
            if self.control == "metric_scale":
                self.side *= CONTROL_SCALE
        elif self.sensor == "MONO_VI":
            self.imu_hz = float(cfgf.get("imu_hz", 200.0))
            if abs(round(self.lap.lap_s * self.imu_hz)
                   - self.lap.lap_s * self.imu_hz) > 1e-9:
                raise ValueError("the lap must hold a whole number of IMU "
                                 "samples")
            tbc = settings_matrix(cfgf["settings_path"], "Camera.Tbc")
            tbc = np.eye(4) if tbc is None else tbc.reshape(4, 4)
            gyro, acc = scene.lap_imu(self.lap, self.imu_hz, tbc)
            if self.control == "metric_scale":
                # the accelerometer's scale mis-stated: every specific
                # force, gravity's included, 1.25 times too large
                acc = acc * CONTROL_SCALE
            self.imu = (gyro, acc)
        self.stream = Stream(frames, fps, periodic=self.lap_frames is None)
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.notes["render_s"] = time.perf_counter() - t0

        s = load_settings(cfgf["settings_path"])
        cam = s.camera
        if self.control == "pinhole":
            # the configuration's distortion dropped: frames tracked as if
            # the lens were a pinhole
            cam = cam._replace(dist=torch.zeros_like(cam.dist))
        if self.control == "metric_scale" and self.sensor == "STEREO":
            # the rig's baseline mis-stated: every depth 1.25 times too far
            cam = cam._replace(bf=cam.bf * CONTROL_SCALE)
        # TF32 matmuls and convolutions only in the TF32 control (the port
        # pins both off)
        torch.backends.cuda.matmul.allow_tf32 = self.control == "tf32"
        torch.backends.cudnn.allow_tf32 = self.control == "tf32"
        if self.scale != 1.0:
            from ygz_tpu_torch.geometry.camera import Camera

            c = camera_dict(nums, self.scale)
            cam = Camera.make(c["fx"], c["fy"], c["cx"], c["cy"],
                              c["width"], c["height"], cam.dist,
                              bf=cam.bf * self.scale)
        cfg = s.tracker
        cfg.async_mapping = bool(self.mix["async_mapping"])
        cfg.track_batch = 1
        for k, v in self.overrides.items():
            setattr(cfg, k, v)
        self.tracker_cfg = cfg
        vi = {}
        if self.sensor == "MONO_VI":
            from ygz_tpu_torch.frontend.vi_tracker import MonoViTracker

            # the port's NavState window is a constant; a settings file
            # asking for another would be run as it is not
            if s.vio.local_window_size != MonoViTracker.W_CAP:
                raise ValueError(
                    f"LocalMapping.LocalWindowSize "
                    f"{s.vio.local_window_size}: the port's window is "
                    f"{MonoViTracker.W_CAP}")
            if not np.allclose(s.vio.Tbc, tbc, atol=1e-6):
                raise ValueError("Camera.Tbc read otherwise by the port")
            vi = {"Tbc": s.vio.Tbc, "vins_init_time": s.vio.vins_init_time}
        t0 = time.perf_counter()
        self.system = System(cam, Sensor[self.sensor], config=cfg,
                             device=self.device, **vi)
        self.notes["system_s"] = time.perf_counter() - t0

    def initialize(self):
        """Initialize frame by frame (a mono-inertial System until VINS
        initialization has run), then the warm frames and the drain."""
        t0 = time.perf_counter()
        wl = self.cell.workload
        n = 0
        while True:
            n += 1
            if self._feed(1)[0][1] == "OK":
                break
            if n >= wl["max_init_frames"]:
                raise RuntimeError(f"not initialized after {n} frames")
        self.notes["init_frames"] = n
        if self.sensor == "MONO_VI":
            n = 0
            while self.system.tracker.vins_scale is None:
                if n >= wl["max_vi_init_frames"]:
                    raise RuntimeError(f"VINS not initialized after {n} "
                                       f"frames")
                self._feed(1)
                n += 1
            self.notes["vi_init_frames"] = n
        self.notes["init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._feed(wl["warm_frames"])
        self.system.shutdown()          # the window starts with no tail
        self._sync()
        self.notes["warm_s"] = time.perf_counter() - t0

    def _sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    # ............................................................ feeding
    def _feed(self, n):
        """n frames, one call of the sensor's entry each: [(id, state,
        T_cw)]."""
        frames, ts, ids = self.stream.take(n)
        entry = getattr(self.system, ENTRIES[self.sensor])
        out = []
        for k in range(n):
            r = entry(frames[k], *self._inputs(ids[k]), ts[k])
            out.append((ids[k], r[0], r[1]))
        return out

    def _inputs(self, j):
        """What the entry takes between frame j and its time: the right
        view, the depth map, the IMU slice, or nothing."""
        if self.sensor == "MONO_VI":
            return (self.frame_imu(j),)
        if self.side is not None:
            return (self.side[j % len(self.side)],)
        return ()

    def frame_imu(self, j):
        """Frame j's IMU samples [(t, gyro, acc)]: those of the lap's with
        a time in ((j - 1) / fps, j / fps], across the lap's wrap."""
        gyro, acc = self.imu
        n = len(gyro)
        lo, hi = scene.frame_imu_span(j, self.stream.fps, self.imu_hz)
        return [(g / self.imu_hz, gyro[(g - 1) % n], acc[(g - 1) % n])
                for g in range(lo, hi)]

    # ............................................................ window
    def window(self, seconds):
        """The measured window: frames due at the mix's fixed rate from the
        window's start, each fed when due, or at once when late (never
        dropped); latency from the due time to the pose returned. Returns
        the end-to-end readings."""
        rate = float(self.mix["rate_hz"])
        n_due = int(np.ceil(seconds * rate))
        lat, late = [], []
        t0 = time.perf_counter()
        for k in range(n_due):
            due = t0 + k / rate
            late.append(self._wait(due, k))
            self.records += self._feed(1)
            lat.append(time.perf_counter() - due)
        self.window_s = time.perf_counter() - t0
        end = t0 + seconds
        self.notes["feeder_late_ms_p50"] = 1e3 * statistics.median(late)
        self.notes["feeder_late_ms_max"] = 1e3 * max(late)
        self.notes["backlog_at_close"] = int(sum(
            t0 + k / rate + late[k] > end for k in range(n_due)))
        lat_ms = 1e3 * np.asarray(lat)
        self.latencies_ms = lat_ms.tolist()
        return {"frame_latency_p50_ms": float(np.percentile(lat_ms, 50))}

    def traced_slice(self):
        """The cell's traced frames, fed at the mix's rate, under
        torch.profiler."""
        from .trace import traced

        n = int(self.cell.workload["trace_frames"])
        rate = float(self.mix["rate_hz"])

        def run():
            t0 = time.perf_counter()
            for k in range(n):
                self._wait(t0 + k / rate, k)
                self.records += self._feed(1)
            return n

        return traced(run)

    def _wait(self, due, k):
        """Sleep until `due`, when the k-th frame of a paced stretch is due;
        the seconds it is fed late. A run that is no rehearsal stops
        (FellBehind) once that passes STOP_LATE_S."""
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
            now = time.perf_counter()
        late = now - due
        if late > STOP_LATE_S and not self.rehearsal:
            stages = ", ".join(f"{name} {ms:.3f} ms x {n}" for name, (ms, n)
                               in self.stage_means().items())
            raise FellBehind(
                f"behind the camera: frame {self.stream.j} fed "
                f"{late:.3f} s after it was due (the stop is at "
                f"{STOP_LATE_S} s), after {k} frames of this paced stretch "
                f"and {self.stream.j} since set-up began; stages since "
                f"set-up began (mean, count): {stages}", self)
        return late

    def stage_totals(self):
        t = self.system.tracker.timer
        return dict(t.total), dict(t.count)

    def stage_means(self):
        """{stage: (ms per call, calls)} of the tracker's StageTimer since
        the System was built, set-up included, by name."""
        total, count = self.stage_totals()
        return {name: (1e3 * total[name] / max(count[name], 1), count[name])
                for name in sorted(total)}

    # ............................................................ judge
    def numbers(self):
        """The correctness numbers of the window's returned states and
        poses and of the map: a monocular run's after a 7-DoF fit, a metric
        sensor's with the scale fixed at 1."""
        fps = self.stream.fps
        ids = np.array([r[0] for r in self.records])
        ok = np.array([r[1] == "OK" for r in self.records])
        T = np.stack([np.asarray(r[2], np.float64) for r in self.records])
        true_c = self.lap.centre(ids / fps)
        out = {"lost_pct": reference.lost_pct(ok)}
        with_scale = self.sensor == "MONOCULAR"
        pose = reference.pose_numbers(ids, ok, T[:, :3, :3], T[:, :3, 3],
                                      true_c, with_scale=with_scale)
        if pose is not None:
            out.update(pose)
        smap = self.system.map
        kv = np.nonzero(smap.kf_valid[: smap.n_kf])[0]
        kf_c = reference.centres(smap.kf_R[kv], smap.kf_t[kv])
        kf_true = self.lap.centre(smap.kf_ts[kv])
        pts = smap.pt_xyz[: smap.n_pt][smap.pt_valid[: smap.n_pt]]
        out["map_err_med_pct"] = reference.map_err_med_pct(
            kf_c, kf_true, pts, with_scale=with_scale)
        return out

    def close(self):
        """Drain the mapping worker (its errors raise here)."""
        if getattr(self, "system", None) is not None:
            self.system.shutdown()

    def stop_worker(self):
        """End the mapping worker's thread (a process that runs several
        cells in turn)."""
        tr = self.system.tracker
        if tr._map_worker is not None:
            tr._map_queue.put(None)
            tr._map_worker.join(timeout=60)


def run_cell(cell, seed, seconds, trace=False, device="cuda", t_start=None,
             **rehearsal):
    """One whole run of a cell: (result record without the device block,
    compared rows, the Run). Set-up counts from `t_start` (the process's
    start in the CLI; else this call)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell, seed, device=device, **rehearsal)
    run.notes["before_setup_s"] = time.perf_counter() - t_start
    run.setup()
    setup_s = run.notes["setup_s"] = time.perf_counter() - t_start
    before = run.stage_totals()
    e2e = run.window(seconds)
    after = run.stage_totals()
    frames_window = len(run.records)
    tr = run.traced_slice() if trace else None
    run.close()
    peak = torch.cuda.max_memory_allocated() if run.cuda else 0
    numbers = run.numbers()
    correct, rows = reference.judge(numbers, cell.workload["limits"])
    failed = sum(r[1] != "OK" for r in run.records)

    # the tracker's StageTimer spans over the window: (seconds, count)
    run.window_stages = {k: (after[0].get(k, 0.0) - before[0].get(k, 0.0),
                             after[1].get(k, 0) - before[1].get(k, 0))
                         for k in after[0]}
    metrics = {}
    if trace:
        ctx = SimpleNamespace(frames=frames_window, window_s=run.window_s,
                              stages=run.window_stages, trace=tr,
                              latencies_ms=run.latencies_ms,
                              tracker_cfg=run.tracker_cfg,
                              camera=run.system.cam, sensor=run.sensor)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    if tr is not None:
        # the GN kernels' records in the slice by the host call that
        # launched them (a graph replay: cudaGraphLaunch)
        run.notes["gn_kernels_by_launch"] = {
            k: dict(Counter(str(by) for name, _, _, by in tr.kernels
                            if k in name))
            for k in ("pose_gn_kernel", "sparse_align_kernel")}
    run.notes.update(numbers=numbers, phase_s=run.lap.phase,
                     failed_runs=failed_runs(run.records),
                     window_frames=frames_window,
                     keyframes=int(run.system.map.kf_valid.sum()),
                     loops_closed=int(run.system.tracker.n_loops_closed))
    result = {"correct": bool(correct), "attempted": len(run.records),
              "failed": int(failed), "metrics": metrics,
              "memory_peak_bytes": int(peak)}
    if tr is not None:
        result["trace"] = tr
    return result, rows, run


def failed_runs(records):
    """[[first id, last id, state], ...] of the stretches of frames that
    came back in a state other than OK."""
    out = []
    for j, state, _ in records:
        if state == "OK":
            continue
        if out and out[-1][1] == j - 1 and out[-1][2] == state:
            out[-1][1] = j
        else:
            out.append([j, j, state])
    return out
