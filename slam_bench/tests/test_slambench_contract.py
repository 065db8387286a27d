"""BENCHMARK.json against the benchmark's contract, and every name in it
found by the harness: configurations, mixes, cells, limits and readers."""
import ast
import json
import re
import subprocess
import sys

import pytest

from slam_bench import harness
from slam_bench.run import forbidden_modules

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_shape():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "-m", "slam_bench.run"]
    assert SPEC["paths"] == ["slam_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_entries_keep_to_the_contract():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("slam_bench/")
        assert (harness.ROOT / c["file"]).exists()
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    cells = SPEC["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert {w["name"] for w in cells} >= set(m["workloads"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_is_found_by_name(cell):
    """Each cell against its own settings: a known sensor, a positive size
    and rate, and what its sensor needs besides."""
    c = harness.load_cell(cell)
    sensor = harness.sensor_of(c.config)
    nums = harness.settings_numbers(c.config["settings_path"])
    assert nums["Camera.width"] > 0 and nums["Camera.height"] > 0
    assert nums["Camera.fps"] > 0
    if sensor == "STEREO":
        assert nums["Camera.bf"] > 0
    if sensor == "MONO_VI":
        assert c.config.get("imu_hz", 200) > 0
        assert c.workload["max_vi_init_frames"] > 0
    assert c.traffic["rate_hz"] > 0
    assert c.workload["limits"] and c.workload["trace_frames"] > 0
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(harness.metric_reader(m["name"]))


def test_every_file_under_the_folder_serves_the_benchmark():
    """Each configuration, mix, cell and metric file is named by an entry
    of BENCHMARK.json."""
    configs = {c["file"].split("/")[-1] for c in SPEC["configs"]}
    configs |= {json.loads((harness.ROOT / c["file"]).read_text())
                ["settings"] for c in SPEC["configs"]}
    cells = SPEC["workloads"]
    want = {"configs": configs,
            "traffic": {w["traffic"] + ".json" for w in cells},
            "workloads": {w["name"] + ".json" for w in cells}}
    for sub, names in want.items():
        got = {p.name for p in (harness.BENCH / sub).iterdir()}
        assert got == names, sub
    readers = {p.stem for p in (harness.BENCH / "metrics").glob("*.py")}
    named = {m["name"] for m in SPEC["per_layer"]}
    assert all(r in named or any(n.rsplit(".", 1)[0] == r for n in named)
               for r in readers), readers


def test_an_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no_such.cell")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "ygz_tpu"}, path


def test_the_reference_imports_nothing_of_the_port():
    tops = {n.split(".", 1)[0]
            for n in _imports(harness.BENCH / "reference.py")}
    assert tops <= {"__future__", "numpy"}


def test_forbidden_names_compare_whole():
    assert forbidden_modules(["ygz_tpu_torch", "ygz_tpu_torch.system",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["ygz_tpu", "jax.numpy", "flax"]) == [
        "flax", "jax.numpy", "ygz_tpu"]


def test_the_cli_refuses_without_a_card():
    """With no CUDA card the run exits non-zero and prints no record."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "slam_bench.run", "--workload",
         "euroc_mono.live", "--seed", str(2**31 + 5), "--seconds", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
