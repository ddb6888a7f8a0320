"""The harness on the CPU: cells, configurations, mixes and metrics found
by name from files; a cell added by files and entries alone; the result
line's keys; the exits without a card, without the program and with JAX
loaded; and what the benchmark's modules import."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from vfbench import generator, run, spec, trace
from vfbench.tests.conftest import REPO, VIEWS, runnable, with_queued

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in SPEC["workloads"]]
RUNNABLE = runnable(SPEC)
ARGS = ["--seed", "3000000019", "--seconds", "0.4"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cell(root, cell, capsys, trace_flag=0, device="cpu", extra=()):
    rc = run.main(["--workload", cell, *ARGS, "--trace", str(trace_flag), *extra],
                  root=root, device=device)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.mark.parametrize("cell", RUNNABLE)
def test_cell_parts_found_by_name(cell):
    """Each cell's parts, the queued cells' too, found by name from files."""
    full = with_queued(SPEC)
    entry = spec.cell(full, cell)
    config = spec.config(REPO, full, entry["config"])
    mix = spec.traffic(REPO, entry["traffic"])
    assert config["name"] == entry["config"] and mix["name"] == entry["traffic"]
    driver = generator.driver_class(mix["entry"])
    assert issubclass(driver, generator.Driver) and config["scene"] in mix["scenes"]
    for part in ("setup", "inputs", "call", "reference", "frame_inputs"):
        assert callable(getattr(driver, part))
    assert set(spec.limits(REPO, cell)) == {"max_byte_gap", "px_off_ppm"}
    for m in spec.metrics_of(full, "per_layer", cell):
        assert callable(spec.reader(m["name"]))
    assert {m["name"] for m in spec.metrics_of(full, "end_to_end", cell)} == {
        "throughput_mpix_s", "call_p50_ms", "call_p95_ms", "setup_s"}


def test_every_config_file_is_its_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_unknown_cell_exits_2(capsys):
    rc, line, err = run_cell(REPO, "no.such_cell", capsys)
    assert rc == 2 and line is None and "no workload" in err


@pytest.mark.parametrize("cell", RUNNABLE)
def test_cell_runs_and_its_line_has_the_keys(tiny_root, cell, capsys):
    rc, line, err = run_cell(tiny_root, cell, capsys)
    assert rc == 0, err
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"throughput_mpix_s", "call_p50_ms", "call_p95_ms",
                                    "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == {"failed_calls", "max_byte_gap", "px_off_ppm"}
    tail = err.strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_a_new_cell_is_files_and_entries_alone(tiny_root, capsys):
    """A mix with more eyes a call, a configuration with another grid and
    frame: three data files and two entries, no code."""
    mix = json.loads((tiny_root / "vfbench/traffic/views_b4.json").read_text())
    mix.update(name="views_b2", eyes_per_call=2)
    (tiny_root / "vfbench/traffic/views_b2.json").write_text(json.dumps(mix))
    cfg = json.loads((tiny_root / "vfbench/configs/spike_g1024_800x600.json").read_text())
    cfg.update(name="spike_g12_40x30", grid=12, width=40, height=30)
    (tiny_root / "vfbench/configs/spike_g12_40x30.json").write_text(json.dumps(cfg))
    (tiny_root / "vfbench/limits/spike_g12.views_b2.json").write_text(
        json.dumps({"max_byte_gap": 1, "px_off_ppm": 0}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "spike_g12_40x30", "source": cfg["source"],
                             "file": "vfbench/configs/spike_g12_40x30.json",
                             "reduced": [], "why": "a smaller grid"})
    bench["workloads"].append({"name": "spike_g12.views_b2", "config": "spike_g12_40x30",
                               "traffic": "views_b2", "chips": 1, "why": "two eyes"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, err = run_cell(tiny_root, "spike_g12.views_b2", capsys)
    assert rc == 0 and line["correct"] is True, err
    # Two 40x30 frames a call.
    m = line["metrics"]
    calls_s = 1e3 / m["call_p50_ms"]["value"]
    assert m["throughput_mpix_s"]["value"] == pytest.approx(2 * 40 * 30 * calls_s / 1e6,
                                                            rel=0.8)


def test_a_new_entry_is_a_driver_file_alone(tiny_root, capsys, monkeypatch):
    """A public entry the benchmark did not drive: a module under
    ``drivers/`` found by the name its mix gives, with a mix, limits and
    a cell as data; no file of the harness edited."""
    drivers = tiny_root / "vfbench_extra" / "vfbench" / "drivers"
    drivers.mkdir(parents=True)
    (drivers / "spike_pair.py").write_text(
        "from vfbench.drivers import spike_frames\n"
        "class Entry(spike_frames.Entry):\n"
        "    entry = 'render_spike_frames.pair'\n"
        "    def inputs(self, k, stream=0):\n"
        "        inp = super().inputs(k, stream)\n"
        "        return {**inp, 'eyes': inp['eyes'][:1] * 2}\n")
    import vfbench.drivers
    monkeypatch.setattr(vfbench.drivers, "__path__",
                        [*vfbench.drivers.__path__, str(drivers)])
    mix = json.loads((tiny_root / "vfbench/traffic/views_b4.json").read_text())
    mix.update(name="pair", entry="spike_pair")
    (tiny_root / "vfbench/traffic/pair.json").write_text(json.dumps(mix))
    (tiny_root / "vfbench/limits/spike_g1024.pair.json").write_text(
        json.dumps({"max_byte_gap": 0, "px_off_ppm": 0}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "spike_g1024.pair", "config": "spike_g1024_800x600",
                               "traffic": "pair", "chips": 1, "why": "one eye twice"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, err = run_cell(tiny_root, "spike_g1024.pair", capsys)
    assert rc == 0 and line["correct"] is True, err


def test_a_cell_runs_on_one_device_per_chip(tiny_root, capsys, monkeypatch):
    """The devices come from the cell's ``chips``: a four-chip cell gets
    cuda:0 to cuda:3, and the entry that takes a device list gets them all."""
    import torch
    seen = {}
    entry = generator.driver_class("spike_frames")

    def setup(self):
        seen["devices"] = list(self.devices)
        raise SystemExit(0)

    monkeypatch.setattr(entry, "setup", setup)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["name"] == VIEWS:
            w["chips"] = 4
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SystemExit):
        run.main(["--workload", VIEWS, *ARGS], root=tiny_root)
    assert seen["devices"] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]


class FakeSession:
    """A profiler session whose trace holds one span and one torch kernel
    per call, and no port launch (the CPU runs the plain versions)."""
    calls = 0

    def start(self):
        FakeSession.calls = 0

    def stop(self):
        events = []
        for k in range(FakeSession.calls):
            t = 1000.0 * k
            events += [{"name": f"{generator.CALL_SPAN}.x", "cat": "user_annotation",
                        "ts": t, "dur": 900.0},
                       {"name": "elementwise_kernel", "cat": "kernel", "ts": t + 100,
                        "dur": 300.0}]
        return events, 0


def test_traced_line_has_breakdown_and_per_layer_metrics(tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(trace, "Session", FakeSession)
    entry = generator.driver_class("spike_frames")
    real_call = entry.call

    def counted(self, inp):
        FakeSession.calls += 1
        return real_call(self, inp)

    monkeypatch.setattr(entry, "call", counted)
    rc, line, err = run_cell(tiny_root, "spike_g1024.views_b4", capsys, trace_flag=1)
    assert rc == 0, err
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert set(line["metrics"]) == {"copy_ms", "torch_ops_ms", "device_idle_pct",
                                    "frame_roofline"}
    assert line["metrics"]["torch_ops_ms"]["value"] == pytest.approx(0.3)
    n = FakeSession.calls
    assert line["metrics"]["device_idle_pct"]["value"] == pytest.approx(
        100 * (1 - 0.3 * n / (1.0 * (n - 1) + 0.9)))
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert line["breakdown"]["device_ops"][0][0] == "elementwise_kernel"


def test_traced_run_without_a_complete_trace_reports_no_layer(tiny_root, capsys):
    """On the CPU the profiler records no device op: the guard refuses the
    trace, and the line carries no per-layer metric and no breakdown."""
    rc, line, err = run_cell(tiny_root, "srtm1.relight", capsys, trace_flag=1)
    assert rc == 0 and line["metrics"] == {} and "breakdown" not in line
    assert "no complete trace" in err


def test_no_card_exits_2_without_a_result(capsys):
    rc = run.main(["--workload", CELLS[0], *ARGS], root=REPO)
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "CUDA device" in err


def test_without_the_program_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil
    shutil.copytree(REPO / "vfbench", tmp_path / "vfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "vfbench.run", "--workload", CELLS[0], *ARGS],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("loaded, found", [
    ("vulkan_forge_torch._raster", []), ("vulkan_forge_torchx", []),
    ("vulkan_forge", ["vulkan_forge"]), ("vulkan_forge._raster.pipeline", ["vulkan_forge"]),
    ("jax.numpy", ["jax"]), ("jaxlib", ["jaxlib"]), ("flax.linen", ["flax"]),
    ("jaxtyping", []),
])
def test_forbidden_modules_compare_top_level_names_whole(monkeypatch, loaded, found):
    for name in [n for n in sys.modules if n.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    assert run.forbidden_modules() == found


def test_a_run_that_loaded_jax_prints_no_result(tiny_root, capsys, monkeypatch):
    for name in [n for n in sys.modules if n.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "vulkan_forge", types.ModuleType("vulkan_forge"))
    rc = run.main(["--workload", CELLS[0], *ARGS], root=tiny_root, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 3 and out == "" and "vulkan_forge" in err


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


BENCH_FILES = sorted(p for p in (REPO / "vfbench").rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", BENCH_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_benchmark_imports_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & run.FORBIDDEN
    if "reference" in path.parts:
        assert "vulkan_forge_torch" not in tops and "vfbench" not in tops
