"""The readers of the metrics the program records itself
(``vulkan_forge_torch._trace``, through ``vfbench.program``): each gives its
per-call value on a faked record and None without a traced call on a
card, or without the record; on the card, a traced relight run reports
them beside the trace's metrics, its first session complete."""
from __future__ import annotations

import json
import sys

import pytest

from vfbench import run, spec
from vfbench.tests.conftest import REPO

PROGRAM = ["stage_inputs_ms", "stage_vertex_ms", "stage_raster_ms", "stage_shade_ms",
           "stage_readback_ms", "host_syncs", "transfer_mb", "setup_program_s"]
TRACE = ["copy_ms", "torch_ops_ms", "vf_kernels_ms", "device_idle_pct", "frame_roofline"]

# Four traced calls, each on two cards.
RECORD = {
    "calls": 4, "cuda_calls": 4, "device_calls": 8,
    "spans": {"vf.Renderer.render_rgba": {"count": 4, "host_s": 0.05, "stream_ms": 0.0},
              "vf.inputs": {"count": 12, "host_s": 0.01, "stream_ms": 8.0},
              "vf.vertex": {"count": 8, "host_s": 0.001, "stream_ms": 48.0},
              "vf.raster": {"count": 8, "host_s": 0.002, "stream_ms": 6.0},
              "vf.shade": {"count": 8, "host_s": 0.001, "stream_ms": 12.0},
              "vf.readback": {"count": 8, "host_s": 0.003, "stream_ms": 4.0}},
    "counters": {"vf.Renderer.render_rgba": {"syncs": 4},
                 "vf.inputs": {"syncs": 36, "h2d_bytes": 17_000},
                 "vf.raster": {"syncs": 8, "d2h_bytes": 32},
                 "vf.readback": {"syncs": 4, "d2h_bytes": 7_680_000}},
    "setup_s": {"vf.setup.load": 1.5, "vf.mesh": 0.25}, "setup_before_s": 2.25,
}
WANT = {"stage_inputs_ms": 1.0, "stage_vertex_ms": 6.0, "stage_raster_ms": 0.75,
        "stage_shade_ms": 1.5, "stage_readback_ms": 0.5, "host_syncs": 13.0,
        "transfer_mb": (17_000 + 32 + 7_680_000) / 4 / 1e6, "setup_program_s": 2.25}


def _fake(monkeypatch, record):
    from vulkan_forge_torch import _trace
    monkeypatch.setattr(_trace, "snapshot", lambda: record)


def test_every_program_metric_is_declared_with_its_reader():
    bench = spec.benchmark(REPO)
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in PROGRAM:
        assert declared[name]["source"] in ("program_span", "program_counter")
        assert "workloads" not in declared[name]
        assert callable(spec.reader(name))


@pytest.mark.parametrize("name", PROGRAM)
def test_reader_gives_its_per_call_value(monkeypatch, name):
    _fake(monkeypatch, RECORD)
    assert spec.reader(name)({}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", ["stage_shade_ms", "stage_raster_ms"])
def test_a_stage_the_calls_lack_reads_zero(monkeypatch, name):
    stage = "vf." + name.split("_")[1]
    _fake(monkeypatch, {**RECORD, "spans": {k: v for k, v in RECORD["spans"].items()
                                            if k != stage}})
    assert spec.reader(name)({}) == 0.0


@pytest.mark.parametrize("name", PROGRAM)
def test_reader_gives_none_without_a_traced_call_on_a_card(monkeypatch, name):
    _fake(monkeypatch, {**RECORD, "cuda_calls": 0, "device_calls": 0,
                        "spans": {}, "counters": {}})
    assert spec.reader(name)({}) is None


@pytest.mark.parametrize("name", PROGRAM)
def test_reader_gives_none_without_the_record(monkeypatch, name):
    """A program without ``_trace`` (the parent of the record)."""
    import vulkan_forge_torch
    monkeypatch.delattr(vulkan_forge_torch, "_trace", raising=False)
    monkeypatch.setitem(sys.modules, "vulkan_forge_torch._trace", None)
    assert spec.reader(name)({}) is None


@pytest.mark.gpu
def test_traced_relight_run_reports_the_program_metrics(tiny_root, capsys, cuda_device,
                                                        monkeypatch):
    from vulkan_forge_torch import _trace
    # Other test modules of this process may have loaded JAX's packages;
    # the run checks its own imports.
    for name in [n for n in sys.modules if n.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    _trace.reset()
    rc = run.main(["--workload", "srtm1.relight", "--seed", "3000000019", "--seconds", "0.4",
                   "--trace", "1"], root=tiny_root, device=cuda_device)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, err
    assert set(line["metrics"]) == set(TRACE + PROGRAM)
    # Only the first session traced calls: it was complete.
    assert _trace.snapshot()["calls"] == spec.traffic(tiny_root, "relight")["trace_calls"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["host_syncs"] == 15
    assert all(m[f"stage_{s}_ms"] > 0 for s in ("inputs", "vertex", "raster", "shade",
                                                  "readback"))
