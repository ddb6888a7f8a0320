"""The trace reader on a synthetic profiler table: the class split, busy and
idle time, the idle gaps by host span, and the launch-count guard."""
from __future__ import annotations

import pytest

from vfbench import run, trace
from vfbench.generator import CALL_SPAN, INGEST_SPAN
from vfbench.metrics import (copy_ms, device_idle_pct, frame_roofline, ingest_ms,
                             torch_ops_ms, vf_kernels_ms)
from vfbench.tests.conftest import REPO

PORT = frozenset({"vtx_cover_kernel", "vtx_resolve_kernel"})


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def two_calls():
    """Two 1000 us calls, 500 us apart; in each a 100 us HtoD copy, a torch
    kernel, two port kernels and a 50 us readback; an ingest span in the
    first."""
    events = []
    for k, t in enumerate((0.0, 1500.0)):
        events += [
            ev(f"{CALL_SPAN}.Renderer.render_rgba", "user_annotation", t, 1000.0),
            ev("aten::copy_", "cpu_op", t + 10, 120.0),
            ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", t + 20, 100.0),
            ev("void at::native::vectorized_elementwise_kernel<4, float>(int)", "kernel",
               t + 200, 300.0),
            ev("(anonymous namespace)::vtx_cover_kernel(float const*, int)", "kernel",
               t + 500, 40.0),
            ev("void vtx_resolve_kernel<true>(float const*, vf::ResolveOut)", "kernel",
               t + 540, 10.0),
            ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", t + 560, 20.0),
            ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t + 900, 50.0),
            ev("cudaLaunchKernel", "cuda_runtime", t + 480, 15.0),
        ]
        if k == 0:
            events.append(ev(INGEST_SPAN, "user_annotation", t + 600, 250.0))
    events.append(ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5000.0, 10.0))
    return events


def test_class_split_busy_and_idle():
    s = trace.summarize(two_calls(), PORT, CALL_SPAN)
    assert s.calls == 2 and s.window_s == pytest.approx(2500e-6)
    assert s.class_s["copy"] == pytest.approx(2 * 150e-6)
    assert s.class_s["port"] == pytest.approx(2 * 50e-6)
    assert s.class_s["torch"] == pytest.approx(2 * 320e-6)
    assert s.port_launches == 4 and s.device_events == 12
    assert s.busy_s == pytest.approx(2 * 520e-6)
    assert s.span_s[INGEST_SPAN] == pytest.approx(250e-6)
    assert s.device_ops[0] == ["void at::native::vectorized_elementwise_kernel<4, float>(int)",
                               pytest.approx(600e-6)]
    gaps = dict(s.idle_gaps)
    # Each gap goes to the host span open at its middle: 950..1520 (between
    # the calls) to none, 580..900 to the ingest span, 0..20 to the copy.
    assert gaps["no host span"] == pytest.approx(570e-6)
    assert gaps[INGEST_SPAN] == pytest.approx(320e-6)
    assert gaps["aten::copy_"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)


def test_metric_readers_on_the_summary():
    s = trace.summarize(two_calls(), PORT, CALL_SPAN)
    reading = {"summary": s, "least_ms": 0.0104}
    assert copy_ms.read(reading) == pytest.approx(0.150)
    assert torch_ops_ms.read(reading) == pytest.approx(0.320)
    assert vf_kernels_ms.read(reading) == pytest.approx(0.050)
    assert ingest_ms.read(reading) == pytest.approx(0.125)
    assert device_idle_pct.read(reading) == pytest.approx(100 * (1 - 1040 / 2500))
    assert frame_roofline.read(reading) == pytest.approx(1.0)


def test_readers_find_nothing_in_an_empty_trace():
    reading = {"summary": trace.summarize([], PORT, CALL_SPAN), "least_ms": 0.0}
    for reader in (copy_ms, torch_ops_ms, vf_kernels_ms, ingest_ms, device_idle_pct,
                   frame_roofline):
        assert reader.read(reading) is None


class StubSession:
    def __init__(self, events, launches):
        self.events, self.launches = events, launches

    def start(self):
        pass

    def stop(self):
        return self.events, self.launches


class StubDriver:
    def frame_inputs(self, inp):
        return {"frames": 1, "vertices": 4, "triangles": 2, "texels": 1,
                "shader": "shipped", "width": 8, "height": 6}


@pytest.mark.parametrize("counted, complete", [(4, True), (5, False), (3, False)])
def test_launch_count_guard(monkeypatch, counted, complete):
    """A trace that holds fewer or more port launches than the counters
    moved by is refused; another session is tried, up to three."""
    monkeypatch.setattr(trace, "Session", lambda: StubSession(two_calls(), counted))
    t = run.Tracing(2, StubDriver(), PORT)
    for _ in range(2 * run.TRACE_ATTEMPTS + 4):
        t.before_call()
        t.after_call({}, None)
    assert (t.summary is not None) is complete
    assert t.attempts == (1 if complete else run.TRACE_ATTEMPTS)
    assert len(t.why) == (0 if complete else run.TRACE_ATTEMPTS)


def test_lost_call_spans_refuse_the_trace(monkeypatch):
    events = [e for e in two_calls() if not (e["cat"] == "user_annotation"
                                            and e["ts"] > 1000)]
    monkeypatch.setattr(trace, "Session", lambda: StubSession(events, 2))
    t = run.Tracing(2, StubDriver(), PORT)
    t.before_call()
    t.after_call({}, None)
    t.after_call({}, None)
    assert t.summary is None and "1 of 2 call spans" in t.why[0]


def test_kernel_ident():
    assert trace.kernel_ident("void vtx_resolve_kernel<true>(float const*, int)") == \
        "vtx_resolve_kernel"
    assert trace.kernel_ident("packed_cover_kernel(float const*)") == "packed_cover_kernel"
    assert trace.kernel_ident("void (anonymous namespace)::vtx_resolve_kernel<false>"
                              "(float const*, int, int, int, int const*, "
                              "(anonymous namespace)::ResolveOut)") == "vtx_resolve_kernel"
    assert trace.kernel_ident("(anonymous namespace)::packed_cover_kernel(float const*)") \
        == "packed_cover_kernel"
    assert trace.kernel_ident("void at::native::vectorized_elementwise_kernel<4, float>"
                              "(int, float)") == "vectorized_elementwise_kernel"


def test_port_kernel_names_from_the_sources():
    names = trace.port_kernel_names(REPO / "vulkan_forge_torch" / "csrc")
    assert {"vtx_cover_kernel", "vtx_cover_big_kernel", "vtx_resolve_kernel",
            "packed_cover_kernel", "packed_cover_big_kernel", "packed_resolve_kernel",
            "raster_kernel", "seg_kernel"} <= names


def test_busy_time_is_averaged_over_the_devices():
    """A two-chip run: device 0 busy 300 us and device 1 busy 100 us of a
    1000 us window read 200 us busy; the idle gaps are the times neither
    device works."""
    events = [ev(f"{CALL_SPAN}.render_spike_frames", "user_annotation", 0.0, 1000.0),
              {**ev("k0", "kernel", 100.0, 300.0), "args": {"device": 0}},
              {**ev("k1", "kernel", 300.0, 100.0), "args": {"device": 1}}]
    s = trace.summarize(events, PORT, CALL_SPAN, devices=2)
    assert s.busy_s == pytest.approx(200e-6)
    assert sum(sec for _, sec in s.idle_gaps) == pytest.approx(700e-6)
    assert s.class_s["torch"] == pytest.approx(400e-6)
