"""The port's stage spans and counters (``vulkan_forge_torch._trace``).

On the CPU: with no profiler session the spans make no ``record_function``
and no CUDA event and the counters stay still; under a session each public
entry's span holds its stages in order; frames are the same either way;
the record counts traced calls and gives no stage figure for CPU-only
work; set-up spans record without a session; the flag is torch's own.
The ``gpu`` tests read the relight path's stream times, syncs and bytes
on the card (``python3 -m pytest -m gpu tests/test_torch_trace.py``).
This file imports no jax.
"""
from __future__ import annotations

import types
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vulkan_forge_torch as vt
from vulkan_forge_torch import _trace

torch.set_num_threads(1)

STAGES = ("vf.inputs", "vf.vertex", "vf.raster", "vf.shade", "vf.readback")
EYES = [(3.0, 2.0, 3.0), (-3.0, 2.0, 3.0)]


@pytest.fixture(autouse=True)
def fresh_record():
    _trace.reset()
    yield
    _trace.reset()


def _dem(n=33, seed=5):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n] / np.float32(n)
    return (40 * np.sin(6 * x + rng.uniform()) * np.cos(4 * y)).astype(np.float32)


def _renderer(device, w=64, h=48, n=33):
    r = vt.Renderer(w, h, device=device)
    r.add_terrain(_dem(n), (30.0, 30.0), 1.5, "terrain")
    r.upload_height_r32f()
    r.set_sun(35.0, 120.0)
    r.set_exposure(1.2)
    return r


def _spike(device):
    t = vt.TerrainSpike(64, 48, 16, device=device)
    t.set_camera_look_at(EYES[0], (0, 0, 0), (0, 1, 0), 45.0, 0.1, 100.0)
    return t


# entry span -> (object made outside the session, its call, its stages in order)
ENTRIES = {
    "vf.Renderer.render_rgba": (
        lambda: _renderer("cpu"), lambda r: r.render_rgba(),
        ["vf.inputs", "vf.vertex", "vf.raster", "vf.shade", "vf.readback"]),
    "vf.TerrainSpike.render_rgba": (
        lambda: _spike("cpu"), lambda t: t.render_rgba(),
        ["vf.inputs", "vf.vertex", "vf.raster", "vf.readback"]),
    "vf.render_spike_frames": (
        lambda: None, lambda _: vt.render_spike_frames(64, 48, 16, EYES, devices=["cpu"]),
        ["vf.inputs", "vf.vertex", "vf.raster", "vf.readback"]),
}


def _within(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_off_makes_no_range_no_event_and_counts_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("made while no session records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    r, t = _renderer("cpu"), _spike("cpu")
    r.render_rgba()
    r.render_triangle_rgba()
    t.render_rgba()
    vt.render_spike_frames(64, 48, 16, EYES, devices=["cpu"])
    assert _trace.span("vf.vertex", "cpu") is _trace.span("vf.raster") is _trace.call("x")
    _trace.count("syncs", 3)
    _trace.d2h(types.SimpleNamespace(is_cuda=True, nbytes=8))
    rec = _trace.RECORD
    assert rec.calls == 0 and rec.spans == {} and rec.counters == {} and not rec.seen_on


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_span_holds_its_stages_in_order(entry):
    make, run, stages = ENTRIES[entry]
    obj = make()
    off = run(obj)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run(obj)
    np.testing.assert_array_equal(on, off)
    events = [e for e in prof.events() if e.name.startswith("vf.")]
    calls = [e for e in events if e.name == entry]
    assert len(calls) == 1
    inner = sorted((e for e in events if e.name in STAGES and _within(e, calls[0])),
                   key=lambda e: e.time_range.start)
    assert len(inner) == sum(e.name in STAGES for e in events)  # none outside the call
    order = [n for i, n in enumerate(e.name for e in inner)
             if i == 0 or inner[i - 1].name != n]
    assert order == stages
    for a, b in zip(inner, inner[1:]):                        # stages do not overlap
        assert a.time_range.end <= b.time_range.start
    assert _trace.RECORD.calls == 1 and _trace.RECORD.spans[entry][0] == 1


def test_snapshot_counts_traced_calls_and_no_stage_figure_on_the_cpu():
    r = _renderer("cpu")
    r.render_rgba()                                           # untraced
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_rgba()
        r.render_rgba()
    snap = _trace.snapshot()
    assert (snap["calls"], snap["cuda_calls"], snap["device_calls"]) == (2, 0, 0)
    assert snap["spans"] == {} and snap["counters"] == {}
    spans = _trace.RECORD.spans
    assert spans["vf.Renderer.render_rgba"][0] == 2
    assert spans["vf.vertex"][0] == spans["vf.shade"][0] == 2
    assert spans["vf.inputs"][0] == 6                         # entry, route, uploads
    assert all(stream_ms == 0.0 for _, _, stream_ms in spans.values())


def test_counters_tally_against_the_innermost_span_while_on():
    card = types.SimpleNamespace(is_cuda=True, nbytes=12)
    with profile(activities=[ProfilerActivity.CPU]):
        with _trace.call("vf.x"):
            _trace.count("syncs")
            with _trace.span("vf.inputs"):
                _trace.h2d(np.zeros(3, np.float32), card)
                _trace.h2d(np.zeros(3), torch.zeros(3))       # host to host
            with _trace.span("vf.readback"):
                _trace.d2h(card)
                _trace.d2h(torch.zeros(3))                    # a host tensor
        _trace.count("syncs")                                 # outside any span
    assert _trace.RECORD.counters == {
        "vf.x": {"syncs": 1}, "vf.inputs": {"syncs": 1, "h2d_bytes": 12},
        "vf.readback": {"syncs": 1, "d2h_bytes": 12}}
    assert _trace.RECORD.calls == 1


def test_setup_spans_record_without_a_session():
    r = _renderer("cpu")
    r.render_rgba()
    _spike("cpu")
    snap = _trace.snapshot()
    assert set(snap["setup_s"]) == {"vf.Renderer.add_terrain",
                                     "vf.Renderer.upload_height_r32f", "vf.mesh"}
    assert all(s > 0 for s in snap["setup_s"].values())
    assert snap["setup_before_s"] == pytest.approx(sum(snap["setup_s"].values()))
    assert _trace.RECORD.spans == {} and snap["calls"] == 0
    before = snap["setup_before_s"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.add_terrain(_dem(17), (30.0, 30.0), 1.5, "terrain")
    r.upload_height_r32f()                                    # after the first traced span
    snap = _trace.snapshot()
    assert snap["setup_before_s"] == before
    assert "vf.Renderer.add_terrain" in {e.name for e in prof.events()}


def test_the_flag_is_torchs_own():
    assert _trace.on is torch._C._autograd._profiler_enabled
    assert not _trace.on() and not torch.autograd.profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert _trace.on() and torch.autograd.profiler._is_profiler_enabled
        assert isinstance(_trace.span("vf.inputs"), _trace._Span)
    assert not _trace.on()


# ---------------- on the card ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: stream events and device copies")
    return torch.device("cuda")


RELIGHT_SYNCS = {"vf.inputs": 9, "vf.raster": 2, "vf.shade": 2,
                 "vf.Renderer.render_rgba": 1, "vf.readback": 1}


@pytest.mark.gpu
def test_relight_call_on_the_card(cuda):
    """One relight call of a Renderer: every stage has stream time, and the
    syncs, site by site, are those PERF.md lists; torch's own sync
    detector sees the implicit ones."""
    w, h = 800, 600
    r = _renderer(cuda, w, h, n=257)
    off = r.render_rgba()
    torch.cuda.synchronize()
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                on = r.render_rgba()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(on, off)
    snap = _trace.snapshot()
    assert (snap["calls"], snap["cuda_calls"], snap["device_calls"]) == (1, 1, 1)
    for stage in STAGES:
        assert snap["spans"][stage]["stream_ms"] > 0, stage
    syncs = {name: c["syncs"] for name, c in snap["counters"].items() if "syncs" in c}
    assert syncs == RELIGHT_SYNCS
    # torch's detector flags implicit syncs, not the explicit synchronize.
    detected = [x for x in seen if "synchroniz" in str(x.message)]
    assert len(detected) == sum(RELIGHT_SYNCS.values()) - 1
    d2h = sum(c.get("d2h_bytes", 0) for c in snap["counters"].values())
    h2d = sum(c.get("h2d_bytes", 0) for c in snap["counters"].values())
    assert d2h == w * h * 4 + 2 * 4                           # the frame, the index range
    # views, projs; the LUT; six scalars; the sun; the clear colour
    assert h2d == 2 * 64 + 4096 + 6 * 4 + 12 + 12
    stage_ms = sum(snap["spans"][s]["stream_ms"] for s in STAGES)
    assert stage_ms <= snap["spans"]["vf.Renderer.render_rgba"]["host_s"] * 1e3


@pytest.mark.gpu
def test_setup_load_span_on_the_card(cuda):
    from vulkan_forge_torch._raster import kernels
    kernels._lib = None
    kernels.load()
    assert _trace.snapshot()["setup_s"]["vf.setup.load"] > 0
