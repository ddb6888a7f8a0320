"""The 8K UHD poster's route and its record (``vfbench`` cell
``srtm1.poster_7680x4320``): a ``Renderer`` frame tall enough for the
segment walk.

On the CPU, on a cut that still walks segments (16x4096 from a 129^2 DEM:
32,768 triangles, 4,096 rows): the cell runs through ``vfbench.run`` and
its frames pass the plain reference; under a profiler session the call
opens ``vf.seg.bin`` inside ``vf.raster``, tallies the walk's counters
and its blocking reads there, and draws the same frame as with no
session, when nothing is made or counted. The ``gpu`` test holds the
counted syncs to torch's sync detector and ``seg_pairs`` to
``segments.overlap_walk`` on the card
(``python3 -m pytest -m gpu tests/test_torch_poster.py``). This file
imports no jax.
"""
from __future__ import annotations

import collections
import json
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vulkan_forge_torch as vt
from vulkan_forge_torch import _trace
from vulkan_forge_torch._raster import pipeline, segments
from vfbench import inputs, run
from vfbench.tests.conftest import make_root

torch.set_num_threads(1)

CELL = "srtm1.poster_7680x4320"
W, H, DEM = 16, 4096, 129
SEED = 3000000019
CALL = "vf.Renderer.render_rgba"
# Blocking reads of a tall call by the spans open, at the sites that
# ``_trace.sync`` and ``_trace.d2h`` mark: in vf.seg.bin the index range
# check (2), both axes' segment_bin (nonzero 1, bincount 2,
# repeat_interleave 2) and estimates (1 each), compact_valid's nonzero
# (1); in vf.raster the segment kernel's checks of ids and tile_order;
# the readback.
MARKED_SYNCS = {(CALL, "vf.raster", "vf.seg.bin"): 15, (CALL, "vf.raster"): 2,
                (CALL, "vf.readback"): 1}


def _tall_renderer(device, w=W, h=H, n=DEM):
    r = vt.Renderer(w, h, device=device)
    r.add_terrain(inputs.dem_tile(n, SEED, 0, device), (30.0, 30.0), 1.5, "terrain")
    r.upload_height_r32f()
    r.set_sun(35.0, 120.0)
    r.set_exposure(1.2)
    return r


def _refuse(*a, **k):
    raise AssertionError("made while no session records")


@pytest.fixture(scope="module")
def tall():
    """The tall Renderer and its frame drawn with no session, while no
    trace range and no CUDA event may be made; the record it left."""
    r = _tall_renderer("cpu")
    _trace.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _refuse)
        mp.setattr(torch.cuda, "Event", _refuse)
        off = r.render_rgba()
    left = _trace.RECORD
    _trace.reset()
    return r, off, left


def test_the_cut_walks_segments():
    assert pipeline.use_segment_route(2 * (DEM - 1) ** 2, H, "inclusive")
    assert not pipeline.use_segment_route(2 * (DEM - 1) ** 2, H - 8, "inclusive")


def test_poster_cell_runs_through_the_harness(tmp_path, capsys, monkeypatch):
    # Other test modules of this process may have loaded JAX's packages;
    # the run checks its own imports.
    for name in [n for n in sys.modules if n.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    root = make_root(tmp_path, width=W, height=H, dem=DEM)
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.1",
                   "--trace", "0"], root=root, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1, err
    assert line["checks"]["max_byte_gap"]["value"] == 0


def test_no_session_makes_nothing_and_counts_nothing(tall):
    _, _, left = tall
    assert left.calls == 0 and left.spans == {} and left.counters == {}
    assert left.on_device == [] and not left.seen_on
    assert _trace.device_count("seg_pairs", (1, 4), "cpu") is None


def test_session_records_the_walk(tall, monkeypatch):
    r, off, _ = tall
    _trace.reset()
    marked = collections.Counter()     # blocking reads by open spans, any device
    real_sync, real_d2h = _trace.sync, _trace.d2h

    def sync(t, n=1):
        marked[tuple(_trace.RECORD.stack)] += n
        return real_sync(t, n)

    def d2h(t):
        marked[tuple(_trace.RECORD.stack)] += 1
        return real_d2h(t)

    monkeypatch.setattr(_trace, "sync", sync)
    monkeypatch.setattr(_trace, "d2h", d2h)
    with profile(activities=[ProfilerActivity.CPU]):
        on = r.render_rgba()
    np.testing.assert_array_equal(on, off)
    assert marked == MARKED_SYNCS            # vf.seg.bin open inside vf.raster
    rec = _trace.RECORD
    walk = rec.counters["vf.seg.bin"]
    assert walk["seg_records"] > 0 and walk["seg_table_bytes"] > 0
    assert walk["seg_pixels"] == W * H
    assert len(rec.on_device) == 1
    rec.settle()
    assert walk["seg_pairs"] > 0 and rec.on_device == []
    assert rec.spans["vf.seg.bin"][0] == 1 and rec.calls == 1


# ---------------- on the card ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment kernel and torch's sync detector")
    return torch.device("cuda")


# Every blocking wait of a tall Renderer call on the card, by innermost
# span: relight's (test_torch_trace.RELIGHT_SYNCS) with the range check
# in vf.seg.bin, and the marked ones above.
TALL_SYNCS = {"vf.inputs": 9, "vf.seg.bin": 15, "vf.raster": 2, "vf.shade": 2,
              "vf.Renderer.render_rgba": 1, "vf.readback": 1}


@pytest.mark.gpu
def test_tall_call_on_the_card(cuda, monkeypatch):
    """One tall call: the syncs, span by span, are those counted, and
    torch's detector sees as many implicit ones; seg_pairs is the pairs
    ``overlap_walk`` finds in the frame's walk tables; the frame is the
    one drawn with no session."""
    w, h, n = 256, 4352, 257
    r = _tall_renderer(cuda, w, h, n)
    off = r.render_rgba()
    torch.cuda.synchronize()
    kept = []
    real = segments.stack_frames

    def stack_frames(frames):
        kept.append(real(frames))
        return kept[-1]

    monkeypatch.setattr(segments, "stack_frames", stack_frames)
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
    syncs = {name: c["syncs"] for name, c in snap["counters"].items() if "syncs" in c}
    assert syncs == TALL_SYNCS
    detected = [x for x in seen if "synchroniz" in str(x.message)]
    assert len(detected) == sum(TALL_SYNCS.values()) - 1      # not the explicit synchronize
    records, _, bbox, binning = kept[0]
    assert snap["counters"]["vf.seg.bin"]["seg_records"] == records.shape[0]
    pairs = int(segments.overlap_walk(bbox, binning, 1, w, h)[1][-1])
    assert snap["counters"]["vf.seg.bin"]["seg_pairs"] == pairs > 0
