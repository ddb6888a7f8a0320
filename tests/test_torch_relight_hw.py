"""The SRTM relight under the hardware fill rule (``vfbench`` cell
``srtm1.relight_hw``): ``Renderer`` frames with ``VF_FILL_RULE=hw``, which
take the record route, and the plain reference of that rule
(``vfbench/reference/raster_hw.py``).

On the CPU: the cell runs through ``vfbench.run`` on a tiny cut, its
frames come from the record route, and the run leaves ``VF_FILL_RULE`` as
it found it; the reference's coverage and winner ids equal the int64
oracle's (``_raster/hw_oracle.py``) on seeded DEM frames and on a quad
whose shared diagonal runs through pixel centres, its frames equal the
port's byte for byte and differ from the inclusive reference's; under a
profiler session the call opens ``vf.rec.setup`` inside ``vf.vertex``
and tallies the record route's counters and blocking reads there, and
draws the same frame as with no session, when nothing is made or
counted. The ``gpu`` test holds a DEM-3601 800x600 frame to torch's sync
detector, to ``tiles.tile_work`` and to the reference on the card
(``python3 -m pytest -m gpu tests/test_torch_relight_hw.py``). This file
imports no jax.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vulkan_forge_torch as vt
from vulkan_forge_torch import _trace
from vulkan_forge_torch._raster import hw_oracle, kernels, pipeline, tiles
from vfbench import check, inputs, run
from vfbench.drivers import renderer_hw
from vfbench.reference import host, raster, raster_hw, scenes
from vfbench.tests.conftest import TINY, make_root

torch.set_num_threads(1)

CELL = "srtm1.relight_hw"
SEED = 3000000019
CALL = "vf.Renderer.render_rgba"
SPACING, EXAGGERATION, COLORMAP = (30.0, 30.0), 1.5, "terrain"
SUN, EXPOSURE = (35.0, 120.0), 1.2
# Blocking reads of an hw call by the spans open, at the sites that
# ``_trace.sync`` and ``_trace.d2h`` mark: in vf.rec.setup bin_tiles' pair
# count and bincount's min and max; the readback.
MARKED_SYNCS = {(CALL, "vf.vertex", "vf.rec.setup"): 3, (CALL, "vf.readback"): 1}
REC_COUNTERS = ("rec_binned", "rec_pairs", "rec_offsets", "rec_items", "rec_covered",
                "rec_pixels")


def _renderer(device, w=TINY["width"], h=TINY["height"], n=TINY["dem"]):
    r = vt.Renderer(w, h, device=device)
    r.add_terrain(inputs.dem_tile(n, SEED, 0, device), SPACING, EXAGGERATION, COLORMAP)
    r.upload_height_r32f()
    r.set_sun(*SUN)
    r.set_exposure(EXPOSURE)
    return r


def _hw_frame(r):
    with renderer_hw.fill_rule("hw"):
        return r.render_rgba()


def _refuse(*a, **k):
    raise AssertionError("made while no session records")


class _Kept:
    """A spy on ``pipeline.terrain_records``: what each call returned."""

    def __init__(self, monkeypatch):
        self.calls, real = [], pipeline.terrain_records

        def spy(*a, **k):
            self.calls.append(real(*a, **k))
            return self.calls[-1]

        monkeypatch.setattr(pipeline, "terrain_records", spy)


@pytest.fixture(scope="module")
def tiny():
    """The tiny Renderer and its hw frame drawn with no session, while no
    trace range and no CUDA event may be made; the record it left."""
    r = _renderer("cpu")
    _trace.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _refuse)
        mp.setattr(torch.cuda, "Event", _refuse)
        off = _hw_frame(r)
    left = _trace.RECORD
    _trace.reset()
    return r, off, left


# ---------------- the cell ----------------

@pytest.mark.parametrize("before", [None, "inclusive"])
def test_cell_runs_through_the_harness_on_the_record_route(tmp_path, capsys, monkeypatch,
                                                            before):
    # Other test modules of this process may have loaded JAX's packages;
    # the run checks its own imports.
    for name in [n for n in sys.modules if n.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    if before is None:
        monkeypatch.delenv("VF_FILL_RULE", raising=False)
    else:
        monkeypatch.setenv("VF_FILL_RULE", before)
    frames = []
    real = kernels.raster_gbuffer_hw

    def spy(records, binning, n_frames, *a, **k):
        frames.append(n_frames)
        return real(records, binning, n_frames, *a, **k)

    monkeypatch.setattr(kernels, "raster_gbuffer_hw", spy)
    root = make_root(tmp_path)
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.1",
                   "--trace", "0"], root=root, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1, err
    assert line["checks"]["max_byte_gap"]["value"] == 0
    # Every call (the warm-up's three and the window's) drew its frame with
    # the record route's hw kernel.
    assert frames == [1] * (3 + line["attempted"])
    assert os.environ.get("VF_FILL_RULE") == before


def test_driver_puts_the_variable_back_when_a_call_raises(monkeypatch):
    monkeypatch.setenv("VF_FILL_RULE", "inclusive")
    with pytest.raises(RuntimeError):
        with renderer_hw.fill_rule("hw"):
            assert os.environ["VF_FILL_RULE"] == "hw"
            raise RuntimeError("the call failed")
    assert os.environ["VF_FILL_RULE"] == "inclusive"


# ---------------- the hw reference ----------------

def _oracle_clip(fields, width, height):
    """Clip coordinates (N, 4) whose float64 projection in ``hw_oracle``
    gives the reference's f32 x_fb and y_fb exactly (width and height
    powers of two), at z 0.5 and w 1, inside the clip volume."""
    x, y = (fields[0, k].double().numpy() for k in (0, 1))
    return np.stack([2.0 * x / width - 1.0, 1.0 - 2.0 * y / height,
                     np.full_like(x, 0.5), np.ones_like(x)], axis=-1)


def _dem_fields(n, seed, width, height):
    heights = inputs.dem_tile(n, seed, 0, "cpu") * np.float32(EXAGGERATION)
    xyuv, tris = host.dem_mesh(n, n, *SPACING)
    view, proj = host.dem_camera(n, n, SPACING, width, height)
    t = [torch.as_tensor(np.asarray(a, np.float32)) for a in (xyuv, heights, view, proj)]
    fields = raster.vertex_fields(t[0], t[1], t[2][None], t[3][None], width, height,
                                  "extended")
    return fields, tris


@pytest.mark.parametrize("n, seed", [(33, 5), (33, SEED), (65, 7)])
def test_reference_coverage_equals_the_fixed_point_oracle(n, seed):
    w = h = 64
    fields, tris = _dem_fields(n, seed, w, h)
    got = raster_hw.winners(raster_hw.snapped(fields), torch.as_tensor(tris), w, h)[0] - 1
    wid, _ = hw_oracle.rasterize_hw(_oracle_clip(fields, w, h), np.zeros((tris.max() + 1, 1)),
                                    tris, w, h)
    assert (wid >= 0).sum() > w * h // 2
    np.testing.assert_array_equal(got.numpy(), wid)
    # The inclusive rule gives shared-edge pixels to the larger id.
    incl = raster.winners(fields, torch.as_tensor(tris), w, h)[0] - 1
    assert (incl != got).any()


def _quad_fields(xs, ys):
    """One frame's fields (1, 7, N) at framebuffer positions ``xs``,
    ``ys``: w 1, z 0.5, the varyings the positions."""
    x, y = (torch.tensor(v, dtype=torch.float32) for v in (xs, ys))
    one = torch.ones_like(x)
    return torch.stack([x, y, one, x, y, one, 0.5 * one])[None]


def _front(tris, xs, ys):
    """Each triangle with its last two corners swapped where needed so that
    it faces the camera (negative double area, y down)."""
    out = []
    for a, b, c in tris:
        area2 = (xs[b] - xs[a]) * (ys[c] - ys[a]) - (xs[c] - xs[a]) * (ys[b] - ys[a])
        out.append([a, b, c] if area2 < 0 else [a, c, b])
    return torch.tensor(out)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_shared_diagonal_is_owned_by_one_triangle(order):
    """A 16 x 16 quad split along a diagonal that runs through 16 pixel
    centres: under the hw rule each centre is covered by exactly one of
    the two triangles, as the oracle says; the inclusive rule covers them
    twice."""
    w = h = 32
    xs, ys = [8.0, 24.0, 24.0, 8.0], [8.0, 8.0, 24.0, 24.0]
    halves = [(0, 2, 1), (0, 3, 2)]
    tris = _front([halves[k] for k in order], xs, ys)
    fields = _quad_fields(xs, ys)
    snapped = raster_hw.snapped(fields)
    hw_masks = [raster_hw.winners(snapped, tris[k:k + 1], w, h)[0] > 0 for k in range(2)]
    incl_masks = [raster.winners(fields, tris[k:k + 1], w, h)[0] > 0 for k in range(2)]
    diagonal = torch.zeros(h, w, dtype=torch.bool)
    diagonal[range(8, 24), range(8, 24)] = True
    assert not (hw_masks[0] & hw_masks[1]).any()
    assert ((incl_masks[0] & incl_masks[1]) == diagonal).all()
    both = raster_hw.winners(snapped, tris, w, h)[0] - 1
    wid, _ = hw_oracle.rasterize_hw(_oracle_clip(fields, w, h), np.zeros((4, 1)),
                                    tris.numpy(), w, h)
    np.testing.assert_array_equal(both.numpy(), wid)
    assert ((both >= 0) == (hw_masks[0] | hw_masks[1])).all()
    assert ((both >= 0) == (incl_masks[0] | incl_masks[1])).all()


@pytest.mark.parametrize("n, w, h", [(TINY["dem"], TINY["width"], TINY["height"]),
                                     (65, 96, 64)])
def test_reference_frames_equal_the_ports_and_not_the_inclusive_ones(n, w, h):
    r = _renderer("cpu", w, h, n)
    dem = inputs.dem_tile(n, SEED, 0, "cpu")
    for sun, exposure in ((SUN, EXPOSURE), ((62.0, 301.0), 0.7)):
        r.set_sun(*sun)
        r.set_exposure(exposure)
        args = (dem, SPACING, EXAGGERATION, COLORMAP, sun, exposure, w, h, "cpu")
        want = raster_hw.renderer_frame_hw(*args)
        np.testing.assert_array_equal(_hw_frame(r)[None], want)
        inclusive = scenes.renderer_frame(*args)
        np.testing.assert_array_equal(r.render_rgba()[None], inclusive)
        assert check.compare([(inclusive, want)])["px_off_ppm"] > 0


# ---------------- the record ----------------

def test_no_session_makes_nothing_and_counts_nothing(tiny):
    _, _, left = tiny
    assert left.calls == 0 and left.spans == {} and left.counters == {}
    assert left.on_device == [] and not left.seen_on
    _trace.device_sum("rec_covered", torch.ones(3))
    assert _trace.RECORD.on_device == []


def test_session_records_the_record_route(tiny, monkeypatch):
    r, off, _ = tiny
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
    kept = _Kept(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _hw_frame(r)
    np.testing.assert_array_equal(on, off)
    assert marked == MARKED_SYNCS            # vf.rec.setup open inside vf.vertex
    rec = _trace.RECORD
    assert rec.spans["vf.rec.setup"][0] == 1 and rec.calls == 1
    _, binning = kept.calls[0]
    w, h = TINY["width"], TINY["height"]
    setup_counters = rec.counters["vf.rec.setup"]
    assert setup_counters["rec_pairs"] == binning.rows.numel() > 0
    assert setup_counters["rec_offsets"] == binning.offsets.numel()
    assert setup_counters["rec_pixels"] == w * h
    assert [(name, kind) for name, kind, _ in rec.on_device] == [
        ("vf.rec.setup", "rec_binned"), ("vf.raster", "rec_items"), ("vf.raster", "rec_covered")]
    rec.settle()
    assert rec.on_device == []
    raster_counters = rec.counters["vf.raster"]
    assert setup_counters["rec_binned"] == torch.unique(binning.rows).numel()
    assert raster_counters["rec_items"] == int(tiles.tile_work(binning).sum()) > 0
    covered = int(np.any(off != np.asarray(raster.clear_bytes(), np.uint8), axis=-1).sum())
    assert raster_counters["rec_covered"] == covered > 0
    assert {k for c in rec.counters.values() for k in c} >= set(REC_COUNTERS)


def test_inclusive_frames_tally_no_record_counters(tiny, monkeypatch):
    """The Renderer's inclusive frames take the indexed route: no
    ``vf.rec.setup``, no rec_* counter."""
    r, _, _ = tiny
    monkeypatch.delenv("VF_FILL_RULE", raising=False)
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_rgba()
    rec = _trace.RECORD
    assert "vf.rec.setup" not in rec.spans and rec.calls == 1
    assert not {k for c in rec.counters.values() for k in c} & set(REC_COUNTERS)
    _trace.reset()


# ---------------- on the card ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the record kernel and torch's sync detector")
    return torch.device("cuda")


def _launches():
    """Each kernel wrapper's launches so far."""
    return {name: f.launches for name, f in vars(kernels).items()
            if callable(f) and isinstance(getattr(f, "launches", None), int)}


# Every blocking wait of an hw Renderer call on the card, by innermost
# span: relight's (test_torch_trace.RELIGHT_SYNCS) without the index range
# check, which the record route does not make, and with bin_tiles' three.
HW_SYNCS = {"vf.inputs": 9, "vf.rec.setup": 3, "vf.Renderer.render_rgba": 1,
            "vf.readback": 1}


@pytest.mark.gpu
def test_hw_call_at_the_cells_size_on_the_card(cuda, monkeypatch):
    """One DEM-3601 800x600 hw call: it launches the record route's hw
    kernel and the shader alone; the syncs, span by span, are those
    counted, and torch's detector sees as many implicit ones; rec_items
    is the (pair, pixel) items ``tiles.tile_work`` finds in the frame's
    binning; the frame is the one drawn with no session, and equal to the
    hw reference's."""
    w, h, n = 800, 600, 3601
    r = _renderer(cuda, w, h, n)
    before = _launches()
    off = _hw_frame(r)
    torch.cuda.synchronize()
    after = _launches()
    # The record route's hw kernel and the extended shader, once each;
    # none of the other routes' kernels.
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "raster_gbuffer_hw": 1, "terrain_fs_extended": 1}
    kept = _Kept(monkeypatch)
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                on = _hw_frame(r)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(on, off)
    snap = _trace.snapshot()
    _trace.reset()
    syncs = {name: c["syncs"] for name, c in snap["counters"].items() if "syncs" in c}
    assert syncs == HW_SYNCS
    detected = [x for x in seen if "synchroniz" in str(x.message)]
    assert len(detected) == sum(HW_SYNCS.values()) - 1      # not the explicit synchronize
    _, binning = kept.calls[0]
    counters = snap["counters"]
    assert counters["vf.raster"]["rec_items"] == int(tiles.tile_work(binning).sum()) > 0
    assert counters["vf.rec.setup"]["rec_binned"] == torch.unique(binning.rows).numel()
    del kept, binning
    want = raster_hw.renderer_frame_hw(inputs.dem_tile(n, SEED, 0, cuda), SPACING,
                                       EXAGGERATION, COLORMAP, SUN, EXPOSURE, w, h, cuda)
    got = check.compare([(off[None], want)])
    assert got == {"max_byte_gap": 0, "px_off_ppm": 0.0}
