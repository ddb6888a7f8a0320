"""The segment walk's per-layer metrics (``vfbench`` cell
``srtm1.poster_7680x4320``): ``stage_seg_bin_ms`` and
``seg_kernel_roofline`` give their value on a faked record and trace, and
None without their span, counter or kernel, or without the record (the
parent's program); ``seg_roofline.seg_bound`` counts what
``chip_smoke.seg_bound`` counts for a g-buffer launch. This file imports
no jax."""
from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

import chip_smoke
from vulkan_forge_torch import _mesh
from vulkan_forge_torch._camera import look_at_rh, perspective_wgpu
from vulkan_forge_torch._raster import kernels, pipeline, segments, vtx
from vfbench import roofline, seg_roofline, spec, trace
from vfbench.tests.conftest import REPO

torch.set_num_threads(1)

NEW = ["stage_seg_bin_ms", "seg_kernel_roofline"]
CELL = "srtm1.poster_7680x4320"
KERNEL_NAME = ("void (anonymous namespace)::seg_kernel<false>(float const*, int, int const*, "
               "int4 const*, int const*, int const*, int2 const*, int const*, int const*")
# Two traced calls on one card.
RECORD = {
    "calls": 2, "cuda_calls": 2, "device_calls": 2,
    "spans": {"vf.Renderer.render_rgba": {"count": 2, "host_s": 0.8, "stream_ms": 0.0},
              "vf.raster": {"count": 2, "host_s": 0.2, "stream_ms": 180.0},
              "vf.seg.bin": {"count": 2, "host_s": 0.1, "stream_ms": 90.0}},
    "counters": {"vf.seg.bin": {"syncs": 30, "seg_records": 2 * 10_000_000,
                                "seg_table_bytes": 2 * 4_000_000,
                                "seg_pixels": 2 * 7680 * 4320, "seg_pairs": 2 * 20_000_000},
                 "vf.raster": {"syncs": 4}},
    "setup_s": {}, "setup_before_s": 0.0,
}
SUMMARY = trace.Summary(calls=2, window_s=1.0, busy_s=0.5,
                        device_ops=[["elementwise_kernel", 0.2], [KERNEL_NAME, 0.06]])


def _fake(monkeypatch, record):
    from vulkan_forge_torch import _trace
    monkeypatch.setattr(_trace, "snapshot", lambda: record)


def _without(record, counter):
    return {**record, "counters": {name: {k: v for k, v in c.items() if k != counter}
                                   for name, c in record["counters"].items()}}


def test_new_metrics_are_declared_for_the_poster_alone():
    bench = spec.benchmark(REPO)
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert declared[name]["workloads"] == [CELL]
        assert declared[name]["moves"] == "throughput_mpix_s"
        assert callable(spec.reader(name))
    assert [m["name"] for m in spec.metrics_of(bench, "per_layer", "srtm1.relight")
            if m["name"] in NEW] == []


def test_stage_seg_bin_ms_reads_the_span(monkeypatch):
    _fake(monkeypatch, RECORD)
    assert spec.reader("stage_seg_bin_ms")({"summary": SUMMARY}) == pytest.approx(45.0)


def test_seg_kernel_roofline_reads_counters_and_kernel(monkeypatch):
    _fake(monkeypatch, RECORD)
    # per call: 1e7 records, 4e6 table bytes, 2e7 pairs, 7680 x 4320 pixels
    px = 7680 * 4320
    nbytes = 1e7 * 36 * 4 + 4e6 + px * 13
    ops = 2e7 * 1024 * 52 + px * 5
    bound_ms = max(nbytes / 3.35e12, ops / 67e12) * 1e3
    want = 100.0 * bound_ms / 30.0                            # 0.06 s over 2 calls
    assert spec.reader("seg_kernel_roofline")({"summary": SUMMARY}) == pytest.approx(want)
    assert seg_roofline.seg_bound(1e7, 4e6, 2e7, px)["bound_by"] == "operations"


@pytest.mark.parametrize("name, record", [
    ("stage_seg_bin_ms", {**RECORD, "spans": {k: v for k, v in RECORD["spans"].items()
                                              if k != "vf.seg.bin"}}),
    ("seg_kernel_roofline", _without(RECORD, "seg_pairs")),
    ("seg_kernel_roofline", _without(RECORD, "seg_records")),
    ("seg_kernel_roofline", _without(RECORD, "seg_table_bytes")),
    ("seg_kernel_roofline", _without(RECORD, "seg_pixels")),
    ("stage_seg_bin_ms", {**RECORD, "cuda_calls": 0, "device_calls": 0, "spans": {},
                          "counters": {}}),
    ("seg_kernel_roofline", {**RECORD, "cuda_calls": 0, "device_calls": 0, "spans": {},
                             "counters": {}}),
])
def test_reader_gives_none_without_its_span_or_counter(monkeypatch, name, record):
    _fake(monkeypatch, record)
    assert spec.reader(name)({"summary": SUMMARY}) is None


def test_seg_kernel_roofline_gives_none_without_the_kernel(monkeypatch):
    _fake(monkeypatch, RECORD)
    summary = trace.Summary(calls=2, window_s=1.0, busy_s=0.5,
                            device_ops=[["elementwise_kernel", 0.2],
                                        [KERNEL_NAME.replace("<false>", "<true>"), 0.06]])
    assert spec.reader("seg_kernel_roofline")({"summary": summary}) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_none_without_the_record(monkeypatch, name):
    """A program without ``_trace`` (before the record)."""
    import vulkan_forge_torch
    monkeypatch.delattr(vulkan_forge_torch, "_trace", raising=False)
    monkeypatch.setitem(sys.modules, "vulkan_forge_torch._trace", None)
    assert spec.reader(name)({"summary": SUMMARY}) is None


def test_constants_are_chip_smokes():
    from vulkan_forge_torch._raster import setup
    assert (roofline.EVAL_OPS, roofline.RESOLVE_OPS) == (chip_smoke.EVAL_OPS,
                                                         chip_smoke.RESOLVE_OPS)
    assert (roofline.PEAK_BYTES, roofline.PEAK_F32) == (chip_smoke.PEAK_BYTES,
                                                        chip_smoke.PEAK_F32)
    assert seg_roofline.RECORD_WORDS == setup.NUM_COLS + 1 + 4
    assert seg_roofline.TILE_PIXELS == segments.TILE_H * segments.TILE_W


def test_seg_bound_counts_what_chip_smoke_counts():
    """A seeded grid through the segment walk's set-up at 256x4352: the
    program's counters (records, tables, the kernel's evaluated pairs,
    pixels) in ``seg_bound`` give ``chip_smoke.seg_bound``'s bytes,
    operations and bound, and the pairs are ``chip_smoke.overlap_pairs``."""
    grid, w, h = 48, 256, 4352
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    heights = np.random.default_rng(7).uniform(0.0, 0.3, (grid, grid)).astype(np.float32)
    view = look_at_rh((0.3, 2.4, 0.9), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))[None]
    proj = perspective_wgpu(np.float32(np.radians(45.0)), np.float32(w / h),
                            np.float32(0.1), np.float32(100.0))[None]
    f = [torch.as_tensor(a) for a in (xyuv, heights, view, proj)]
    fields = vtx.vs_fields(*f, torch.tensor(1.0), torch.tensor(1.0), w, h, "extended")
    records, ids, bbox, binning = segments.stack_frames(
        [pipeline.segment_frame(fields, idx, grid, w, h)])
    ntx, nty = segments.seg_grid(w, h)
    evaluated = torch.zeros((1, ntx * nty), dtype=torch.int32)
    kernels.seg_gbuffer(records, ids, bbox, binning, 1, w, h, evaluated)
    pairs = int(evaluated.sum())
    assert pairs == chip_smoke.overlap_pairs(fields, grid, w, h) > 0
    want = chip_smoke.seg_bound(records, binning, pairs, w, h, shade=False)
    got = seg_roofline.seg_bound(records.shape[0], segments.table_bytes(binning), pairs, w * h)
    assert (got["bytes"], got["ops"]) == (want["bytes"], want["ops"])
    assert got["bound_ms"] == pytest.approx(want["bound_ms"])
