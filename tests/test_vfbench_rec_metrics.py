"""The record route's per-layer metrics (``vfbench`` cell
``srtm1.relight_hw``): ``stage_rec_setup_ms`` and ``rec_kernel_roofline``
give their value on a faked record and trace, and None without their
span, counter or port kernel, or without the record (the parent's
program); ``rec_roofline.rec_bound`` counts what
``chip_smoke.record_bound`` counts for a g-buffer launch under the hw
rule. This file imports no jax."""
from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

import chip_smoke
from vulkan_forge_torch import _mesh
from vulkan_forge_torch._camera import look_at_rh, perspective_wgpu
from vulkan_forge_torch._raster import kernels, pipeline, setup, tiles
from vfbench import rec_roofline, roofline, spec, trace
from vfbench.tests.conftest import REPO

torch.set_num_threads(1)

NEW = ["stage_rec_setup_ms", "rec_kernel_roofline"]
CELL = "srtm1.relight_hw"
PIXELS = 800 * 600
# Two traced calls on one card.
RECORD = {
    "calls": 2, "cuda_calls": 2, "device_calls": 2,
    "spans": {"vf.Renderer.render_rgba": {"count": 2, "host_s": 0.3, "stream_ms": 0.0},
              "vf.vertex": {"count": 2, "host_s": 0.25, "stream_ms": 260.0},
              "vf.rec.setup": {"count": 2, "host_s": 0.24, "stream_ms": 246.0}},
    "counters": {"vf.rec.setup": {"syncs": 6, "rec_binned": 2 * 600_000, "rec_pairs": 2 * 700_000,
                                  "rec_offsets": 2 * 1_901, "rec_pixels": 2 * PIXELS},
                 "vf.raster": {"rec_items": 2 * 900_000, "rec_covered": 2 * 250_000}},
    "setup_s": {}, "setup_before_s": 0.0,
}
SUMMARY = trace.Summary(calls=2, window_s=0.3, busy_s=0.28,
                        class_s={"copy": 0.0001, "port": 0.0002, "torch": 0.25},
                        device_ops=[["CatArrayBatchedCopy_alignedK_contig", 0.16]])


def _fake(monkeypatch, record):
    from vulkan_forge_torch import _trace
    monkeypatch.setattr(_trace, "snapshot", lambda: record)


def _without(record, counter):
    return {**record, "counters": {name: {k: v for k, v in c.items() if k != counter}
                                   for name, c in record["counters"].items()}}


def test_new_metrics_are_declared_for_the_hw_relight_alone():
    bench = spec.benchmark(REPO)
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert declared[name]["workloads"] == [CELL]
        assert declared[name]["moves"] == "throughput_mpix_s"
        assert callable(spec.reader(name))
    for other in ("srtm1.relight", "srtm1.poster_7680x4320"):
        assert [m["name"] for m in spec.metrics_of(bench, "per_layer", other)
                if m["name"] in NEW] == []


def test_stage_rec_setup_ms_reads_the_span(monkeypatch):
    _fake(monkeypatch, RECORD)
    assert spec.reader("stage_rec_setup_ms")({"summary": SUMMARY}) == pytest.approx(123.0)


def test_rec_kernel_roofline_reads_counters_and_port_time(monkeypatch):
    _fake(monkeypatch, RECORD)
    # per call: 6e5 binned, 7e5 pairs, 1,901 offsets, 9e5 items, 2.5e5 covered
    nbytes = 6e5 * 25 * 4 + 2.5e5 * 9 * 4 + 7e5 * 8 + 1_901 * 4 + PIXELS * 13
    ops = 9e5 * 38 + 2.5e5 * 52 + PIXELS * 5
    bound_ms = max(nbytes / 3.35e12, ops / 67e12) * 1e3
    want = 100.0 * bound_ms / 0.1                             # 0.0002 s over 2 calls
    assert spec.reader("rec_kernel_roofline")({"summary": SUMMARY}) == pytest.approx(want)
    assert rec_roofline.rec_bound(6e5, 7e5, 1_901, 9e5, 2.5e5, PIXELS)["bound_by"] == "bytes"


@pytest.mark.parametrize("name, record", [
    ("stage_rec_setup_ms", {**RECORD, "spans": {k: v for k, v in RECORD["spans"].items()
                                                if k != "vf.rec.setup"}}),
    *[("rec_kernel_roofline", _without(RECORD, counter))
      for counter in ("rec_binned", "rec_pairs", "rec_offsets", "rec_items", "rec_covered",
                      "rec_pixels")],
    ("stage_rec_setup_ms", {**RECORD, "cuda_calls": 0, "device_calls": 0, "spans": {},
                            "counters": {}}),
    ("rec_kernel_roofline", {**RECORD, "cuda_calls": 0, "device_calls": 0, "spans": {},
                             "counters": {}}),
])
def test_reader_gives_none_without_its_span_or_counter(monkeypatch, name, record):
    _fake(monkeypatch, record)
    assert spec.reader(name)({"summary": SUMMARY}) is None


def test_rec_kernel_roofline_gives_none_without_a_port_kernel(monkeypatch):
    _fake(monkeypatch, RECORD)
    summary = trace.Summary(calls=2, window_s=0.3, busy_s=0.28,
                            class_s={"copy": 0.0001, "port": 0.0, "torch": 0.25})
    assert spec.reader("rec_kernel_roofline")({"summary": summary}) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_none_without_the_record(monkeypatch, name):
    """A program without ``_trace`` (before the record)."""
    import vulkan_forge_torch
    monkeypatch.delattr(vulkan_forge_torch, "_trace", raising=False)
    monkeypatch.setitem(sys.modules, "vulkan_forge_torch._trace", None)
    assert spec.reader(name)({"summary": SUMMARY}) is None


def test_constants_are_chip_smokes():
    assert (roofline.EVAL_OPS, roofline.RESOLVE_OPS) == (chip_smoke.EVAL_OPS,
                                                        chip_smoke.RESOLVE_OPS)
    assert (rec_roofline.COVER_COLS, rec_roofline.VARYING_COLS, rec_roofline.COVER_OPS) == (
        chip_smoke.COVER_COLS, chip_smoke.VARYING_COLS, chip_smoke.COVER_OPS)
    assert rec_roofline.COVER_COLS + rec_roofline.HW_COLS + rec_roofline.VARYING_COLS \
        == setup.HW_COLS


@pytest.mark.parametrize("grid, w, h", [(24, 160, 120), (48, 96, 64)])
def test_rec_bound_counts_what_chip_smoke_counts(grid, w, h):
    """A seeded grid through the record route under the hw rule: the
    binned records, pairs, offsets, the kernel's evaluated items, the
    covered pixels and the pixels in ``rec_bound`` give
    ``chip_smoke.record_bound``'s bytes, operations and bound."""
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    heights = np.random.default_rng(7).uniform(0.0, 0.3, (grid, grid)).astype(np.float32)
    view = look_at_rh((0.3, 2.4, 0.9), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))[None]
    proj = perspective_wgpu(np.float32(np.radians(45.0)), np.float32(w / h),
                            np.float32(0.1), np.float32(100.0))[None]
    f = [torch.as_tensor(a) for a in (xyuv, heights, view, proj)]
    one = torch.tensor(1.0)
    records, binning = pipeline.terrain_records(f[0], torch.as_tensor(idx).reshape(-1, 3),
                                                f[1], f[2], f[3], one, one, w, h, "extended",
                                                "hw")
    ntx, nty = setup.tile_grid(w, h)
    evaluated = torch.zeros((1, ntx * nty), dtype=torch.int32)
    covered = int(kernels.raster_gbuffer_hw(records, binning, 1, w, h, evaluated)[3].sum())
    items = int(evaluated.sum())
    assert items == int(tiles.tile_work(binning).sum()) > 0 and covered > 0
    want = chip_smoke.record_bound(records, binning, 1, w, h, shade=False, covered=covered,
                                   hw=True)
    got = rec_roofline.rec_bound(torch.unique(binning.rows).numel(), binning.rows.numel(),
                                 binning.offsets.numel(), items, covered, w * h)
    assert (got["bytes"], got["ops"]) == (want["bytes"], want["ops"])
    assert got["bound_ms"] == pytest.approx(want["bound_ms"])
