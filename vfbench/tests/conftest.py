"""Fixtures of the benchmark's CPU tests: a checkout-like root whose cells
run at a tiny size on the CPU, and the card, for the tests marked gpu."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = {"width": 64, "height": 48, "grid": 16, "dem": 33}
# What PERF.md queues (the host-bound cells, whose runs spread too widely
# between processes for a bound; with them the spike configuration and
# the ingest metric, which only they use): their configurations, mixes,
# limits and readers are kept as files, and the tests add each entry to
# BENCHMARK.json, as the change that brings it back will.
QUEUED = {
    "configs": [
        {"name": "spike_g1024_800x600", "source": "bench.py:40-67,95-115",
         "file": "vfbench/configs/spike_g1024_800x600.json", "reduced": [],
         "why": "the headline scene"}],
    "workloads": [
        {"name": "spike_g1024.views_b4", "config": "spike_g1024_800x600",
         "traffic": "views_b4", "chips": 1, "why": "render_spike_frames, 4 orbit eyes a call"},
        {"name": "spike_g1024.turntable", "config": "spike_g1024_800x600",
         "traffic": "turntable", "chips": 1, "why": "one TerrainSpike, 1 degree a call"},
        {"name": "srtm1.tiles", "config": "srtm1_800x600", "traffic": "tiles", "chips": 1,
         "why": "8 seeded tiles, add_terrain + upload + render a call"}],
    "per_layer": [
        {"name": "ingest_ms", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "public entry", "moves": "throughput_mpix_s",
         "workloads": ["srtm1.tiles"]}],
}
VIEWS = "spike_g1024.views_b4"


def with_queued(spec: dict) -> dict:
    """``spec`` with every queued entry it lacks added."""
    spec = {**spec}
    for key, entries in QUEUED.items():
        names = {e["name"] for e in spec[key]}
        spec[key] = spec[key] + [e for e in entries if e["name"] not in names]
    return spec


def runnable(spec: dict) -> list:
    """The names of the cells of ``spec`` and of the queued cells."""
    return [c["name"] for c in with_queued(spec)["workloads"]]


def make_root(path: Path, **sizes) -> Path:
    """A root holding BENCHMARK.json, with the queued cells added, and the
    benchmark's data files, its configurations cut to ``TINY`` (or
    ``sizes``), so that a cell runs in well under a second a call on the
    CPU."""
    sizes = {**TINY, **sizes}
    for sub in ("traffic", "limits"):
        shutil.copytree(REPO / "vfbench" / sub, path / "vfbench" / sub)
    spec = with_queued(json.loads((REPO / "BENCHMARK.json").read_text()))
    (path / "vfbench" / "configs").mkdir(parents=True)
    for entry in spec["configs"]:
        cfg = json.loads((REPO / entry["file"]).read_text())
        cfg.update({k: v for k, v in sizes.items() if k in cfg})
        (path / entry["file"]).write_text(json.dumps(cfg))
    (path / "BENCHMARK.json").write_text(json.dumps(spec))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def cuda_device():
    """The card, for the tests marked gpu; they skip without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
