"""``python -m vulkan_forge_torch.bench`` on ``--device cpu`` at a small scene,
against the repo's ``bench.py`` (its cameras and metric name) and the JAX
package (its frames, through ``render_terrain_u8(..., backend="jnp")``),
and its perf gate on a scratch baseline file.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vulkan_forge import _colormap as jcmap, _mesh as jmesh
from vulkan_forge._raster import pipeline as jpipe

from vulkan_forge_torch import bench
from vulkan_forge_torch._formats import u32_image_to_rgba_u8
from vulkan_forge_torch._parity import assert_fs_policy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"VF_BENCH_GRID": "16", "VF_BENCH_W": "64", "VF_BENCH_H": "48",
         "VF_BENCH_BATCH": "2", "VF_BENCH_REPS": "2"}
# bench.py's keys, and the port's two.
KEYS = {"metric", "value", "unit", "vs_baseline", "path", "ms_per_batch", "device", "card"}
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture
def root_bench():
    """The repo's bench.py, loaded from its file (a fresh module each time)."""
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench(*args, **env):
    return subprocess.run([sys.executable, "-m", "vulkan_forge_torch.bench", *args], cwd=REPO,
                          timeout=180, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env))


@pytest.mark.parametrize("n", [1, 4, 32])
@pytest.mark.parametrize("phase", [0.0, 0.93, 7.7])
def test_orbit_cameras_bit_equal_to_bench_py(root_bench, n, phase):
    want = root_bench.orbit_cameras(n, phase=phase)
    got = bench.orbit_cameras(n, phase, root_bench.WIDTH, root_bench.HEIGHT)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape == (n, 4, 4)
        np.testing.assert_array_equal(g.view(np.uint32), np.asarray(w, np.float32).view(np.uint32))


@pytest.mark.parametrize("env,path", [({}, "vtx"), ({"VF_BENCH_DEM": "32"}, "vtx"),
                                      ({"VF_DENSE": "packed"}, "record")])
def test_one_line_with_bench_py_metric(env, path):
    r = _bench("--device", "cpu", **SMALL, **env)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout
    line = json.loads(lines[0])
    assert KEYS <= set(line)
    # bench.py:344-345's formula for this environment.
    cfg = {**SMALL, **env}
    dem = int(cfg.get("VF_BENCH_DEM", "0"))
    assert line["metric"] == (f"terrain_throughput_grid{cfg['VF_BENCH_GRID']}_"
                              f"{cfg['VF_BENCH_W']}x{cfg['VF_BENCH_H']}_"
                              f"b{cfg['VF_BENCH_BATCH']}" + (f"_dem{dem}" if dem else ""))
    assert line["path"] == path
    assert line["unit"] == "Mpix/s" and line["device"] == "cpu" and line["card"] is None
    ms = line["ms_per_batch"]
    assert ms["reps"] == 2 and 0 < ms["best"] <= ms["median"]
    assert line["value"] > 0
    assert line["value"] == pytest.approx(64 * 48 * 2 / (ms["median"] * 1e3))
    assert line["vs_baseline"] == pytest.approx(line["value"] / 21.0)


def test_unknown_route_exits_nonzero():
    r = _bench("--device", "cpu", VF_DENSE="bogus", **SMALL)
    assert r.returncode != 0 and "VF_DENSE" in r.stderr
    assert r.stdout == ""


def test_without_card_one_error_line_exit_1():
    """No fallback to the CPU: the default device is the card."""
    r = _bench(CUDA_VISIBLE_DEVICES="", **SMALL)
    assert r.returncode == 1, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout
    line = json.loads(lines[0])
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0 and line["error"]
    assert line["metric"] == "terrain_throughput_grid16_64x48_b2"


@pytest.mark.parametrize("dem", [0, 32])
def test_frames_match_the_jax_package(root_bench, dem):
    """Camera set 0 as the bench renders it, frame by frame against the JAX
    package's jnp pipeline on bench.py's scene and cameras; the checksum is
    the red bytes' sum over those frames."""
    cfg = bench.config({**SMALL, "VF_BENCH_DEM": str(dem)})
    sc = bench.scene(cfg, "cpu")
    views, projs = bench.camera_sets(cfg, "cpu")[0]
    imgs = bench.render(sc, views, projs)
    frames = u32_image_to_rgba_u8(imgs).numpy()
    assert frames.shape == (2, 48, 64, 4)
    assert bench.checksum(imgs) == int(frames[..., 0].astype(np.int64).sum())

    root_bench.WIDTH, root_bench.HEIGHT = 64, 48
    jviews, jprojs = root_bench.orbit_cameras(2, phase=0.0)
    np.testing.assert_array_equal(views.numpy(), jviews)
    np.testing.assert_array_equal(projs.numpy(), jprojs)
    xyuv, idx = jmesh.build_grid_xyuv(16)
    if dem:
        gy, gx = np.meshgrid(np.linspace(0, 6, dem, dtype=np.float32),
                             np.linspace(0, 6, dem, dtype=np.float32), indexing="ij")
        heights = (np.sin(gx) * np.cos(gy) * 0.25).astype(np.float32)
    else:
        heights = np.zeros((1, 1), np.float32)
    lut, _ = jcmap.build_lut("viridis")
    sun = (np.array([0.5, 1.0, 0.3], np.float32) / np.linalg.norm([0.5, 1.0, 0.3]))
    args = dict(spacing=1.0, exaggeration=1.0, h_min=-0.5, h_max=0.5, exposure=1.0,
                sun_dir=sun.astype(np.float32), lut=lut, width=64, height=48)
    for b in range(2):
        want = jpipe.render_terrain_u8(xyuv, idx, heights, jviews[b], jprojs[b],
                                       backend="jnp", fs_mode="shipped", **args)
        assert_fs_policy(frames[b], want, f"bench frame {b}, dem {dem}")


def _line(value, card=CARD):
    return {"metric": "terrain_throughput_grid1024_800x600_b4", "value": value,
            "path": "vtx", "card": card}


def _baseline(tmp_path, card=CARD, value=600.0):
    path = tmp_path / "perf_baseline.json"
    path.write_text(json.dumps({card: {"vtx": {"terrain_throughput_grid1024_800x600_b4":
                                               value}}}))
    return str(path)


@pytest.mark.parametrize("value,rc", [(600.0, 0), (400.0, 0), (399.99, 1), (10.0, 1)])
def test_gate_at_two_thirds_of_the_baseline(tmp_path, monkeypatch, value, rc):
    monkeypatch.setenv("VF_ENFORCE_PERF", "1")
    monkeypatch.delenv("VF_UPDATE_PERF_BASELINE", raising=False)
    assert bench.enforce_perf(_line(value), _baseline(tmp_path)) == rc


def test_gate_ignores_another_cards_baseline(tmp_path, monkeypatch):
    monkeypatch.setenv("VF_ENFORCE_PERF", "1")
    monkeypatch.delenv("VF_UPDATE_PERF_BASELINE", raising=False)
    path = _baseline(tmp_path, card="NVIDIA H100 PCIe, 350.00 W", value=1e9)
    assert bench.enforce_perf(_line(1.0), path) == 0


def test_update_records_under_card_route_metric(tmp_path, monkeypatch):
    monkeypatch.setenv("VF_UPDATE_PERF_BASELINE", "1")
    monkeypatch.delenv("VF_ENFORCE_PERF", raising=False)
    other = "NVIDIA H100 PCIe, 350.00 W"
    path = _baseline(tmp_path, card=other, value=5.0)
    assert bench.enforce_perf(_line(720.5), path) == 0
    saved = json.loads(open(path).read())
    assert saved[CARD]["vtx"]["terrain_throughput_grid1024_800x600_b4"] == 720.5
    assert saved[other]["vtx"]["terrain_throughput_grid1024_800x600_b4"] == 5.0


def test_cpu_run_never_touches_the_baseline(tmp_path, monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("VF_ENFORCE_PERF", "1")
    monkeypatch.setenv("VF_UPDATE_PERF_BASELINE", "1")
    monkeypatch.delenv("VF_BENCH_DEM", raising=False)
    monkeypatch.delenv("VF_DENSE", raising=False)
    path = tmp_path / "perf_baseline.json"
    text = json.dumps({"null": {"vtx": {"terrain_throughput_grid16_64x48_b2": math.inf}}})
    path.write_text(text)
    assert bench.main(["--device", "cpu"], baseline_path=str(path)) == 0
    assert path.read_text() == text
    path.unlink()
    assert bench.main(["--device", "cpu"], baseline_path=str(path)) == 0
    assert not path.exists()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(json.loads(o)["device"] == "cpu" for o in out)
