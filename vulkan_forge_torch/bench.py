"""Headline benchmark of the port: shaded-terrain throughput on one CUDA card
(counterpart of the repo's ``bench.py``).

    python -m vulkan_forge_torch.bench [--device cuda|cpu]

The scene is ``bench.py``'s: the grid=1024 analytic spike (2 * 1023^2 =
2,093,058 triangles) shaded at 800x600 with the shipped terrain pipeline
(viridis LUT, h_min -0.5, h_max 0.5, exposure 1, sun (0.5, 1, 0.3)
normalised, spacing 1, exaggeration 1), rendered in batches of frames, one
orbit camera per frame and a distinct camera set per rep (``phase = 0.31 *
rep``; the last set warms up and is never timed). The environment sets the
scene as it does for ``bench.py``: ``VF_BENCH_W``/``_H``/``_GRID``/
``_BATCH``/``_REPS`` (defaults 800, 600, 1024, 4 when grid >= 512 else 32,
5) and ``VF_BENCH_DEM=N``, which swaps the analytic relief for an N x N
height texture ``sin(gx) * cos(gy) * 0.25``.

Before the first timed rep the mesh, heights, LUT, scalars and every camera
set are on the device. The timed window holds the batch render and the
checksum ``sum(img & 0xFF)`` read back to the host, whose ``.item()`` is
the synchronisation; nothing in it copies the mesh. The headline is the
median of the reps' times, in Mpix/s; ``vs_baseline`` divides it by 21.0,
the reference's own GPU budget (a 1024^2 DEM in 50 ms).

``VF_DENSE`` picks the route: unset or ``vtx`` passes ``grid_n``, which takes
the vertex-stream route; ``record``, and ``packed``, ``resident``, ``strips``
and ``list`` (TPU kernels the port does not have), render the same mesh
without ``grid_n``, which takes the record route (``vf_raster_shade_shipped``).
Any other value raises. ``path`` in the line is the route that ran, read from
``pipeline.use_vtx_route``, the predicate ``render_terrain_batch_u32`` routes
by.

Prints ONE JSON line on stdout, ``bench.py``'s keys plus ``device`` and
``card`` (``nvidia-smi --query-gpu=name,power.limit`` on the card, null on
the CPU); diagnostics go to stderr. Its numbers are not rounded (``bench.py``
rounds milliseconds to 0.1, coarse at a 2-3 ms batch).

The perf gate (``bench.py``'s ``_enforce_perf``): ``VF_ENFORCE_PERF=1`` fails
a card run below 2/3 of its recorded baseline and ``VF_UPDATE_PERF_BASELINE=1``
records the run, in ``vulkan_forge_torch/perf_baseline.json``, keyed by the
card (name and power limit), the route and the metric, so that one card's
number is never another's floor. CPU runs neither read nor write it; the
repo's ``perf_baseline.json`` holds TPU numbers and is not read.

Not carried over from ``bench.py``:
  - the forced-CPU re-exec when the device does not answer
    (``_cpu_fallback``): a fallback that hides the device. ``--device cpu`` is
    the only way to the CPU; without a card the run prints one line with
    value 0.0 and ``error`` and exits 1, as ``bench.py`` does with its
    fallback off. The preflight runs under the port's ``VF_PROBE_TIMEOUT``
    watchdog; there is no TPU relay to probe.
  - the vtx slot ratchet and its overflow retry loop, ``VF_BENCH_VTX_SLOTS``
    and ``VF_PACKED_SPLIT_FS``: XLA static-shape and TPU-lowering devices.
    The port's vtx route has no slots to overflow.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _camera, _colormap, _device, _mesh
from ._raster import pipeline

BASELINE_MPIX = 21.0        # the reference's budget: a 1024^2 render in 50 ms
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "perf_baseline.json")
# VF_DENSE values: the port's routes, and bench.py's TPU kernels, which all
# render the mesh without grid_n here (the record route).
VTX_MODES = ("vtx",)
RECORD_MODES = ("record", "packed", "resident", "strips", "list")


class Config(NamedTuple):
    width: int
    height: int
    grid: int
    batch: int
    reps: int
    dem: int
    dense: str


def config(env=os.environ) -> Config:
    """The scene of ``bench.py:40-52,95-106`` from the environment, and the
    route (``VF_DENSE``); an unknown route raises ValueError."""
    grid = int(env.get("VF_BENCH_GRID", "1024"))
    dense = env.get("VF_DENSE") or "vtx"
    if dense not in VTX_MODES + RECORD_MODES:
        raise ValueError(f"VF_DENSE={dense!r}: expected one of "
                         f"{', '.join(VTX_MODES + RECORD_MODES)}")
    return Config(width=int(env.get("VF_BENCH_W", "800")),
                  height=int(env.get("VF_BENCH_H", "600")), grid=grid,
                  batch=int(env.get("VF_BENCH_BATCH", "4" if grid >= 512 else "32")),
                  reps=int(env.get("VF_BENCH_REPS", "5")),
                  dem=int(env.get("VF_BENCH_DEM", "0")), dense=dense)


def metric_name(cfg: Config) -> str:
    """``bench.py``'s metric name, letter for letter."""
    return (f"terrain_throughput_grid{cfg.grid}_{cfg.width}x{cfg.height}_b{cfg.batch}"
            + (f"_dem{cfg.dem}" if cfg.dem else ""))


def orbit_cameras(n: int, phase: float = 0.0, width: int = 800, height: int = 600):
    """n cameras orbiting the spike terrain, one view/proj per frame:
    ``bench.orbit_cameras`` (``bench.py:55-67``) bit for bit, with the
    frame's size as arguments. Returns (views, projs), each (n, 4, 4) f32."""
    views = []
    projs = []
    aspect = np.float32(width) / np.float32(height)
    for i in range(n):
        ang = 2.0 * math.pi * i / max(n, 1) + phase
        eye = (3.0 * math.cos(ang), 2.0 + 0.1 * math.sin(phase), 3.0 * math.sin(ang))
        views.append(_camera.look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)))
        projs.append(_camera.perspective_wgpu(np.float32(math.radians(45.0)), aspect,
                                              np.float32(0.1), np.float32(100.0)))
    return np.stack(views), np.stack(projs)


def scene(cfg: Config, device) -> dict:
    """Everything the batch render reads but the cameras, on ``device``:
    mesh, heights, LUT and the shading scalars (``bench.py:89-115``), and
    ``grid_n`` (None on the record route)."""
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    xyuv, idx = _mesh.build_grid_xyuv(cfg.grid)
    if cfg.dem > 0:
        gy, gx = np.meshgrid(np.linspace(0, 6, cfg.dem, dtype=np.float32),
                             np.linspace(0, 6, cfg.dem, dtype=np.float32), indexing="ij")
        heights = (np.sin(gx) * np.cos(gy) * 0.25).astype(np.float32)
    else:
        heights = np.zeros((1, 1), np.float32)      # analytic relief only
    lut, _ = _colormap.build_lut("viridis")
    sun = np.array([0.5, 1.0, 0.3], np.float32) / np.linalg.norm([0.5, 1.0, 0.3])
    return dict(xyuv=t(xyuv),
                indices=torch.as_tensor(idx.astype(np.int64).reshape(-1, 3), device=dev),
                heights=t(heights), lut=t(lut), sun_dir=t(sun), h_min=t(-0.5),
                h_max=t(0.5), exposure=t(1.0), spacing=t(1.0), exaggeration=t(1.0),
                width=cfg.width, height=cfg.height,
                grid_n=cfg.grid if cfg.dense in VTX_MODES else None)


def route(sc: dict) -> str:
    """The route ``render_terrain_batch_u32`` takes for this scene (it is
    called with the inclusive fill rule): "vtx" or "record"."""
    vtx = pipeline.use_vtx_route(sc["grid_n"], sc["xyuv"].shape[0], sc["indices"].shape[0])
    return "vtx" if vtx else "record"


def camera_sets(cfg: Config, device):
    """``reps + 1`` distinct camera sets on ``device`` (``bench.py:120-128``);
    the last is the warm-up."""
    dev = torch.device(device)
    return [tuple(torch.as_tensor(m, device=dev)
                  for m in orbit_cameras(cfg.batch, 0.31 * rep, cfg.width, cfg.height))
            for rep in range(cfg.reps + 1)]


def render(sc: dict, views, projs) -> torch.Tensor:
    """The batch: (B, H, W) uint32 RGBA words on the scene's device."""
    return pipeline.render_terrain_batch_u32(
        sc["xyuv"], sc["indices"], sc["heights"], views, projs, spacing=sc["spacing"],
        exaggeration=sc["exaggeration"], h_min=sc["h_min"], h_max=sc["h_max"],
        exposure=sc["exposure"], sun_dir=sc["sun_dir"], lut=sc["lut"], width=sc["width"],
        height=sc["height"], fs_mode="shipped", grid_n=sc["grid_n"],
        device=sc["xyuv"].device)


def checksum(imgs: torch.Tensor) -> int:
    """``sum(img & 0xFF)`` (the red bytes) as a host int: reading it back
    waits for the batch, whose every pixel it depends on."""
    return int((imgs.view(torch.int32) & 0xFF).sum(dtype=torch.int64).item())


def card_line() -> str:
    """The card's name and power limit, the first line of ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``; where nvidia-smi
    cannot be run, the name torch reports and why the limit is missing."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out, why = "", str(e)
    else:
        why = "nvidia-smi printed nothing"
    return out.splitlines()[0] if out else \
        f"{torch.cuda.get_device_name(0)}, power.limit not read ({why})"


def _error_line(cfg: Config, error: str) -> int:
    print(json.dumps({"metric": metric_name(cfg), "value": 0.0, "unit": "Mpix/s",
                      "vs_baseline": 0.0, "device": "cuda", "error": error}))
    return 1


def _preflight() -> Optional[str]:
    """The card's first touch under the ``VF_PROBE_TIMEOUT`` watchdog; an
    error string when no card answers."""
    timeout = _device._PROBE_TIMEOUT_S
    ok, val, timed_out = _device._with_deadline(_device._cuda_devices, timeout)
    if timed_out:
        return f"device discovery timed out after {timeout:.0f}s (wedged CUDA runtime?)"
    if not ok:
        return f"device discovery failed: {val}"
    if not val:
        return "no CUDA device: torch.cuda.is_available() is False (use --device cpu)"
    return None


def measure(cfg: Config, device) -> dict:
    """Warm up on the last camera set, then time each rep's window; returns
    the per-rep times (s), checksums, route and warm-up time."""
    sc = scene(cfg, device)
    sets = camera_sets(cfg, device)
    t0 = time.perf_counter()
    checksum(render(sc, *sets[-1]))
    warm_s = time.perf_counter() - t0
    times, sums = [], []
    for views, projs in sets[:-1]:
        t1 = time.perf_counter()
        sums.append(checksum(render(sc, views, projs)))
        times.append(time.perf_counter() - t1)
    return {"times": times, "checksums": sums, "warmup_s": warm_s, "path": route(sc)}


def result_line(cfg: Config, run: dict, device, card: Optional[str]) -> dict:
    """``bench.py``'s record (``:336-365``): the median of the reps' times."""
    times = run["times"]
    dt = statistics.median(times)
    mpix = cfg.width * cfg.height * cfg.batch / dt / 1e6
    return {
        "metric": metric_name(cfg),
        "value": mpix,
        "unit": "Mpix/s",
        "vs_baseline": mpix / BASELINE_MPIX,
        "path": run["path"],
        "ms_per_batch": {"median": dt * 1e3, "best": min(times) * 1e3,
                         "mean": sum(times) / len(times) * 1e3, "reps": len(times)},
        "device": torch.device(device).type,
        "card": card,
    }


def enforce_perf(result: dict, path: str = BASELINE_PATH) -> int:
    """The throughput gate (``bench.py:418-455``) on a card's line: returns 1
    when ``VF_ENFORCE_PERF=1`` and the value is below 2/3 of the baseline
    recorded for the same card, route and metric, else 0.
    ``VF_UPDATE_PERF_BASELINE=1`` first records this run there. Diagnostics
    go to stderr."""
    baselines = {}
    if os.path.exists(path):
        with open(path) as f:
            baselines = json.load(f)
    card, route_name, metric = result["card"], result["path"], result["metric"]
    if os.environ.get("VF_UPDATE_PERF_BASELINE") == "1":
        baselines.setdefault(card, {}).setdefault(route_name, {})[metric] = result["value"]
        with open(path, "w") as f:
            json.dump(baselines, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"perf baseline updated: {card} / {route_name} / {metric} = {result['value']}",
              file=sys.stderr)
    if os.environ.get("VF_ENFORCE_PERF") != "1":
        return 0
    prev = baselines.get(card, {}).get(route_name, {}).get(metric)
    if prev is None:
        print(f"perf gate: no baseline for {metric} on {route_name} on {card} "
              "(run with VF_UPDATE_PERF_BASELINE=1)", file=sys.stderr)
        return 0
    floor = prev / 1.5
    if result["value"] < floor:
        print(f"perf gate FAIL: {result['value']} Mpix/s < floor {floor:.2f} "
              f"(baseline {prev})", file=sys.stderr)
        return 1
    print(f"perf gate ok: {result['value']} >= floor {floor:.2f} (baseline {prev})",
          file=sys.stderr)
    return 0


def main(argv=None, baseline_path: str = BASELINE_PATH) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no card: exit 1) or cpu")
    args = ap.parse_args(argv)
    cfg = config()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        error = _preflight()
        if error is not None:
            return _error_line(cfg, error)
    dev = _device.resolve_device(dev)
    run = measure(cfg, dev)
    card = card_line() if dev.type == "cuda" else None
    result = result_line(cfg, run, dev, card)
    print(json.dumps({"bench": metric_name(cfg), "card": card, "path": run["path"],
                      "warmup_s": run["warmup_s"], "times_ms": [t * 1e3 for t in run["times"]],
                      "checksums": run["checksums"]}), file=sys.stderr)
    print(json.dumps(result), flush=True)
    if dev.type != "cuda":
        return 0            # the gate and its baselines are the card's
    return enforce_perf(result, baseline_path)


if __name__ == "__main__":
    raise SystemExit(main())
