#!/usr/bin/env python3
"""Smoke run of vulkan_forge_torch on one CUDA card (an NVIDIA H100).

Usage, from the root of a checkout:  python3 chip_smoke.py [--profile]

Phases, each printing one line, in order:
  0. card: name and power limit (nvidia-smi), torch/CUDA/nvcc versions, TF32
     flags; requires a CUDA device of compute capability 9.0.
  1. build: compiles csrc/raster.cu with nvcc and prints the seconds.
  2. kernel vs plain: each CUDA kernel against its plain PyTorch version on
     the same CUDA tensors at the main path's shapes (triangle 800x600,
     Scene 160x120 g32, spike 800x600 g128). Masks exact, varyings within
     1e-5*max(1,|x|), images within the FS policy (every differing byte
     off by 1, at most 1e-4 of the bytes differ).
  3. main path: the public API on device="cuda" (make_terrain(800,600,128)
     render_rgba/render_png, Scene(160,120,32,"magma") with a height upload,
     render_triangle_rgba(800,600)); both kernels' launch counters must
     advance; each image is held to the same call on device="cpu" under the
     FS policy.
  4. timing: 32 orbit cameras at 800x600 g128 through the kernel path and
     through the plain PyTorch path on the card (median of 5 batches, host
     clock after synchronize), the kernel path's stages (CUDA events), and
     single-frame latency of the public API (50 calls, median and p80).
  5. profile, only with --profile: torch.profiler over 3 batches of the
     kernel path; the device's busy share and the ops with the most device
     time. It runs after the main path's launch counts are read.

Then one JSON line with the per-kernel record, and last the line
{"ok": true, "device": {...}}. Any failure raises and exits nonzero. It
imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _colormap, _device, _mesh
from vulkan_forge_torch._parity import (FS_MAX_FRACTION, VARYING_RTOL,
                                        assert_fs_policy, assert_gbuffer_close)
from vulkan_forge_torch._raster import (fragment, kernels, pipeline, setup, tiles,
                                        transform)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
W, H, GRID, BATCH, REPS = 800, 600, 128, 32, 5


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps=REPS, warmup=2):
    """Median device milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def orbit_cameras(n, width, height, phase=0.0):
    """n cameras orbiting the spike terrain (bench.py:55-67)."""
    views, projs = [], []
    aspect = np.float32(width) / np.float32(height)
    for i in range(n):
        ang = 2.0 * math.pi * i / max(n, 1) + phase
        eye = (3.0 * math.cos(ang), 2.0 + 0.1 * math.sin(phase), 3.0 * math.sin(ang))
        views.append(_camera.look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)))
        projs.append(_camera.perspective_wgpu(np.float32(math.radians(45.0)), aspect,
                                              np.float32(0.1), np.float32(100.0)))
    return np.stack(views), np.stack(projs)


def scene_height():
    """The height upload of the golden Scene (tests/test_goldens.py:54-55)."""
    return (np.outer(np.sin(np.linspace(0, 3, 33)),
                     np.cos(np.linspace(0, 2, 45))) * 0.3).astype(np.float32)


def scene_inputs(obj, dev):
    """(records, binning, shading args) of a TerrainSpike/Scene's frame on dev."""
    g = obj._globals
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    records, binning = pipeline.terrain_records(
        t(obj._xyuv), torch.as_tensor(obj._indices.astype(np.int64).reshape(-1, 3), device=dev),
        t(obj._heights), t(obj._view)[None], t(obj._proj)[None],
        t(g.spacing), t(g.exaggeration), obj.width, obj.height)
    shade = (t(obj._lut), t(g.h_max) - t(g.h_min), t(g.exposure), t(g.sun_dir))
    return records, binning, shade


def png_pixels(path):
    """Decode a PNG written by vulkan_forge_torch._io (filter 0, RGBA8)."""
    data = open(path, "rb").read()
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            size = (int.from_bytes(body[4:8], "big"), int.from_bytes(body[0:4], "big"))
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(size[0], -1)
    if np.any(raw[:, 0] != 0):
        raise AssertionError("unexpected PNG row filter")
    return raw[:, 1:].reshape(size[0], size[1], 4)


def phase0_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    info = _device.device_info("cuda")
    if info["capability"] != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (Hopper), "
                         f"got {info['capability']}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kernels._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[-1]
    print(smi, flush=True)
    say("card", nvidia_smi=smi, **info, nvcc=nvcc,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def phase1_build():
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.load()
    seconds = time.perf_counter() - t0
    log = open(str(path) + ".log").read()
    ptxas = [ln.strip() for ln in log.splitlines()
             if any(k in ln for k in ("entry function", "registers", "spill"))]
    say("build", seconds=seconds, library=os.path.relpath(path, ROOT), ptxas=ptxas)


def phase2_kernels(dev):
    """Each kernel against its plain version on the card; returns records."""
    rec = {"gbuffer": {"err": 0.0}, "shade": {"err": 0.0}}

    # Triangle 800x600: the g-buffer kernel's main-path shape.
    records, binning = pipeline.triangle_records(W, H, dev)
    kern = kernels.raster_gbuffer(records, binning, 1, W, H)
    plain = tiles.render_gbuffer(records, binning, 1, W, H)
    rec["gbuffer"]["err"] = max(rec["gbuffer"]["err"],
                                assert_gbuffer_close(kern, plain, "triangle 800x600"))
    rec["gbuffer"]["ms"] = cuda_ms(lambda: kernels.raster_gbuffer(records, binning, 1, W, H))
    rec["gbuffer"]["plain_ms"] = cuda_ms(lambda: tiles.render_gbuffer(records, binning, 1, W, H))
    sync()

    scene = vt.Scene(160, 120, 32, "magma", device="cpu")
    scene.set_height_from_r32f(scene_height())
    spike = vt.make_terrain(W, H, GRID, device="cpu")
    for label, obj in (("scene 160x120 g32", scene), ("spike 800x600 g128", spike)):
        records, binning, shade = scene_inputs(obj, dev)
        w, h = obj.width, obj.height
        kern = kernels.raster_gbuffer(records, binning, 1, w, h)
        plain = tiles.render_gbuffer(records, binning, 1, w, h)
        rec["gbuffer"]["err"] = max(rec["gbuffer"]["err"],
                                    assert_gbuffer_close(kern, plain, label))
        img_k = kernels.raster_shade_shipped(records, binning, 1, w, h, *shade)
        img_p = fragment.terrain_fs(*plain, *shade)
        d, _ = assert_fs_policy(img_k.cpu().numpy(), img_p.cpu().numpy(), label)
        rec["shade"]["err"] = max(rec["shade"]["err"], float(d))
        sync()
        if obj is spike:
            rec["shade"]["ms"] = cuda_ms(
                lambda: kernels.raster_shade_shipped(records, binning, 1, w, h, *shade))
            rec["shade"]["plain_ms"] = cuda_ms(
                lambda: fragment.terrain_fs(
                    *tiles.render_gbuffer(records, binning, 1, w, h), *shade))
            rec["gbuffer_spike"] = {
                "ms": cuda_ms(lambda: kernels.raster_gbuffer(records, binning, 1, w, h)),
                "plain_ms": cuda_ms(lambda: tiles.render_gbuffer(records, binning, 1, w, h))}
    sync()
    say("kernel_vs_plain", tolerance=f"masks exact; varyings <= {VARYING_RTOL}*max(1,|x|); "
        f"images: bytes off by <= 1 on <= {FS_MAX_FRACTION} of bytes",
        gbuffer_max_abs_err=rec["gbuffer"]["err"],
        shade_max_byte_delta=rec["shade"]["err"],
        ms={"gbuffer_triangle_800x600": [rec["gbuffer"]["ms"], rec["gbuffer"]["plain_ms"]],
            "gbuffer_spike_800x600_g128": [rec["gbuffer_spike"]["ms"],
                                           rec["gbuffer_spike"]["plain_ms"]],
            "shade_spike_800x600_g128": [rec["shade"]["ms"], rec["shade"]["plain_ms"]]},
        ms_order="[kernel, plain]")
    return rec


def phase3_main_path():
    """The public API on the card; returns the main path's launch counts."""
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "spike_800x600_g128.png")
    kernels.raster_gbuffer.launches = 0
    kernels.raster_shade_shipped.launches = 0

    spike = vt.make_terrain(W, H, GRID, device="cuda")
    out = {"spike_800x600_g128": spike.render_rgba()}
    spike.render_png(png)
    scene = vt.Scene(160, 120, 32, "magma", device="cuda")
    scene.set_height_from_r32f(scene_height())
    out["scene_magma_160x120_g32"] = scene.render_rgba()
    out["triangle_800x600"] = vt.render_triangle_rgba(W, H, device="cuda")
    sync()
    launches = {"vf_raster_gbuffer": kernels.raster_gbuffer.launches,
                "vf_raster_shade_shipped": kernels.raster_shade_shipped.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")

    cpu_spike = vt.make_terrain(W, H, GRID, device="cpu")
    cpu_scene = vt.Scene(160, 120, 32, "magma", device="cpu")
    cpu_scene.set_height_from_r32f(scene_height())
    ref = {"spike_800x600_g128": cpu_spike.render_rgba(),
           "scene_magma_160x120_g32": cpu_scene.render_rgba(),
           "triangle_800x600": vt.render_triangle_rgba(W, H, device="cpu")}
    parity = {}
    for name, img in out.items():
        if img.dtype != np.uint8 or img.shape[2] != 4:
            raise AssertionError(f"{name}: bad image {img.dtype} {img.shape}")
        parity[name] = assert_fs_policy(img, ref[name], f"{name} cuda vs cpu")
    if not np.array_equal(png_pixels(png), out["spike_800x600_g128"]):
        raise AssertionError("PNG does not round-trip the rendered pixels")
    say("main_path", launches=launches,
        cuda_vs_cpu={k: {"max_byte_delta": v[0], "frac_bytes_differ": v[1]}
                     for k, v in parity.items()},
        sha256={k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in out.items()},
        sha256_cpu={k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in ref.items()})
    return launches


def phase4_batch(smi, dev):
    xyuv, idx = _mesh.build_grid_xyuv(GRID)
    lut, _ = _colormap.build_lut("viridis")
    sun = np.array([0.5, 1.0, 0.3], np.float32) / np.linalg.norm([0.5, 1.0, 0.3])
    args = dict(spacing=1.0, exaggeration=1.0, h_min=-0.5, h_max=0.5,
                exposure=1.0, sun_dir=sun.astype(np.float32), lut=lut,
                width=W, height=H, device=dev)
    heights = np.zeros((1, 1), np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    shade = (t(lut), t(1.0), t(1.0), t(sun))
    idx_t = torch.as_tensor(idx.astype(np.int64).reshape(-1, 3), device=dev)

    def kernel_path(views, projs):
        return pipeline.render_terrain_batch_u32(xyuv, idx, heights, views, projs, **args)

    def plain_path(views, projs):
        records, binning = pipeline.terrain_records(
            t(xyuv), idx_t, t(heights), t(views), t(projs), t(1.0), t(1.0), W, H)
        return fragment.terrain_fs(*tiles.render_gbuffer(records, binning, BATCH, W, H),
                                   *shade)

    cams = [orbit_cameras(BATCH, W, H, phase=0.31 * r) for r in range(REPS + 1)]
    results = {}
    for name, fn in (("plain", plain_path), ("kernel", kernel_path),
                     ("kernel_2", kernel_path), ("plain_2", plain_path)):
        fn(*cams[-1])                               # warm-up set, never timed
        sync()
        times = []
        for v, p in cams[:REPS]:
            t0 = time.perf_counter()
            fn(v, p)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        results[name] = times
    img_k = kernel_path(*cams[0]).cpu().numpy()
    img_p = plain_path(*cams[0]).cpu().numpy()
    assert_fs_policy(img_k, img_p, "batch kernel vs plain")

    # Stage split of the kernel path (CUDA events around each stage).
    v, p = t(cams[0][0]), t(cams[0][1])
    one = t(1.0)
    names = ("vertex_stage", "clip_to_fb+triangle_setup", "bin_tiles", "fused_kernel")
    rows = []
    for _ in range(REPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        clip, vary = transform.terrain_vs(t(xyuv), t(heights), v, p, one, one)
        ev[1].record()
        x, y, z, w = setup.clip_to_fb(clip, W, H)
        records, bbox = setup.triangle_setup(x, y, z, w, vary, idx_t, W, H)
        ev[2].record()
        binning = setup.bin_tiles(bbox, W, H)
        ev[3].record()
        kernels.raster_shade_shipped(records.reshape(-1, setup.REC_WIDTH), binning,
                                     BATCH, W, H, *shade)
        ev[4].record()
        sync()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    split = {n: statistics.median(r[i] for r in rows[1:]) for i, n in enumerate(names)}

    # Single-frame latency through the public API, readback included.
    spike = vt.make_terrain(W, H, GRID, device=dev)
    frame = {}
    for name, fn in (("spike_800x600_g128_render_rgba", spike.render_rgba),
                     ("triangle_800x600_render_triangle_rgba",
                      lambda: vt.render_triangle_rgba(W, H, device=dev))):
        fn()
        times = []
        for _ in range(50):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        q = np.percentile(times, [50, 80])
        frame[name] = {"median_ms": float(q[0]), "p80_ms": float(q[1]), "n": len(times)}
    sync()
    med = {k: statistics.median(v) for k, v in results.items()}
    mpix = {k: BATCH * W * H / (m * 1e3) for k, m in med.items()}
    say("batch", card=smi, config=f"{BATCH} orbit cameras, {W}x{H}, grid={GRID}",
        ms_per_batch_median=med, ms_per_batch_all=results, mpix_per_s=mpix,
        kernel_path_stage_ms=split, pairs=int(binning.rows.numel()),
        single_frame=frame)
    return med


def phase5_profile(dev, n_batches=3, top=12):
    """torch.profiler over n_batches of the kernel path: the device's busy
    share (union of device-event intervals over the span from the first to
    the last of them) and the ops with the most self device time."""
    from torch.profiler import ProfilerActivity, profile

    xyuv, idx = _mesh.build_grid_xyuv(GRID)
    lut, _ = _colormap.build_lut("viridis")
    sun = np.array([0.5, 1.0, 0.3], np.float32) / np.linalg.norm([0.5, 1.0, 0.3])
    args = dict(spacing=1.0, exaggeration=1.0, h_min=-0.5, h_max=0.5,
                exposure=1.0, sun_dir=sun.astype(np.float32), lut=lut,
                width=W, height=H, device=dev)
    heights = np.zeros((1, 1), np.float32)
    cams = [orbit_cameras(BATCH, W, H, phase=0.5 * r) for r in range(n_batches + 1)]
    pipeline.render_terrain_batch_u32(xyuv, idx, heights, *cams[-1], **args)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for v, p in cams[:n_batches]:
            pipeline.render_terrain_batch_u32(xyuv, idx, heights, v, p, **args)
        sync()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0] if spans else 0
    ops = sorted(prof.key_averages(), key=lambda a: a.self_device_time_total, reverse=True)
    say("profile", config=f"{n_batches} batches of {BATCH} orbit cameras, {W}x{H}, "
        f"grid={GRID}, kernel path", n_device_events=len(spans),
        device_busy_ms=busy / 1e3, device_window_ms=window / 1e3,
        busy_share=busy / window if window else None,
        self_device_ms={a.key: a.self_device_time_total / 1e3 for a in ops[:top]
                        if a.self_device_time_total > 0},
        calls={a.key: a.count for a in ops[:top] if a.self_device_time_total > 0})
    if not spans:
        raise AssertionError("the profiler recorded no device events")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="after phase 4, profile the batch path with "
                             "torch.profiler (phase 5)")
    opts = parser.parse_args()
    smi = phase0_card()
    sync()
    phase1_build()
    sync()
    dev = torch.device("cuda")
    rec = phase2_kernels(dev)
    sync()
    launches = phase3_main_path()
    sync()
    phase4_batch(smi, dev)
    sync()
    if opts.profile:
        phase5_profile(dev)
        sync()
    src = "vulkan_forge_torch/csrc/raster.cu"
    print(json.dumps({"kernels": [
        {"name": "vf_raster_gbuffer", "route": "cuda", "source": src,
         "replaces": "vulkan_forge/_raster/pallas_backend.py:33",
         "launches": launches["vf_raster_gbuffer"],
         "max_abs_err": rec["gbuffer"]["err"],
         "ms": rec["gbuffer"]["ms"], "plain_ms": rec["gbuffer"]["plain_ms"]},
        {"name": "vf_raster_shade_shipped", "route": "cuda", "source": src,
         "replaces": "vulkan_forge/_raster/packed.py:755",
         "launches": launches["vf_raster_shade_shipped"],
         "max_abs_err": rec["shade"]["err"],
         "ms": rec["shade"]["ms"], "plain_ms": rec["shade"]["plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
