#!/usr/bin/env python3
"""Smoke run of vulkan_forge_torch on one CUDA card (an NVIDIA H100).

Usage, from the root of a checkout:  python3 chip_smoke.py [--profile]

Phases, each printing one line, in order:
  0. card: name and power limit (nvidia-smi), torch/CUDA/nvcc versions, TF32
     flags; requires a CUDA device of compute capability 9.0.
  1. build: compiles csrc/raster.cu and csrc/vtx.cu with nvcc (one process
     per source, started together) and prints the seconds and, per kernel,
     the registers, shared memory, stack and spills ptxas reports.
  2. kernel vs plain: each record-route kernel against its plain PyTorch
     version on the same CUDA tensors at the main path's shapes (triangle
     800x600, Scene 160x120 g32, spike 800x600 g128). Masks exact, varyings
     within 1e-5*max(1,|x|), images within the FS policy (every differing
     byte off by 1, at most 1e-4 of the bytes differ).
  2b. vtx kernel vs plain: each of the four vertex-stream kernels against
     its plain version (vtx.py) at 800x600: grid=256 with 2 orbit cameras,
     a close-in camera and a w-crossing camera, and the main path's shape,
     grid=1024 with 4 orbit cameras. Winners and big-triangle lists exact,
     g-buffer and images under the same bounds. Then the vtx route against
     the record route (two independent kernels) at grid=1024, 800x600: the
     batch of 4 orbit cameras and the close-in + w-crossing pair.
  3. main path, slice 1: the public API on device="cuda"
     (make_terrain(800,600,128) render_rgba/render_png,
     Scene(160,120,32,"magma") with a height upload -- both name their grid
     and take the vtx route --, render_triangle_rgba(800,600),
     and the batched entry without grid_n, which takes any mesh through the
     record route, 2 cameras at g128); both record kernels' launch counters
     must advance; each image is held to the same call on device="cpu"
     under the FS policy.
  3b. main path, slice 2: make_terrain(800,600,1024).render_rgba(), the
     batched entry with 4 orbit cameras at grid=1024, and one extended-
     shader frame at grid=1024, all on device="cuda"; every vertex-stream
     kernel's counter must advance and no record kernel may launch. The
     single frames are held to device="cpu", the batch to the record route.
  4. timing, slice 1: 32 orbit cameras at 800x600 g128 through the record
     kernel path (the batched entry without grid_n) and through the plain
     PyTorch path on the card (median of 5 batches, host clock after
     synchronize), the kernel path's stages (CUDA events), and single-frame
     latency of the public API (50 calls). Kernel times in phases 2 and 4b
     are per call over 20 back-to-back launches between CUDA events.
  4b. timing, slice 2: the batch of 4 orbit cameras at grid=1024 on both
     routes (record, vtx, vtx, record; median of 5 distinct camera sets;
     Mpix/s), the vtx route's stages, single-frame latency of
     make_terrain(800,600,1024).render_rgba(), each vtx kernel and its
     plain version (CUDA events), the record route's peak device memory,
     the route sweep (grids 8..1024, 1 and 4 frames) that shows whether
     the vtx route needs a size crossover, and the loaded big-triangle
     case: vf_vtx_cover_big and both whole routes at grid=1024 on a
     close-in + w-crossing camera pair (5 turned sets), where the list
     holds thousands of triangles. The kernels line reports
     vf_vtx_cover_big on that pair (at the orbit cameras its list is
     empty).
  5. profile, only with --profile: torch.profiler over 3 batches of each
     headline path (32 cameras g128 on the record route, 4 cameras g1024 on
     the vtx route); the device's busy share and the ops with the most
     device time. It runs after the main paths' launch counts are read.

Then one JSON line with the per-kernel record (all six kernels), and last
the line {"ok": true, "device": {...}}. Any failure raises and exits
nonzero. It imports nothing of JAX and nothing of the JAX package.
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
from vulkan_forge_torch import _camera, _colormap, _device, _formats, _mesh
from vulkan_forge_torch._parity import (FS_MAX_FRACTION, VARYING_RTOL,
                                        assert_fs_policy, assert_gbuffer_close)
from vulkan_forge_torch._raster import (fragment, kernels, pipeline, setup, tiles,
                                        transform, vtx)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
W, H, GRID, BATCH, REPS = 800, 600, 128, 32, 5
VGRID, VBATCH = 1024, 4                # bench.py:44,51: the headline scene
SWEEP_GRIDS = (8, 16, 32, 64, 128, 256, 512, 1024)

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# f32 operations per unit of work, counted from the kernels' source
# (add, sub, mul, div, min, max, compare, floor/ceil, conversions; selects
# and predicate logic not counted; sinf/cosf/powf/sqrtf as one each):
#   EVAL_OPS   one record at one pixel: 3 edge functions and 6 three-term
#              sums (tiles.py:79-90), 7 compares;
#   SETUP_OPS  setup_fields_core for one triangle (csrc/vtx.cu): ~159
#              arithmetic ops and ~60 compares;
#   COVER_OPS  one bbox pixel of the cover walk (a0..a2 unused);
#   RESOLVE_OPS the divide of tiles.py:97 at one pixel;
#   SHADE_OPS  the shipped shader at one pixel (raster_common.cuh).
EVAL_OPS, SETUP_OPS, COVER_OPS, RESOLVE_OPS, SHADE_OPS = 52, 220, 38, 5, 75


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps=REPS, warmup=2, inner=1):
    """Median device milliseconds per call of fn(), from CUDA events around
    `inner` back-to-back calls (kernels: inner > 1, so that the host's
    launch overhead overlaps the device's work instead of adding to it)."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


KERNEL_INNER = 20


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


# Kernel name of each compiled entry (a substring of its mangled name).
ENTRIES = (("raster_kernelILb0", "vf_raster_gbuffer"),
           ("raster_kernelILb1", "vf_raster_shade_shipped"),
           ("vtx_cover_kernel", "vf_vtx_cover"),
           ("vtx_cover_big_kernel", "vf_vtx_cover_big"),
           ("vtx_resolve_kernelILb0", "vf_vtx_resolve_gbuffer"),
           ("vtx_resolve_kernelILb1", "vf_vtx_resolve_shade_shipped"))


def ptxas_summary(log):
    """Per kernel: registers, shared memory, stack and spills from ptxas -v."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((name for key, name in ENTRIES if key in ln), ln.split("'")[1])
            out[cur] = {}
        elif cur and "stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[cur].update(stack_bytes=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur and "registers" in ln:
            words = ln.replace(",", " ").split()
            out[cur]["registers"] = int(words[words.index("registers") - 1])
            out[cur]["smem_bytes"] = (int(words[words.index("smem") - 2])
                                      if "smem" in words else 0)
    return out


def phase1_build():
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.load()
    seconds = time.perf_counter() - t0
    summary = ptxas_summary(open(str(path) + ".log").read())
    missing = [name for _, name in ENTRIES if name not in summary]
    if missing:
        raise AssertionError(f"ptxas reported no entry for {missing}")
    say("build", seconds=seconds, library=os.path.relpath(path, ROOT), ptxas=summary)


def phase2_kernels(dev):
    """Each kernel against its plain version on the card; returns records."""
    rec = {"gbuffer": {"err": 0.0}, "shade": {"err": 0.0}}

    # Triangle 800x600: the g-buffer kernel's main-path shape.
    records, binning = pipeline.triangle_records(W, H, dev)
    kern = kernels.raster_gbuffer(records, binning, 1, W, H)
    plain = tiles.render_gbuffer(records, binning, 1, W, H)
    rec["gbuffer"]["err"] = max(rec["gbuffer"]["err"],
                                assert_gbuffer_close(kern, plain, "triangle 800x600"))
    rec["gbuffer"]["ms"] = cuda_ms(lambda: kernels.raster_gbuffer(records, binning, 1, W, H),
                                   inner=KERNEL_INNER)
    rec["gbuffer"]["plain_ms"] = cuda_ms(lambda: tiles.render_gbuffer(records, binning, 1, W, H))
    rec["gbuffer"].update(record_bound(records, binning, 1, W, H, shade=False))
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
                lambda: kernels.raster_shade_shipped(records, binning, 1, w, h, *shade),
                inner=KERNEL_INNER)
            rec["shade"]["plain_ms"] = cuda_ms(
                lambda: fragment.terrain_fs(
                    *tiles.render_gbuffer(records, binning, 1, w, h), *shade))
            rec["shade"].update(record_bound(records, binning, 1, w, h, shade=True))
            rec["gbuffer_spike"] = {
                "ms": cuda_ms(lambda: kernels.raster_gbuffer(records, binning, 1, w, h),
                              inner=KERNEL_INNER),
                "plain_ms": cuda_ms(lambda: tiles.render_gbuffer(records, binning, 1, w, h)),
                **record_bound(records, binning, 1, w, h, shade=False)}
    sync()
    say("kernel_vs_plain", tolerance=f"masks exact; varyings <= {VARYING_RTOL}*max(1,|x|); "
        f"images: bytes off by <= 1 on <= {FS_MAX_FRACTION} of bytes",
        gbuffer_max_abs_err=rec["gbuffer"]["err"],
        shade_max_byte_delta=rec["shade"]["err"],
        ms={"gbuffer_triangle_800x600": [rec["gbuffer"]["ms"], rec["gbuffer"]["plain_ms"]],
            "gbuffer_spike_800x600_g128": [rec["gbuffer_spike"]["ms"],
                                           rec["gbuffer_spike"]["plain_ms"]],
            "shade_spike_800x600_g128": [rec["shade"]["ms"], rec["shade"]["plain_ms"]]},
        ms_order="[kernel, plain]",
        bound_ms={"gbuffer_triangle_800x600": [rec["gbuffer"]["bound_ms"],
                                               rec["gbuffer"]["bound_by"]],
                  "gbuffer_spike_800x600_g128": [rec["gbuffer_spike"]["bound_ms"],
                                                 rec["gbuffer_spike"]["bound_by"]],
                  "shade_spike_800x600_g128": [rec["shade"]["bound_ms"],
                                               rec["shade"]["bound_by"]]})
    return rec


def special_cameras(width, height, turn=0.0):
    """A close-in camera (near-camera cells span many pixels; near 0.1) and
    one inside the relief whose near plane (0.001) lies closer than a
    grid=1024 cell, so that triangles crossing w = 0 are valid and get
    full-screen bboxes; fovy 60. ``turn`` turns both about the y axis."""
    aspect = np.float32(width) / np.float32(height)
    projs = [_camera.perspective_wgpu(np.float32(math.radians(60.0)), aspect,
                                      np.float32(near), np.float32(100.0))
             for near in (0.1, 0.001)]
    c, s = math.cos(turn), math.sin(turn)
    rot = lambda p: (c * p[0] - s * p[2], p[1], s * p[0] + c * p[2])
    views = [_camera.look_at_rh(rot((0.6, 0.45, 0.5)), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
             _camera.look_at_rh((0.0, 0.9, 0.0), rot((1.5, -0.2, 1.5)), (0.0, 1.0, 0.0))]
    return np.stack(views), np.stack(projs)


def w_crossing_valid(fields, grid):
    """Valid triangles with a vertex at w <= eps (full-screen bboxes)."""
    corners = setup.grid_corners([fields[:, f] for f in range(7)], grid)
    valid = setup.setup_fields_core(*corners, W, H)[5]
    clean = (corners[0][2] > 1e-8) & (corners[1][2] > 1e-8) & (corners[2][2] > 1e-8)
    return int((valid & ~clean).sum())


def tensor(a, dev):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)


def grid_fields(grid, views, projs, dev):
    """Post-VS fields of the spike grid (zero height texture, as the
    TerrainSpike), one frame per camera."""
    xyuv, _ = _mesh.build_grid_xyuv(grid)
    one = tensor(1.0, dev)
    return vtx.vs_fields(tensor(xyuv, dev), tensor(np.zeros((1, 1)), dev),
                         tensor(views, dev), tensor(projs, dev), one, one, W, H)


def spike_shading(dev):
    """LUT, h_range, exposure and sun of make_terrain's globals."""
    a = batch_args(dev)
    return (tensor(a["lut"], dev), tensor(a["h_max"], dev) - tensor(a["h_min"], dev),
            tensor(a["exposure"], dev), tensor(a["sun_dir"], dev))


def check_vtx_passes(fields, grid, shade, label):
    """Each vtx kernel against its plain version on the same CUDA tensors.
    Returns the per-kernel errors and the big-list length."""
    winner, big, count = kernels.vtx_cover(fields, grid, W, H)
    p_winner, p_big, p_count = vtx.cover_plain(fields, grid, W, H)
    k = int(count[0])
    err = {"vf_vtx_cover": int((winner - p_winner).abs().max())}
    if err["vf_vtx_cover"] or k != int(p_count[0]) \
            or not torch.equal(torch.sort(big[:k]).values, p_big[:k]):
        raise AssertionError(f"{label}: vf_vtx_cover differs from its plain version")
    kernels.vtx_cover_big(fields, grid, winner, big, count)
    vtx.cover_big_plain(fields, grid, p_winner, p_big, p_count)
    err["vf_vtx_cover_big"] = int((winner - p_winner).abs().max())
    if err["vf_vtx_cover_big"]:
        raise AssertionError(f"{label}: vf_vtx_cover_big differs from its plain version")
    err["vf_vtx_resolve_gbuffer"] = assert_gbuffer_close(
        kernels.vtx_resolve_gbuffer(fields, grid, winner),
        vtx.resolve_gbuffer_plain(fields, grid, winner), label)
    d, _ = assert_fs_policy(kernels.vtx_resolve_shade_shipped(fields, grid, winner, *shade),
                            vtx.resolve_shade_shipped_plain(fields, grid, winner, *shade),
                            label)
    err["vf_vtx_resolve_shade_shipped"] = float(d)
    sync()
    return err, k


def record_route(grid, views, projs, dev):
    """The slice-1 record route's (records, binning) on the same scene."""
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    one = tensor(1.0, dev)
    return pipeline.terrain_records(
        tensor(xyuv, dev), torch.as_tensor(idx.astype(np.int64).reshape(-1, 3), device=dev),
        tensor(np.zeros((1, 1)), dev), tensor(views, dev), tensor(projs, dev), one, one, W, H)


def phase2b_vtx_kernels(dev):
    """The vtx kernels against their plain versions and against the record
    route; returns each kernel's max error over the cases."""
    shade = spike_shading(dev)
    close_wcross = special_cameras(W, H)
    cases = [("g256 orbit x2", 256, orbit_cameras(2, W, H, phase=0.2)),
             ("g256 close-in", 256, tuple(a[:1] for a in close_wcross)),
             ("g256 w-crossing", 256, tuple(a[1:] for a in close_wcross)),
             (f"g{VGRID} orbit x{VBATCH}", VGRID, orbit_cameras(VBATCH, W, H))]
    errs, listed = {}, {}
    for label, grid, (views, projs) in cases:
        fields = grid_fields(grid, views, projs, dev)
        if "w-crossing" in label and w_crossing_valid(fields, grid) == 0:
            raise AssertionError(f"{label}: no valid triangle crosses w = 0")
        err, listed[label] = check_vtx_passes(fields, grid, shade, f"{label} 800x600")
        for name, e in err.items():
            errs[name] = max(errs.get(name, 0.0), float(e))
        del fields
    for label in ("g256 close-in", "g256 w-crossing"):
        if listed[label] == 0:
            raise AssertionError(f"{label}: the big-triangle pass got no triangle")

    # Two independent kernels on one scene: vtx route vs record route.
    vs_record = {}
    for label, (views, projs) in ((f"g{VGRID} orbit x{VBATCH}", orbit_cameras(VBATCH, W, H)),
                                  (f"g{VGRID} close-in + w-crossing", close_wcross)):
        fields = grid_fields(VGRID, views, projs, dev)
        b = views.shape[0]
        got = vtx.render_gbuffer_vtx_batch(fields, VGRID, W, H)
        img = vtx.render_image_vtx_batch(fields, *shade, VGRID, W, H)
        del fields
        torch.cuda.reset_peak_memory_stats()
        records, binning = record_route(VGRID, views, projs, dev)
        want = kernels.raster_gbuffer(records, binning, b, W, H)
        ref_img = kernels.raster_shade_shipped(records, binning, b, W, H, *shade)
        sync()
        peak = torch.cuda.max_memory_allocated()
        g_err = assert_gbuffer_close(got, want, f"{label}: vtx vs record route")
        d, frac = assert_fs_policy(img, ref_img, f"{label}: vtx vs record route image")
        vs_record[label] = {"gbuffer_max_abs_err": g_err,
                            "gbuffer_bit_equal": all(torch.equal(a, c) for a, c in zip(got, want)),
                            "image_max_byte_delta": d, "image_frac_bytes_differ": frac,
                            "record_route_peak_bytes": int(peak),
                            "record_route_pairs": int(binning.rows.numel())}
        del records, binning, got, want
        torch.cuda.empty_cache()
    say("vtx_kernel_vs_plain", tolerance=f"winners and lists exact; masks exact; varyings "
        f"<= {VARYING_RTOL}*max(1,|x|); images: bytes off by <= 1 on <= {FS_MAX_FRACTION} "
        "of bytes", cases=[c[0] for c in cases], max_err=errs, big_listed=listed,
        vtx_vs_record_route=vs_record)
    return errs


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
    # The batched entry without grid_n takes any mesh through the record
    # route (a TerrainSpike/Scene names its grid and takes the vtx route).
    xyuv, idx = _mesh.build_grid_xyuv(GRID)
    views, projs = orbit_cameras(2, W, H, phase=0.4)

    def batch(dev):
        img = pipeline.render_terrain_batch_u32(xyuv, idx, np.zeros((1, 1), np.float32),
                                                views, projs, **batch_args(dev))
        return _formats.u32_image_to_rgba_u8(img).cpu().numpy()
    out["batch_800x600_g128_x2"] = batch("cuda")
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
           "triangle_800x600": vt.render_triangle_rgba(W, H, device="cpu"),
           "batch_800x600_g128_x2": batch("cpu")}
    parity = {}
    for name, img in out.items():
        if img.dtype != np.uint8 or img.shape[-1] != 4:
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


VTX_KERNELS = (("vf_vtx_cover", kernels.vtx_cover),
               ("vf_vtx_cover_big", kernels.vtx_cover_big),
               ("vf_vtx_resolve_gbuffer", kernels.vtx_resolve_gbuffer),
               ("vf_vtx_resolve_shade_shipped", kernels.vtx_resolve_shade_shipped))
RECORD_KERNELS = (("vf_raster_gbuffer", kernels.raster_gbuffer),
                  ("vf_raster_shade_shipped", kernels.raster_shade_shipped))


def dem(rows, cols, seed=0):
    """A smooth random height texture, made from a seed."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:rows, 0:cols] / np.float32(max(rows, cols))
    h = sum(rng.uniform(0.05, 0.2) * np.sin(2 * math.pi * (rng.uniform(1, 4) * x
                                                           + rng.uniform(1, 4) * y
                                                           + rng.uniform()))
            for _ in range(6))
    return h.astype(np.float32)


def batch_args(dev):
    """The batched entry's keyword arguments for bench.py's scene."""
    spike = vt.make_terrain(16, 16, 2, device="cpu")
    g = spike._globals
    return dict(spacing=g.spacing, exaggeration=g.exaggeration, h_min=g.h_min,
                h_max=g.h_max, exposure=g.exposure, sun_dir=g.sun_dir, lut=spike._lut,
                width=W, height=H, device=dev)


def phase3b_vtx_main_path(dev):
    """Slice 2's main path on the card; returns its launch counts."""
    xyuv, idx = _mesh.build_grid_xyuv(VGRID)
    heights = np.zeros((1, 1), np.float32)
    views, projs = orbit_cameras(VBATCH, W, H, phase=0.7)
    ext_h = dem(257, 257, seed=1)
    ext_args = dict(batch_args(dev), fs_mode="extended", grid_n=VGRID)
    ext_args.update(h_min=float(ext_h.min()), h_max=float(ext_h.max()))
    for _, fn in VTX_KERNELS + RECORD_KERNELS:
        fn.launches = 0

    spike = vt.make_terrain(W, H, VGRID, device=dev)
    frame = spike.render_rgba()
    batch = pipeline.render_terrain_batch_u32(xyuv, idx, heights, views, projs,
                                              grid_n=VGRID, **batch_args(dev))
    ext = pipeline.render_terrain_u8(xyuv, idx, ext_h, spike._view, spike._proj, **ext_args)
    sync()
    launches = {name: fn.launches for name, fn in VTX_KERNELS + RECORD_KERNELS}
    for name, _ in VTX_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"slice 2's main path never launched {name}")
    for name, _ in RECORD_KERNELS:
        if launches[name] != 0:
            raise AssertionError(f"slice 2's main path launched the record kernel {name}")

    if batch.dtype != torch.uint32 or tuple(batch.shape) != (VBATCH, H, W):
        raise AssertionError(f"bad batch {batch.dtype} {tuple(batch.shape)}")
    parity = {"frame_cuda_vs_cpu": assert_fs_policy(
        frame, vt.make_terrain(W, H, VGRID, device="cpu").render_rgba(), "g1024 frame"),
              "extended_cuda_vs_cpu": assert_fs_policy(
        ext, pipeline.render_terrain_u8(xyuv, idx, ext_h, spike._view, spike._proj,
                                        **dict(ext_args, device="cpu")), "g1024 extended")}
    records, binning = record_route(VGRID, views, projs, dev)
    parity["batch_vs_record_route"] = assert_fs_policy(
        batch, kernels.raster_shade_shipped(records, binning, VBATCH, W, H,
                                            *spike_shading(dev)), "g1024 batch")
    del records, binning
    torch.cuda.empty_cache()
    clear = np.array([39, 39, 48], np.uint8)        # the clear colour in sRGB u8
    covered = float((frame[..., :3] != clear).any(-1).mean())
    say("vtx_main_path", config=f"make_terrain({W},{H},{VGRID}).render_rgba(); batch of "
        f"{VBATCH} orbit cameras, grid={VGRID}; one extended frame, grid={VGRID}",
        launches=launches, frame_covered_share=covered,
        parity={k: {"max_byte_delta": v[0], "frac_bytes_differ": v[1]} for k, v in parity.items()},
        sha256={"frame": hashlib.sha256(frame.tobytes()).hexdigest(),
                "extended": hashlib.sha256(ext.tobytes()).hexdigest()})
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


def host_ms(fn, inputs):
    """Host milliseconds of fn(*x) after synchronize, one per input set."""
    times = []
    for x in inputs:
        t0 = time.perf_counter()
        fn(*x)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def route_fn(route, grid, dev, fs_mode="shipped"):
    """A batched render of the spike grid on one route: "vtx" names the
    grid, "record" does not (grid_n=None). The mesh stays on the card (a
    user rendering many batches uploads it once)."""
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    mesh = (tensor(xyuv, dev), torch.as_tensor(idx.astype(np.int64).reshape(-1, 3), device=dev),
            tensor(np.zeros((1, 1)), dev))
    args = dict(batch_args(dev), fs_mode=fs_mode, grid_n=grid if route == "vtx" else None)
    return lambda views, projs: pipeline.render_terrain_batch_u32(*mesh, views, projs, **args)


def compare_routes(grid, batch, dev, reps=REPS, cams=None):
    """Median ms per batch of each route: record, vtx, vtx, record over
    `reps` distinct camera sets each (orbits of `batch` cameras, or `cams`),
    after a warm-up set (the last)."""
    if cams is None:
        cams = [orbit_cameras(batch, W, H, phase=0.31 * r + 0.05) for r in range(reps + 1)]
    fns = {r: route_fn(r, grid, dev) for r in ("record", "vtx")}
    times = {"record": [], "vtx": []}
    for r in ("record", "vtx", "vtx", "record"):
        fns[r](*cams[-1])
        sync()
        times[r] += host_ms(fns[r], cams[:reps])
    return {r: statistics.median(t) for r, t in times.items()}, times


def vtx_bounds(fields, winner, big, count, grid):
    """bound_ms of each vtx kernel on these inputs: the larger of the bytes
    it must move over HBM's rate and the f32 operations it does over the
    f32 peak, counted from this run's data; and what binds."""
    B = fields.shape[0]
    T = vtx.n_triangles(grid)
    c0, c1, c2 = setup.grid_corners([fields[:, f] for f in range(7)], grid)
    _, px0, px1, py0, py1, valid = setup.setup_fields_core(c0, c1, c2, W, H)
    area = (px1 - px0 + 1).to(torch.long) * (py1 - py0 + 1).to(torch.long)
    small = valid & (area <= vtx.BIG_PIXELS)
    pairs_small = int(area[small].sum())
    pairs_big = int(area[valid & ~small].sum())
    listed = int(count[0])
    pixels = B * H * W
    covered = int((winner > 0).sum())
    frame = torch.arange(B, device=winner.device)[:, None, None]
    won = torch.unique((frame * T + winner - 1)[winner > 0])
    winners = int(won.numel())
    vertex_bytes = vtx.FIELDS * 4                  # one vertex's fields
    won_vertices = distinct_vertices(won, grid)
    listed_vertices = distinct_vertices(big[:listed].to(torch.long), grid)
    work = {
        "vf_vtx_cover": (fields.numel() * 4 + pixels * 4 + listed * 4 + 4,
                         B * T * SETUP_OPS + pairs_small * COVER_OPS),
        "vf_vtx_cover_big": (listed * 4 + 4 + listed_vertices * vertex_bytes
                             + min(pairs_big, pixels) * 8,
                             listed * SETUP_OPS + pairs_big * COVER_OPS),
        "vf_vtx_resolve_gbuffer": (pixels * 4 + won_vertices * vertex_bytes + pixels * 13,
                                   covered * (SETUP_OPS + EVAL_OPS) + pixels * RESOLVE_OPS),
        "vf_vtx_resolve_shade_shipped": (pixels * 4 + won_vertices * vertex_bytes + pixels * 4
                                         + 256 * 3 * 4,
                                         covered * (SETUP_OPS + EVAL_OPS)
                                         + pixels * (RESOLVE_OPS + SHADE_OPS)),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        out[name] = {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
                     "bytes": nbytes, "ops": ops}
    data = {"triangles": B * T, "valid": int(valid.sum()), "pairs_small": pairs_small,
            "listed": listed, "pairs_big": pairs_big, "covered_pixels": covered,
            "distinct_winners": winners, "distinct_winner_vertices": won_vertices}
    return out, data


def distinct_vertices(entries, grid):
    """Distinct grid vertices (per frame) of triangles given as frame*T + id."""
    T = vtx.n_triangles(grid)
    frame = torch.div(entries, T, rounding_mode="floor")
    tri = entries % T
    cell = torch.div(tri, 2, rounding_mode="floor")
    k = tri % 2
    a = torch.div(cell, grid - 1, rounding_mode="floor") * grid + cell % (grid - 1)
    verts = torch.stack([torch.where(k == 0, a, a + 1), a + grid,
                         torch.where(k == 0, a + 1, a + grid + 1)])
    return int(torch.unique(frame * grid * grid + verts).numel())


def record_bound(records, binning, n_frames, width, height, shade):
    """bound of a record-route kernel: records, rows and offsets read once,
    the output written once; EVAL_OPS per (pair, tile pixel) as the kernel
    walks every binned pair at every pixel of its 16x16 tile."""
    pixels = n_frames * width * height
    out_bytes = pixels * (4 if shade else 13)
    nbytes = (records.numel() * 4 + binning.rows.numel() * 4 + binning.offsets.numel() * 4
              + out_bytes + (256 * 3 * 4 if shade else 0))
    ops = (binning.rows.numel() * setup.TILE * setup.TILE * EVAL_OPS
           + pixels * (RESOLVE_OPS + (SHADE_OPS if shade else 0)))
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


def phase4b_vtx_timing(smi, dev):
    """Slice 2's times; returns the per-kernel record (ms, plain_ms, bound)."""
    head, head_all = compare_routes(VGRID, VBATCH, dev)
    mpix = {r: VBATCH * W * H / (m * 1e3) for r, m in head.items()}

    # Each vtx kernel and its plain version at the main path's shape, on 5
    # distinct camera sets (20 back-to-back launches each); medians.
    shade = spike_shading(dev)
    runs = {name: {"ms": [], "plain_ms": [], "bound_ms": []} for name, _ in VTX_KERNELS}
    for r in range(REPS):
        views, projs = orbit_cameras(VBATCH, W, H, phase=0.31 * r + 0.05)
        fields = grid_fields(VGRID, views, projs, dev)
        winner, big, count = kernels.vtx_cover(fields, VGRID, W, H)
        kernels.vtx_cover_big(fields, VGRID, winner, big, count)
        per = {
            "vf_vtx_cover": (lambda: kernels.vtx_cover(fields, VGRID, W, H),
                             lambda: vtx.cover_plain(fields, VGRID, W, H)),
            "vf_vtx_cover_big": (
                lambda: kernels.vtx_cover_big(fields, VGRID, winner, big, count),
                lambda: vtx.cover_big_plain(fields, VGRID, winner.clone(), big, count)),
            "vf_vtx_resolve_gbuffer": (
                lambda: kernels.vtx_resolve_gbuffer(fields, VGRID, winner),
                lambda: vtx.resolve_gbuffer_plain(fields, VGRID, winner)),
            "vf_vtx_resolve_shade_shipped": (
                lambda: kernels.vtx_resolve_shade_shipped(fields, VGRID, winner, *shade),
                lambda: vtx.resolve_shade_shipped_plain(fields, VGRID, winner, *shade)),
        }
        bounds, orbit_work = vtx_bounds(fields, winner, big, count, VGRID)
        for name, (k, p) in per.items():
            runs[name]["ms"].append(cuda_ms(k, reps=1, inner=KERNEL_INNER))
            runs[name]["plain_ms"].append(cuda_ms(p, reps=1, warmup=1))
            runs[name]["bound_ms"].append(bounds[name]["bound_ms"])
        del fields, winner, big
    rec = {}
    for name, r in runs.items():
        rec[name] = {k: statistics.median(v) for k, v in r.items()}
        rec[name]["bound_by"] = bounds[name]["bound_by"]
        rec[name]["all"] = r

    # The big-triangle pass under load: a close-in + w-crossing pair at
    # grid=1024, 5 turned sets. Its list holds thousands of triangles, the
    # w-crossing ones with full-screen bboxes. The kernels line reports
    # vf_vtx_cover_big here; the orbit figure (empty list) stays in this
    # phase's line.
    rec["vf_vtx_cover_big_orbit"] = rec["vf_vtx_cover_big"]
    turns = [special_cameras(W, H, turn=0.1 * r) for r in range(REPS + 1)]
    loaded = {"ms": [], "plain_ms": [], "bound_ms": []}
    loaded_work = []
    for views, projs in turns[:REPS]:
        fields = grid_fields(VGRID, views, projs, dev)
        if w_crossing_valid(fields, VGRID) == 0:
            raise AssertionError("loaded case: no valid triangle crosses w = 0")
        winner, big, count = kernels.vtx_cover(fields, VGRID, W, H)
        kernels.vtx_cover_big(fields, VGRID, winner, big, count)
        bounds, data = vtx_bounds(fields, winner, big, count, VGRID)
        if data["listed"] == 0:
            raise AssertionError("loaded case: the big-triangle list is empty")
        loaded["ms"].append(cuda_ms(
            lambda: kernels.vtx_cover_big(fields, VGRID, winner, big, count),
            reps=1, inner=KERNEL_INNER))
        loaded["plain_ms"].append(cuda_ms(
            lambda: vtx.cover_big_plain(fields, VGRID, winner.clone(), big, count),
            reps=1, warmup=1))
        loaded["bound_ms"].append(bounds["vf_vtx_cover_big"]["bound_ms"])
        loaded_work.append({**data, **{k: bounds["vf_vtx_cover_big"][k]
                                       for k in ("bytes", "ops", "bound_by")}})
        del fields, winner, big
    rec["vf_vtx_cover_big"] = {k: statistics.median(v) for k, v in loaded.items()}
    rec["vf_vtx_cover_big"].update(bound_by=bounds["vf_vtx_cover_big"]["bound_by"], all=loaded)
    loaded_routes, loaded_routes_all = compare_routes(VGRID, 2, dev, cams=turns)
    torch.cuda.empty_cache()

    # Stage split of the vtx route (CUDA events), 5 camera sets.
    xyuv, _ = _mesh.build_grid_xyuv(VGRID)
    xyuv_t, zero_h, one = tensor(xyuv, dev), tensor(np.zeros((1, 1)), dev), tensor(1.0, dev)
    names = ("vertex_stage+clip_to_fb", "vf_vtx_cover", "vf_vtx_cover_big",
             "vf_vtx_resolve_shade_shipped")
    rows = []
    for r in range(REPS + 1):
        v, p = orbit_cameras(VBATCH, W, H, phase=0.31 * r + 0.05)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        f = vtx.vs_fields(xyuv_t, zero_h, tensor(v, dev), tensor(p, dev), one, one, W, H)
        ev[1].record()
        w_, b_, c_ = kernels.vtx_cover(f, VGRID, W, H)
        ev[2].record()
        kernels.vtx_cover_big(f, VGRID, w_, b_, c_)
        ev[3].record()
        kernels.vtx_resolve_shade_shipped(f, VGRID, w_, *shade)
        ev[4].record()
        sync()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    split = {n: statistics.median(r[i] for r in rows[1:]) for i, n in enumerate(names)}
    del f, w_, b_

    # Single-frame latency of the public API at grid=1024, readback included:
    # 5 distinct orbit cameras, 4 calls each.
    spike = vt.make_terrain(W, H, VGRID, device=dev)
    spike.render_rgba()
    times = []
    for r in range(REPS):
        ang = 2.0 * math.pi * r / REPS + 0.05
        spike.set_camera_look_at((3.0 * math.cos(ang), 2.0, 3.0 * math.sin(ang)),
                                 (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0, 0.1, 100.0)
        times += host_ms(lambda: spike.render_rgba(), [()] * 4)
    q = np.percentile(times, [50, 80])
    frame = {"median_ms": float(q[0]), "p80_ms": float(q[1]), "n": len(times)}

    # Route sweep: one frame (the Scene's path) and the batch of 4.
    sweep = {}
    for grid, b in [(g, b) for g in SWEEP_GRIDS for b in (1, VBATCH)] + [(GRID, BATCH)]:
        med, _ = compare_routes(grid, b, dev, reps=3)
        sweep[f"g{grid} x{b}"] = {"triangles": vtx.n_triangles(grid), **med}
    torch.cuda.empty_cache()
    say("vtx_timing", card=smi, config=f"{VBATCH} orbit cameras, {W}x{H}, grid={VGRID}",
        ms_per_batch_median=head, ms_per_batch_all=head_all, mpix_per_s=mpix,
        vtx_route_stage_ms=split, single_frame=frame, kernel_ms=rec, work=orbit_work,
        loaded_config=f"grid={VGRID}, {W}x{H}, close-in + w-crossing pair, 5 turned sets",
        loaded_work=loaded_work, loaded_ms_per_batch_median=loaded_routes,
        loaded_ms_per_batch_all=loaded_routes_all, route_sweep_ms=sweep,
        vtx_faster_at_every_sweep_point=all(v["vtx"] < v["record"] for v in sweep.values()))
    return rec


def profile_window(render, cams, label, top=12):
    """torch.profiler over render(*c) for each camera set: the device's busy
    share (union of device-event intervals over the span from the first to
    the last of them) and the ops with the most self device time."""
    from torch.profiler import ProfilerActivity, profile

    render(*cams[-1])
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for v, p in cams[:-1]:
            render(v, p)
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
    say("profile", config=label, n_device_events=len(spans),
        device_busy_ms=busy / 1e3, device_window_ms=window / 1e3,
        busy_share=busy / window if window else None,
        self_device_ms={a.key: a.self_device_time_total / 1e3 for a in ops[:top]
                        if a.self_device_time_total > 0},
        calls={a.key: a.count for a in ops[:top] if a.self_device_time_total > 0})
    if not spans:
        raise AssertionError("the profiler recorded no device events")


def phase5_profile(dev, n_batches=3):
    """Both headline paths under torch.profiler, n_batches each."""
    xyuv, idx = _mesh.build_grid_xyuv(GRID)
    heights = np.zeros((1, 1), np.float32)
    args = dict(batch_args(dev))
    profile_window(
        lambda v, p: pipeline.render_terrain_batch_u32(xyuv, idx, heights, v, p, **args),
        [orbit_cameras(BATCH, W, H, phase=0.5 * r) for r in range(n_batches + 1)],
        f"{n_batches} batches of {BATCH} orbit cameras, {W}x{H}, grid={GRID}, record route")
    profile_window(
        route_fn("vtx", VGRID, dev),
        [orbit_cameras(VBATCH, W, H, phase=0.5 * r) for r in range(n_batches + 1)],
        f"{n_batches} batches of {VBATCH} orbit cameras, {W}x{H}, grid={VGRID}, vtx route, "
        "mesh on the card")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="after phase 4b, profile both headline paths with "
                             "torch.profiler (phase 5)")
    opts = parser.parse_args()
    smi = phase0_card()
    sync()
    phase1_build()
    sync()
    dev = torch.device("cuda")
    rec = phase2_kernels(dev)
    sync()
    vtx_err = phase2b_vtx_kernels(dev)
    sync()
    launches = phase3_main_path()
    sync()
    vtx_launches = phase3b_vtx_main_path(dev)
    launches.update({name: vtx_launches[name] for name, _ in VTX_KERNELS})
    sync()
    phase4_batch(smi, dev)
    sync()
    vtx_rec = phase4b_vtx_timing(smi, dev)
    sync()
    if opts.profile:
        phase5_profile(dev)
        sync()
    src = "vulkan_forge_torch/csrc/raster.cu"
    vsrc = "vulkan_forge_torch/csrc/vtx.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    line = [
        {"name": "vf_raster_gbuffer", "route": "cuda", "source": src,
         "replaces": "vulkan_forge/_raster/pallas_backend.py:33",
         "launches": launches["vf_raster_gbuffer"], "max_abs_err": rec["gbuffer"]["err"],
         **{k: rec["gbuffer"][k] for k in keys}, "library_ms": None},
        {"name": "vf_raster_shade_shipped", "route": "cuda", "source": src,
         "replaces": "vulkan_forge/_raster/packed.py:755",
         "launches": launches["vf_raster_shade_shipped"], "max_abs_err": rec["shade"]["err"],
         **{k: rec["shade"][k] for k in keys}, "library_ms": None},
    ]
    replaces = {"vf_vtx_cover": "vulkan_forge/_raster/vtx.py:616",
                "vf_vtx_cover_big": "vulkan_forge/_raster/vtx.py:616",
                "vf_vtx_resolve_gbuffer": "vulkan_forge/_raster/vtx.py:590",
                "vf_vtx_resolve_shade_shipped": "vulkan_forge/_raster/vtx.py:616"}
    for name, _ in VTX_KERNELS:
        line.append({"name": name, "route": "cuda", "source": vsrc, "replaces": replaces[name],
                     "launches": launches[name], "max_abs_err": vtx_err[name],
                     **{k: vtx_rec[name][k] for k in keys}, "library_ms": None})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
