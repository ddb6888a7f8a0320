#!/usr/bin/env python3
"""Smoke run of vulkan_forge_torch on one CUDA card (an NVIDIA H100).

Usage, from the root of a checkout:  python3 chip_smoke.py [--profile]

Phases, each printing one line, in order:
  0. card: name and power limit (nvidia-smi), torch/CUDA/nvcc versions, TF32
     flags; requires a CUDA device of compute capability 9.0.
  1. build: compiles csrc/raster.cu, vtx.cu, packed.cu and segments.cu with
     nvcc (one process per source, started together) and prints the seconds and, per kernel,
     the registers, shared memory, stack and spills ptxas reports and the
     blocks per SM they allow; then the host core, csrc/host.cpp, with g++
     (-ffp-contract=off), and its seconds and library path.
  2. kernel vs plain: each record-route kernel against its plain PyTorch
     version on the same CUDA tensors at the main path's shapes (triangle
     800x600, Scene 160x120 g32, spike 800x600 g128). Masks exact, varyings
     within 1e-5*max(1,|x|), images within the FS policy (every differing
     byte off by 1, at most 1e-4 of the bytes differ); each tile's (pair,
     box pixel) items the kernel walked (its evaluated output) equal to the
     torch mirror's (tiles.tile_work); the restated bound (record_bound:
     the pairs' rows and boxes, the binned records' cover columns, the
     winners' varying columns, COVER_OPS per item, EVAL_OPS per covered
     pixel) beside the former one (full_tile_bound_ms); each record
     kernel's device time per launch (torch.profiler) beside its per-call
     time.
  2b. vtx kernel vs plain: each of the four vertex-stream kernels against
     its plain version (vtx.py) at 800x600: grid=256 with 2 orbit cameras,
     a close-in camera, a w-crossing camera and a camera whose near plane
     cuts the grid (valid triangles straddling it, asserted), and the main
     path's shape, grid=1024 with 4 orbit cameras. Winners and big-triangle
     lists exact, vf_vtx_cover's survivors (the triangles that passed its
     bbox test) equal to the plain count of valid triangles of at most
     vtx.BIG_PIXELS bbox pixels, g-buffer and images under the same
     bounds; vf_vtx_cover_big's tiles
     walked per list entry (its walked output) equal the torch mirror of
     its rejects (vtx.big_tile_walk), sorted by entry. Then the vtx route
     against the record route (two independent kernels) at grid=1024,
     800x600: the batch of 4 orbit cameras and the close-in + w-crossing
     pair, g-buffers bit-equal.
  2c. indexed kernel vs plain: each of the three indexed-mesh kernels
     (csrc/packed.cu) against its plain version (packed.py) at 800x600: a
     Renderer DEM-256 at its default camera, close in, with w-crossing
     triangles (asserted) and with a near plane that cuts the mesh
     (asserted), a 50K-triangle soup made from a seed, and a DEM-2048 at
     the default camera. Winners and lists exact, survivors equal to the
     plain count, g-buffer within 1e-5*max(1,|x|); vf_packed_cover_big's
     tiles walked per list entry equal the torch mirror's, as in 2b. Then
     the indexed route against the record route on 4c's first loaded pair
     (DEM-2048 close-in + w-crossing), g-buffers bit-equal.
  2d. hw kernel vs plain: vf_raster_gbuffer_hw and vf_raster_shade_shipped_hw
     (the hardware fill rule, VF_FILL_RULE=hw) against their plain versions
     over records set up under "hw": the grid-16 160x120 scene, whose mask
     must equal hw_oracle's (the int64 fixed-point rasterizer) bit for bit,
     the spike 800x600 g128, a g256 w-crossing camera, the main path's
     triangle, g1024 spike and DEM-2048 frames and a watertight quad, where
     no pixel is covered twice and every interior pixel once; evaluated
     items equal to the mirror's, as in 2.
  2e. segment kernel vs plain: vf_seg_gbuffer and vf_seg_shade_shipped (the
     tall-frame route, csrc/segments.cu) against their plain version at a
     tall 256x4352 frame: the spike g256 on the estimate's walk, on each
     forced walk (row- and column-major) and at a w-crossing camera, and a
     Renderer DEM-512 (extended). Masks, winners and varyings bit-equal,
     images under the FS policy; the (tile, record) pairs each tile
     evaluated (the kernel's evaluated output) equal the torch mirror of
     its skip tests (segments.overlap_walk); the plain walk's time there.
  3. main path, slice 1: the public API on device="cuda"
     (make_terrain(800,600,128) render_rgba/render_png,
     Scene(160,120,32,"magma") with a height upload -- both name their grid
     and take the vtx route --, render_triangle_rgba(800,600),
     and the batched entry without grid_n, which takes any mesh through the
     record route, 2 cameras at g128); both record kernels' launch counters
     must advance; each image is held to the same call on device="cpu"
     under the FS policy; after the counts are read, the triangle and the
     batch records again with evaluated items equal to the mirror's.
  3b. main path, slice 2: make_terrain(800,600,1024).render_rgba(), the
     batched entry with 4 orbit cameras at grid=1024, and one extended-
     shader frame at grid=1024, all on device="cuda"; every vertex-stream
     kernel's counter must advance and no record kernel may launch. The
     single frames are held to device="cpu", the batch to the record route.
  3c. main path, slice 3: Renderer(800,600) on device="cuda" with
     add_terrain(DEM-2048, 30 m, x1.5, "terrain"), upload_height_r32f,
     set_sun, set_exposure, render_rgba and render_png, then render_rgba of
     a 3601^2 DEM (the SRTM 1" tile, T = 25.9M > 2^24); every indexed
     kernel's counter must advance and no record or vtx kernel may launch.
     Both frames' g-buffers are held bit for bit to the record route's on
     the card (skipped if it cannot fit), a DEM-256 frame to device="cpu"
     under the FS policy; render_metrics must be filled in.
  3d. main path, slice 4: with VF_FILL_RULE=hw (set inside the phase and
     restored after) render_triangle_rgba(800,600),
     make_terrain(800,600,1024).render_rgba() and the Renderer's DEM-2048
     render_rgba() on device="cuda"; both hw kernels' counters must advance
     and no other kernel may launch. The triangle and a Scene 160x120 g32
     are held to device="cpu" under the FS policy; after the counts are
     read, the three frames' hw records with evaluated items equal to the
     mirror's.
  3e. main path, slice 5: at 7680x4320 make_terrain(7680,4320,1024)
     .render_rgba() and Renderer.render_rgba() at DEM-2048 and DEM-3601
     on device="cuda"; both segment kernels' counters must advance and no
     other kernel may launch. Each frame's g-buffer must equal the vtx or
     indexed route's on the same frame bit for bit, and its image that
     route's under the FS policy; peak device memory per frame. Then, on
     the 8 tile rows of each frame that walk the most records, the kernels
     against their plain version (the plain walk over those rows' tables):
     g-buffers bit-equal, the shipped image under the FS policy; the plain
     walk's time there, and the kernels' on the same rows' tables.
  3f. the public surface, slice 11: device_probe("CUDA") and device_probe()
     ok with NVIDIA's vendor id, device_probe("TPU") unsupported,
     enumerate_adapters() one adapter per card with the framebuffer limit;
     render_spike_frames(800,600,1024) on 4 orbit eyes with the counts set
     to 0 just before it (the three vtx kernels of the shaded path must
     launch, no other), byte-equal to render_terrain_batch_u32 and to
     TerrainSpike.render_rgba() per eye, then timed in turns with the
     direct batch (phase 4b's vtx route, mesh and frames on the card;
     median of 5 camera sets, host clock after synchronize, Mpix/s) and the
     host's mesh build; render_spike_frames at g2048 and g4096 (4 frames
     each), each frame's vtx kernels against their plain versions alone
     (phase 2b's bounds) and its bytes against the kernels' image of that
     frame, with peak device memory; the six CLI twins as subprocesses on
     --device cuda (device_diagnostics: CUDA ok; determinism_harness on the
     triangle and --scene terrain, 3 runs: all_equal, the triangle's hash
     the in-process one; backends_runner --require-same: TORCH_CUDA and
     TORCH_CPU equal; terrain_spike: its PNG's pixels equal
     make_terrain(512,384,128)'s; parity_report --rules hw: no coverage
     difference against hw_oracle; then perf_sanity alone on the 800x600
     triangle under VF_ENFORCE_PERF=1, its p95 beside the reference's
     budget); grid_generate(1024, 1024), which must take the port's C++
     core (its call counter +1 per call) and equal make_grid bit for bit at
     spacings (1, 1) and (0.1, 1/3), timed in turns with the numpy path
     (make_grid and the u32 copy), median of 5 each, against the
     reference's 80 ms,
     which the core's median must not exceed; and the PNG encoder on a
     7680x4320 frame (host clock).
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
     plain version (CUDA events) with vf_vtx_cover's survivor share, its
     bound (cover_bound) and the former one (full_setup_bound_ms), the
     resolves' device time per launch (torch.profiler) and their bound
     over the fields' 32-byte sectors their winners touch
     (sector_bound_ms, vtx.resolve_sectors) beside bound_ms, the
     record route's peak device memory,
     the route sweep (grids 8..1024, 1 and 4 frames) that shows whether
     the vtx route needs a size crossover, and the loaded big-triangle
     case: vf_vtx_cover_big and both whole routes at grid=1024 on a
     close-in + w-crossing camera pair (5 turned sets), where the list
     holds thousands of triangles: the kernel's walk counts held to the
     mirror's, and per set the bbox pixels of the listed triangles
     (bbox_pairs), the pixels of the tiles the kernel walked
     (walked_pairs), the covered (triangle, pixel) pairs of the plain pass
     (covered_big_pairs), the triangles rejected whole, the tiles of the
     entry that walks the most and the kernel's time over it alone, the
     bound on the covered pairs and the one on the bbox pairs. The kernels
     line reports vf_vtx_cover_big on that pair (at the orbit cameras its
     list is empty).
  4c. timing, slice 3: render_rgba() latency at DEM-1024, DEM-2048 and
     DEM-3601 (median and p80 of 20 calls, readback included), the stages of a
     DEM-2048 frame (CUDA events), each indexed kernel and its plain
     version over 5 turned cameras (vf_packed_cover's survivor share and
     bounds as in 4b, the resolve's device time and sector_bound_ms as
     in 4b, packed.resolve_sectors; vf_packed_cover_big on a close-in +
     w-crossing pair, where its list is full, with 4b's walk counts and
     work per set), both routes on the DEM-2048 frame with their peak
     device memory, and the route sweep (DEMs 32^2 to 2048^2) that sets
     the indexed route's threshold.
  4d. timing, slice 4: each 3d frame under hw against inclusive (median and
     p80 of 20 calls, peak device memory), and the four record kernels per
     launch (20 back-to-back launches), each hw kernel in turns with its
     inclusive twin, on the triangle, spike g128, spike g1024, DEM-2048 and
     the loaded g1024 close-in + w-crossing pair (full-tile boxes), with
     each kernel's device time per launch (torch.profiler), the plain
     version's time, the restated bound, full_tile_bound_ms and the pairs,
     items and covered pixels. The parent's body is timed
     against these in turns by scripts/torch_cover_ab.py.
  4e. timing, slice 5: frame latency (median and p80 of 10 calls, readback
     included) on the segment route and on the route each tall frame took
     before (vtx or indexed), in turns, at 7680x4320 (g1024, DEM-2048,
     DEM-3601) and 4096x4096 (g1024, DEM-2048); CUDA events around each
     stage of the segment route; each segment kernel at the main path's
     shape against its bound (bbox-overlapping (tile, triangle) pairs), and
     its plain time from 3e; on g1024, DEM-2048 and DEM-3601 at 7680x4320
     the pairs the kernel evaluated, which must equal the bbox-overlapping
     pairs, the intervals K8's walk visits and those the y-extent test
     skips, the records scanned, and the kernel's time on the whole
     frame's tables and on the band's.
  5. profile, only with --profile: torch.profiler over 3 batches of each
     headline path (32 cameras g128 on the record route, 4 cameras g1024 on
     the vtx route); the device's busy share and the ops with the most
     device time. It runs after the main paths' launch counts are read.

Then one JSON line with the per-kernel record (all thirteen kernels), and last
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
from vulkan_forge_torch import (_camera, _colormap, _device, _formats, _io, _mesh,
                                _native, _renderer)
from vulkan_forge_torch._parity import (FS_MAX_FRACTION, VARYING_RTOL,
                                        assert_fs_policy, assert_gbuffer_close)
from vulkan_forge_torch._raster import (fragment, hw_oracle, kernels, packed, pipeline,
                                        segments, setup, tiles, transform, vtx)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
W, H, GRID, BATCH, REPS = 800, 600, 128, 32, 5
VGRID, VBATCH = 1024, 4                # bench.py:44,51: the headline scene
SWEEP_GRIDS = (8, 16, 32, 64, 128, 256, 512, 1024)

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# f32 operations per unit of work, counted from the kernels' source
# (add, sub, mul, div, min, max, compare, floor/ceil, conversions; a fused
# multiply-add as two; selects and predicate logic not counted;
# sinf/cosf/powf/sqrtf as one each):
#   EVAL_OPS   one record at one pixel (vf::eval_pixel): 3 edge functions
#              and 6 three-term sums, 7 compares;
#   SETUP_OPS  setup_fields_core for one triangle (raster_common.cuh): ~159
#              arithmetic ops and ~60 compares;
#   TEST_OPS   the cover passes' bbox test of one triangle (vf::setup_bbox
#              without crossings, and the area test): area, the clip flags,
#              four 6-way min/max chains, the pixel conversions;
#   CROSS_OPS  one near-plane crossing (vf::crossing), which setup_bbox
#              computes only on an edge that straddles z_clip = 0;
#   RECORD_OPS the coverage columns of one survivor's record
#              (vf::setup_columns without the varyings, which coverage never
#              reads): the edges, the signs, 1/w, rw*t and zn*t;
#   COVER_OPS  one pixel of a cover walk (a0..a2 not evaluated); the big
#              passes' bound charges it per covered (triangle, pixel) pair,
#              the least a walk must evaluate, not per bbox pixel; the
#              record kernels' per (pair, box pixel) item, since their
#              binning cannot tell which box pixels a pair covers;
#   RESOLVE_OPS the divide of tiles.py:97 at one pixel;
#   SHADE_OPS  the shipped shader at one pixel (raster_common.cuh).
EVAL_OPS, SETUP_OPS, COVER_OPS, RESOLVE_OPS, SHADE_OPS = 52, 220, 38, 5, 75
TEST_OPS, CROSS_OPS, RECORD_OPS = 100, 25, 41
# The position planes the cover passes read (x_fb, y_fb, w_clip, z_ndc).
POSITION_FIELDS = 4


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


def kernel_device_ms(fn, key="raster_kernel", calls=KERNEL_INNER):
    """Device milliseconds per launch of the kernel whose name holds ``key``
    over ``calls`` calls of fn (torch.profiler, the mean over the launches
    it recorded): the kernel alone, without its wrapper's host work, which
    CUDA events around back-to-back calls include once a kernel is shorter
    than that work (the record kernels since their redesign)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(5):              # a session may record none of them
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            sync()
        ev = [a for a in prof.key_averages() if key in a.key]
        seen = sum(a.count for a in ev)
        if seen:
            break
    if not seen or seen > calls:
        raise AssertionError(f"the profiler recorded {seen} {key} launches in {calls} calls")
    return sum(a.self_device_time_total for a in ev) / seen / 1e3


def orbit_eyes(n, phase=0.0):
    """The eyes of n cameras orbiting the spike terrain (bench.py:55-67)."""
    angles = (2.0 * math.pi * i / max(n, 1) + phase for i in range(n))
    return [(3.0 * math.cos(a), 2.0 + 0.1 * math.sin(phase), 3.0 * math.sin(a))
            for a in angles]


def orbit_cameras(n, width, height, phase=0.0):
    """n cameras orbiting the spike terrain (bench.py:55-67), looking at the
    origin: fovy 45, near 0.1, far 100 (render_spike_frames' defaults)."""
    aspect = np.float32(width) / np.float32(height)
    views = [_camera.look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
             for eye in orbit_eyes(n, phase)]
    proj = _camera.perspective_wgpu(np.float32(math.radians(45.0)), aspect,
                                    np.float32(0.1), np.float32(100.0))
    return np.stack(views), np.stack([proj] * n)


def scene_height():
    """The height upload of the golden Scene (tests/test_goldens.py:54-55)."""
    return (np.outer(np.sin(np.linspace(0, 3, 33)),
                     np.cos(np.linspace(0, 2, 45))) * 0.3).astype(np.float32)


def scene_inputs(obj, dev, fill_rule="inclusive"):
    """(records, binning, shading args) of a TerrainSpike/Scene's frame on
    dev, set up under ``fill_rule``."""
    g = obj._globals
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    records, binning = pipeline.terrain_records(
        t(obj._xyuv), torch.as_tensor(obj._indices.astype(np.int64).reshape(-1, 3), device=dev),
        t(obj._heights), t(obj._view)[None], t(obj._proj)[None],
        t(g.spacing), t(g.exaggeration), obj.width, obj.height, fill_rule=fill_rule)
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
ENTRIES = (("raster_kernelILb0ELb0", "vf_raster_gbuffer"),
           ("raster_kernelILb1ELb0", "vf_raster_shade_shipped"),
           ("raster_kernelILb0ELb1", "vf_raster_gbuffer_hw"),
           ("raster_kernelILb1ELb1", "vf_raster_shade_shipped_hw"),
           ("vtx_cover_kernel", "vf_vtx_cover"),
           ("vtx_cover_big_kernel", "vf_vtx_cover_big"),
           ("vtx_resolve_kernelILb0", "vf_vtx_resolve_gbuffer"),
           ("vtx_resolve_kernelILb1", "vf_vtx_resolve_shade_shipped"),
           ("packed_cover_kernel", "vf_packed_cover"),
           ("packed_cover_big_kernel", "vf_packed_cover_big"),
           ("packed_resolve_kernel", "vf_packed_resolve_gbuffer"),
           ("seg_kernelILb0", "vf_seg_gbuffer"),
           ("seg_kernelILb1", "vf_seg_shade_shipped"))


def blocks_per_sm(registers, smem_bytes, threads=256):
    """Resident blocks of `threads` threads per SM of an H100 (64K registers,
    allocated per warp in units of 256; 228 KB of shared memory, 1 KB of it
    reserved per block; 64 warps, 32 blocks). Every kernel of the port
    launches 256 threads with static shared memory only."""
    warps = threads // 32
    per_warp = -(-registers * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps if per_warp else 32
    by_smem = (233472 // (smem_bytes + 1024)) if smem_bytes else 32
    return min(by_regs, by_smem, 64 // warps, 32)


def ptxas_summary(log):
    """Per kernel: registers, shared memory, stack and spills from ptxas -v,
    and the blocks per SM they allow."""
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
            out[cur]["blocks_per_sm"] = blocks_per_sm(out[cur]["registers"],
                                                      out[cur]["smem_bytes"])
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
    t0 = time.perf_counter()
    host = _native.build()
    _native.load()
    host_seconds = time.perf_counter() - t0
    say("build", seconds=seconds, library=os.path.relpath(path, ROOT), ptxas=summary,
        host_core={"seconds": host_seconds, "library": os.path.relpath(host, ROOT),
                   "compiler": _native.CXX, "flags": " ".join(_native.CXX_FLAGS)})


def phase2_kernels(dev):
    """Each kernel against its plain version on the card; returns records."""
    rec = {"gbuffer": {"err": 0.0}, "shade": {"err": 0.0}}
    items = {}

    # Triangle 800x600: the g-buffer kernel's main-path shape.
    records, binning = pipeline.triangle_records(W, H, dev)
    kern, items["gbuffer triangle 800x600"] = walked(kernels.raster_gbuffer, records,
                                                     binning, 1, W, H)
    plain = tiles.render_gbuffer(records, binning, 1, W, H)
    rec["gbuffer"]["err"] = max(rec["gbuffer"]["err"],
                                assert_gbuffer_close(kern, plain, "triangle 800x600"))
    rec["gbuffer"]["ms"] = cuda_ms(lambda: kernels.raster_gbuffer(records, binning, 1, W, H),
                                   inner=KERNEL_INNER)
    rec["gbuffer"]["device_ms"] = kernel_device_ms(
        lambda: kernels.raster_gbuffer(records, binning, 1, W, H))
    rec["gbuffer"]["plain_ms"] = cuda_ms(lambda: tiles.render_gbuffer(records, binning, 1, W, H))
    rec["gbuffer"].update(record_bound(records, binning, 1, W, H, False, int(kern[3].sum())))
    sync()

    scene = vt.Scene(160, 120, 32, "magma", device="cpu")
    scene.set_height_from_r32f(scene_height())
    spike = vt.make_terrain(W, H, GRID, device="cpu")
    for label, obj in (("scene 160x120 g32", scene), ("spike 800x600 g128", spike)):
        records, binning, shade = scene_inputs(obj, dev)
        w, h = obj.width, obj.height
        kern, items[f"gbuffer {label}"] = walked(kernels.raster_gbuffer, records, binning,
                                                 1, w, h)
        plain = tiles.render_gbuffer(records, binning, 1, w, h)
        rec["gbuffer"]["err"] = max(rec["gbuffer"]["err"],
                                    assert_gbuffer_close(kern, plain, label))
        img_k, items[f"shade {label}"] = walked(kernels.raster_shade_shipped, records,
                                                binning, 1, w, h, *shade)
        img_p = fragment.terrain_fs(*plain, *shade)
        d, _ = assert_fs_policy(img_k.cpu().numpy(), img_p.cpu().numpy(), label)
        rec["shade"]["err"] = max(rec["shade"]["err"], float(d))
        sync()
        if obj is spike:
            covered = int(kern[3].sum())
            rec["shade"]["ms"] = cuda_ms(
                lambda: kernels.raster_shade_shipped(records, binning, 1, w, h, *shade),
                inner=KERNEL_INNER)
            rec["shade"]["device_ms"] = kernel_device_ms(
                lambda: kernels.raster_shade_shipped(records, binning, 1, w, h, *shade))
            rec["shade"]["plain_ms"] = cuda_ms(
                lambda: fragment.terrain_fs(
                    *tiles.render_gbuffer(records, binning, 1, w, h), *shade))
            rec["shade"].update(record_bound(records, binning, 1, w, h, True, covered))
            rec["gbuffer_spike"] = {
                "ms": cuda_ms(lambda: kernels.raster_gbuffer(records, binning, 1, w, h),
                              inner=KERNEL_INNER),
                "device_ms": kernel_device_ms(
                    lambda: kernels.raster_gbuffer(records, binning, 1, w, h)),
                "plain_ms": cuda_ms(lambda: tiles.render_gbuffer(records, binning, 1, w, h)),
                **record_bound(records, binning, 1, w, h, False, covered)}
    sync()
    say("kernel_vs_plain", tolerance=f"masks exact; varyings <= {VARYING_RTOL}*max(1,|x|); "
        f"images: bytes off by <= 1 on <= {FS_MAX_FRACTION} of bytes; evaluated equal to "
        "tiles.tile_work", evaluated_items=items,
        gbuffer_max_abs_err=rec["gbuffer"]["err"],
        shade_max_byte_delta=rec["shade"]["err"],
        ms={"gbuffer_triangle_800x600": [rec["gbuffer"]["ms"], rec["gbuffer"]["plain_ms"]],
            "gbuffer_spike_800x600_g128": [rec["gbuffer_spike"]["ms"],
                                           rec["gbuffer_spike"]["plain_ms"]],
            "shade_spike_800x600_g128": [rec["shade"]["ms"], rec["shade"]["plain_ms"]]},
        ms_order="[kernel, plain]",
        device_ms={name: r["device_ms"] for name, r in (
            ("gbuffer_triangle_800x600", rec["gbuffer"]),
            ("gbuffer_spike_800x600_g128", rec["gbuffer_spike"]),
            ("shade_spike_800x600_g128", rec["shade"]))},
        bound_ms={name: [r["bound_ms"], r["bound_by"], r["full_tile_bound_ms"]]
                  for name, r in (("gbuffer_triangle_800x600", rec["gbuffer"]),
                                  ("gbuffer_spike_800x600_g128", rec["gbuffer_spike"]),
                                  ("shade_spike_800x600_g128", rec["shade"]))},
        bound_order="[bound_ms, bound_by, full_tile_bound_ms]",
        work={name: {k: r[k] for k in ("pairs", "items", "covered")}
              for name, r in (("gbuffer_triangle_800x600", rec["gbuffer"]),
                              ("spike_800x600_g128", rec["shade"]))})
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


def big_walk_work(corners_of, T, big, count):
    """The torch mirror of the big-triangle kernels' rejects on a sorted
    list (the plain cover pass's): the tiles walked per entry, in list
    order, and the work: bbox_pairs (every bbox pixel of the listed
    triangles), walked_tiles, walked_pairs (their pixels, clipped to the
    bbox), rejected_triangles (walked no tile)."""
    cols, px0, px1, py0, py1, _, _ = vtx.listed_setup(corners_of, T, big, count, W, H)
    owner, x0, x1, y0, y1 = vtx.big_tile_walk(cols, px0, px1, py0, py1)
    per = torch.bincount(owner, minlength=px0.numel()).to(torch.int32)
    area = (px1 - px0 + 1).to(torch.long) * (py1 - py0 + 1).to(torch.long)
    return per, {"bbox_pairs": int(area.sum()), "walked_tiles": int(owner.numel()),
                 "walked_pairs": int(((x1 - x0 + 1) * (y1 - y0 + 1)).sum()),
                 "rejected_triangles": int((per == 0).sum())}


def check_walk_counts(big, count, walked, p_big, want, label, name):
    """A big-triangle kernel's tiles walked per list entry (its list in any
    order) against the mirror's on the plain pass's sorted list."""
    k = int(count[0])
    order = torch.argsort(big[:k])
    if not (torch.equal(big[:k][order], p_big[:k]) and torch.equal(walked[:k][order], want)):
        raise AssertionError(f"{label}: {name}'s tiles walked per entry differ from "
                             "the torch mirror's")


def check_survivors(survivors, stats, label, name):
    """A cover kernel's survivors (per frame) against the plain pass's count
    of valid triangles of at most BIG_PIXELS bbox pixels: phase A took the
    plain setup's decisions. Returns the count."""
    if not torch.equal(survivors.long(), stats["survivors"]):
        raise AssertionError(f"{label}: {name}'s survivors {survivors.tolist()} differ from "
                             f"the plain count {stats['survivors'].tolist()}")
    return int(survivors.sum())


def check_vtx_passes(fields, grid, shade, label):
    """Each vtx kernel against its plain version on the same CUDA tensors.
    Returns the per-kernel errors, the big-list length, the big pass's
    walk (big_walk_work) and the cover pass's survivors."""
    survivors = torch.full((fields.shape[0],), -1, dtype=torch.int32, device=fields.device)
    stats = {}
    winner, big, count = kernels.vtx_cover(fields, grid, W, H, survivors=survivors)
    p_winner, p_big, p_count = vtx.cover_plain(fields, grid, W, H, stats)
    k = int(count[0])
    err = {"vf_vtx_cover": int((winner - p_winner).abs().max())}
    if err["vf_vtx_cover"] or k != int(p_count[0]) \
            or not torch.equal(torch.sort(big[:k]).values, p_big[:k]):
        raise AssertionError(f"{label}: vf_vtx_cover differs from its plain version")
    kept = check_survivors(survivors, stats, label, "vf_vtx_cover")
    walked = torch.full_like(big, -1)
    kernels.vtx_cover_big(fields, grid, winner, big, count, walked)
    vtx.cover_big_plain(fields, grid, p_winner, p_big, p_count)
    err["vf_vtx_cover_big"] = int((winner - p_winner).abs().max())
    if err["vf_vtx_cover_big"]:
        raise AssertionError(f"{label}: vf_vtx_cover_big differs from its plain version")
    want, walk = big_walk_work(lambda f, t: vtx.tri_corners(fields, grid, f, t),
                               vtx.n_triangles(grid), p_big, p_count)
    check_walk_counts(big, count, walked, p_big, want, label, "vf_vtx_cover_big")
    err["vf_vtx_resolve_gbuffer"] = assert_gbuffer_close(
        kernels.vtx_resolve_gbuffer(fields, grid, winner),
        vtx.resolve_gbuffer_plain(fields, grid, winner), label)
    d, _ = assert_fs_policy(kernels.vtx_resolve_shade_shipped(fields, grid, winner, *shade),
                            vtx.resolve_shade_shipped_plain(fields, grid, winner, *shade),
                            label)
    err["vf_vtx_resolve_shade_shipped"] = float(d)
    sync()
    return err, k, walk, kept


def record_route(grid, views, projs, dev, fill_rule="inclusive"):
    """The slice-1 record route's (records, binning) on the same scene."""
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    one = tensor(1.0, dev)
    return pipeline.terrain_records(
        tensor(xyuv, dev), torch.as_tensor(idx.astype(np.int64).reshape(-1, 3), device=dev),
        tensor(np.zeros((1, 1)), dev), tensor(views, dev), tensor(projs, dev), one, one, W, H,
        fill_rule=fill_rule)


def near_cut_camera(width, height):
    """An orbit camera of the spike (bench.py's eye height, 45 degrees)
    whose near plane (3.5) cuts the grid: valid triangles in front of the
    camera straddle z_clip = 0 and take their bbox from the crossings."""
    aspect = np.float32(width) / np.float32(height)
    view = _camera.look_at_rh((3.0, 2.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    proj = _camera.perspective_wgpu(np.float32(math.radians(45.0)), aspect, np.float32(3.5),
                                    np.float32(100.0))
    return view[None], proj[None]


def near_cut_valid(corners):
    """Valid triangles whose bbox the near-plane crossings set."""
    return int(setup.near_cut(*corners, setup.setup_fields_core(*corners, W, H)[5]).sum())


def phase2b_vtx_kernels(dev):
    """The vtx kernels against their plain versions and against the record
    route; returns each kernel's max error over the cases."""
    shade = spike_shading(dev)
    close_wcross = special_cameras(W, H)
    cases = [("g256 orbit x2", 256, orbit_cameras(2, W, H, phase=0.2)),
             ("g256 close-in", 256, tuple(a[:1] for a in close_wcross)),
             ("g256 w-crossing", 256, tuple(a[1:] for a in close_wcross)),
             ("g256 near-cut", 256, near_cut_camera(W, H)),
             (f"g{VGRID} orbit x{VBATCH}", VGRID, orbit_cameras(VBATCH, W, H))]
    errs, listed, walks, kept, cut = {}, {}, {}, {}, {}
    for label, grid, (views, projs) in cases:
        fields = grid_fields(grid, views, projs, dev)
        if "w-crossing" in label and w_crossing_valid(fields, grid) == 0:
            raise AssertionError(f"{label}: no valid triangle crosses w = 0")
        if "near-cut" in label:
            cut[label] = near_cut_valid(setup.grid_corners([fields[:, f] for f in range(7)],
                                                           grid))
            if cut[label] == 0:
                raise AssertionError(f"{label}: the near plane cuts no valid triangle")
        err, listed[label], walks[label], kept[label] = check_vtx_passes(
            fields, grid, shade, f"{label} 800x600")
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
        if not all(torch.equal(a, c) for a, c in zip(got, want)):
            raise AssertionError(f"{label}: the vtx g-buffer is not the record route's")
        vs_record[label] = {"gbuffer_max_abs_err": g_err, "gbuffer_bit_equal": True,
                            "image_max_byte_delta": d, "image_frac_bytes_differ": frac,
                            "record_route_peak_bytes": int(peak),
                            "record_route_pairs": int(binning.rows.numel())}
        del records, binning, got, want
        torch.cuda.empty_cache()
    say("vtx_kernel_vs_plain", tolerance=f"winners and lists exact; masks exact; varyings "
        f"<= {VARYING_RTOL}*max(1,|x|); images: bytes off by <= 1 on <= {FS_MAX_FRACTION} "
        "of bytes; big-pass walk counts equal the mirror's; survivors equal the plain count",
        cases=[c[0] for c in cases], max_err=errs, big_listed=listed, big_walk=walks,
        survivors=kept, near_cut_straddling_valid=cut, vtx_vs_record_route=vs_record)
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
    # The record frames of this phase again, with the kernels' evaluated
    # items held to the mirror's (after the launch counts were read).
    a = batch_args("cuda")
    t = lambda v: tensor(v, "cuda")
    batch_records = pipeline.terrain_records(
        t(xyuv), torch.as_tensor(idx.astype(np.int64).reshape(-1, 3), device="cuda"),
        t(np.zeros((1, 1))), t(views), t(projs), t(a["spacing"]), t(a["exaggeration"]), W, H)
    items = {"triangle_800x600": walked(kernels.raster_gbuffer,
                                        *pipeline.triangle_records(W, H, "cuda"), 1, W, H)[1],
             "batch_800x600_g128_x2": walked(kernels.raster_shade_shipped, *batch_records,
                                             2, W, H, *spike_shading("cuda"))[1]}
    del batch_records

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
    say("main_path", launches=launches, evaluated_items=items,
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


def cover_work(corners):
    """What the cover passes' bbox test finds on these inputs: per triangle
    valid, its bbox pixels and whether it is a survivor (valid, at most
    BIG_PIXELS bbox pixels), and the edges that straddle z_clip = 0 (each
    triangle computes its own crossings)."""
    _, px0, px1, py0, py1, valid = setup.setup_fields_core(*corners, W, H)
    area = (px1 - px0 + 1).to(torch.long) * (py1 - py0 + 1).to(torch.long)
    small = valid & (area <= vtx.BIG_PIXELS)
    return valid, area, small, int(setup.straddling_edges(*corners).sum())


def cover_bound(position_bytes, other_bytes, field_bytes, triangles, survivors,
                straddling, pairs_small):
    """The cover pass's bound on these inputs, and the former one
    (full_setup_bound_ms): every triangle tested (TEST_OPS, CROSS_OPS per
    straddling edge), the coverage columns of the survivors (RECORD_OPS)
    and their bbox pixels (COVER_OPS); the 4 position planes read once
    (coverage never reads the varyings). The former bound charged the
    whole record to every triangle and all 7 planes."""
    bound = bound_of(position_bytes + other_bytes,
                     triangles * TEST_OPS + straddling * CROSS_OPS + survivors * RECORD_OPS
                     + pairs_small * COVER_OPS)
    full = bound_of(field_bytes + other_bytes,
                    triangles * SETUP_OPS + pairs_small * COVER_OPS)["bound_ms"]
    return bound, full


def vtx_bounds(fields, winner, big, count, grid, covered_big):
    """bound_ms of each vtx kernel on these inputs: the larger of the bytes
    it must move over HBM's rate and the f32 operations it does over the
    f32 peak, counted from this run's data; and what binds. The cover
    pass's as cover_bound counts it (the former bound beside it as
    full_setup_bound_ms). covered_big: the (listed triangle, pixel) pairs
    the plain big pass covered; the big pass's bound charges those, its
    bound over every bbox pixel is reported beside it as bbox_bound_ms.
    The resolves' bound charges 28 B per distinct winner vertex (the least
    any layout moves); their sector_bound_ms charges instead the 32-byte
    sectors of the (B, 7, N) fields that the winners' corners touch over
    the 6 planes a resolve reads (vtx.resolve_sectors: the least this
    layout moves), beside the winner plane and the outputs."""
    B = fields.shape[0]
    T = vtx.n_triangles(grid)
    valid, area, small, straddling = cover_work(
        setup.grid_corners([fields[:, f] for f in range(7)], grid))
    pairs_small = int(area[small].sum())
    bbox_pairs = int(area[valid & ~small].sum())
    survivors = int(small.sum())
    listed = int(count[0])
    pixels = B * H * W
    covered = int((winner > 0).sum())
    frame = torch.arange(B, device=winner.device)[:, None, None]
    won = torch.unique((frame * T + winner - 1)[winner > 0])
    winners = int(won.numel())
    vertex_bytes = vtx.FIELDS * 4                  # one vertex's fields
    won_vertices = distinct_vertices(won, grid)
    listed_bytes = listed * 4 + 4 + distinct_vertices(big[:listed].to(torch.long), grid) \
        * vertex_bytes
    cover, full_setup = cover_bound(B * grid * grid * POSITION_FIELDS * 4,
                                    pixels * 4 + listed * 4 + 4, fields.numel() * 4, B * T,
                                    survivors, straddling, pairs_small)
    # The resolves' outputs and f32 operations.
    resolves = {"vf_vtx_resolve_gbuffer": (pixels * 13, covered * (SETUP_OPS + EVAL_OPS)
                                           + pixels * RESOLVE_OPS),
                "vf_vtx_resolve_shade_shipped": (pixels * 4 + 256 * 3 * 4,
                                                 covered * (SETUP_OPS + EVAL_OPS)
                                                 + pixels * (RESOLVE_OPS + SHADE_OPS))}
    work = {
        "vf_vtx_cover_big": (listed_bytes + min(covered_big, pixels) * 8,
                             listed * SETUP_OPS + covered_big * COVER_OPS),
        **{name: (pixels * 4 + won_vertices * vertex_bytes + written, ops)
           for name, (written, ops) in resolves.items()},
    }
    out = {"vf_vtx_cover": cover, **{name: bound_of(*w) for name, w in work.items()}}
    sectors = vtx.resolve_sectors(fields, grid, winner)
    for name, (written, ops) in resolves.items():
        out[name]["sector_bound_ms"] = bound_of(
            pixels * 4 + sectors * vtx.SECTOR_BYTES + written, ops)["bound_ms"]
    bbox_bound = bound_of(listed_bytes + min(bbox_pairs, pixels) * 8,
                          listed * SETUP_OPS + bbox_pairs * COVER_OPS)["bound_ms"]
    data = {"triangles": B * T, "valid": int(valid.sum()), "survivors": survivors,
            "survivor_share": survivors / (B * T), "straddling_edges": straddling,
            "pairs_small": pairs_small, "full_setup_bound_ms": full_setup,
            "listed": listed, "bbox_pairs": bbox_pairs, "covered_big_pairs": covered_big,
            "bbox_bound_ms": bbox_bound, "covered_pixels": covered,
            "distinct_winners": winners, "distinct_winner_vertices": won_vertices,
            "resolve_sectors": sectors}
    return out, data


def loaded_big_pass(label, name, kern, plain, corners_of, T, winner, big, count, p_big,
                    p_count, bounds_of, warmup):
    """One loaded set of a big-triangle kernel: its winners against the plain
    pass's from the same cover-pass winner (max_abs_err), its tiles walked
    per entry against the mirror's, its time (KERNEL_INNER launches), its
    time over the list entry that walks the most tiles alone
    (heaviest_alone_ms: whether one triangle sets the tail), the plain
    pass's time (one timed call after ``warmup``), and the work and bounds
    of bounds_of(covered_big_pairs). ``kern(winner, big, count, walked)``
    and ``plain(winner, stats)`` run the two passes in place."""
    k = int(count[0])
    if k == 0:
        raise AssertionError(f"{label}: the big-triangle list is empty")
    start = winner.clone()
    walked = torch.full_like(big, -1)
    kern(winner, big, count, walked)
    want, walk = big_walk_work(corners_of, T, p_big, p_count)
    check_walk_counts(big, count, walked, p_big, want, label, name)
    ms = cuda_ms(lambda: kern(winner, big, count), reps=1, inner=KERNEL_INNER)
    heaviest = big.clone()
    heaviest[0] = big[int(torch.argmax(walked[:k]))]
    one = torch.ones_like(count)
    alone_ms = cuda_ms(lambda: kern(winner, heaviest, one), reps=1, inner=KERNEL_INNER)
    stats, out = {}, {}

    def run_plain():
        out["winner"] = plain(start.clone(), stats)
    plain_ms = cuda_ms(run_plain, reps=1, warmup=warmup)
    err = int((out["winner"] - winner).abs().max())
    if err:
        raise AssertionError(f"{label}: {name} differs from its plain version")
    bounds, data = bounds_of(stats["covered_pairs"])
    if data["bbox_pairs"] != walk["bbox_pairs"]:
        raise AssertionError(f"{label}: the mirror's bboxes are not the listed triangles'")
    return {**data, **walk, "heaviest_tiles": int(want.max()), "heaviest_alone_ms": alone_ms,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **{key: bounds[name][key] for key in ("bound_ms", "bytes", "ops", "bound_by")}}, bounds


def distinct_vertices(entries, grid):
    """Distinct grid vertices (per frame) of triangles given as frame*T + id."""
    T = vtx.n_triangles(grid)
    frame = torch.div(entries, T, rounding_mode="floor")
    verts = torch.stack(vtx.tri_vertices(grid, entries % T))
    return int(torch.unique(frame * grid * grid + verts).numel())


def bound_of(nbytes, ops):
    """The least time for a kernel's work: the larger of its bytes over
    HBM's rate and its f32 operations over the peak rate; and what binds."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


# The record kernels' columns: what the cover test reads of each binned
# record (0..11, 21..30, and the thresholds 31..33 under hw) and what the
# resolve reads besides of each winner (the varying numerators 12..20).
COVER_COLS, VARYING_COLS = 22, 9


def record_bound(records, binning, n_frames, width, height, shade, covered, hw=False):
    """bound of a record-route kernel over the work its walk must do: each
    pair's row and box and the offsets read once, the cover columns of each
    binned record (culled records are never read) and the varying columns of
    each winner -- at most min(covered pixels, binned records) of them --
    read once, the output written once; COVER_OPS per (pair, box pixel)
    item, EVAL_OPS per covered pixel (its winner's evaluation) and the
    resolve (and shader) per pixel. ``covered``: the frame's covered pixels.
    ``full_tile_bound_ms`` is the former bound, EVAL_OPS per (pair, tile
    pixel) over all 31 (34) live columns, the work of the body that
    evaluated every binned record at all 256 pixels of its tile."""
    pixels = n_frames * width * height
    out_bytes = pixels * (4 if shade else 13) + (256 * 3 * 4 if shade else 0)
    per_pixel = RESOLVE_OPS + (SHADE_OPS if shade else 0)
    pairs = binning.rows.numel()
    binned = int(torch.unique(binning.rows).numel())
    items = int(tiles.tile_work(binning).sum())
    cols = COVER_COLS + (3 if hw else 0)
    nbytes = (binned * cols * 4 + min(covered, binned) * VARYING_COLS * 4 + pairs * 8
              + binning.offsets.numel() * 4 + out_bytes)
    full = bound_of(binned * (setup.HW_COLS if hw else setup.NUM_COLS) * 4 + pairs * 4
                    + binning.offsets.numel() * 4 + out_bytes,
                    pairs * setup.TILE * setup.TILE * EVAL_OPS + pixels * per_pixel)
    return {**bound_of(nbytes, items * COVER_OPS + covered * EVAL_OPS + pixels * per_pixel),
            "full_tile_bound_ms": full["bound_ms"], "pairs": pairs, "items": items,
            "covered": covered}


def walked(fn, records, binning, n_frames, width, height, *args):
    """fn (a record kernel) with its ``evaluated`` output; fails unless each
    tile's (pair, pixel) items equal the torch mirror's (tiles.tile_work).
    Returns (fn's output, the items)."""
    ntx, nty = setup.tile_grid(width, height)
    ev = torch.full((n_frames, nty * ntx), -1, dtype=torch.int32, device=records.device)
    out = fn(records, binning, n_frames, width, height, *args, evaluated=ev)
    want = tiles.tile_work(binning)
    if not torch.equal(ev.view(-1).long(), want):
        raise AssertionError(f"{fn.__name__}: evaluated differs from tiles.tile_work on "
                             f"{int((ev.view(-1).long() != want).sum())} tiles")
    return out, int(want.sum())


def covered_pixels(records, binning, n_frames, width, height, hw=False):
    """The covered pixels of a record frame (the g-buffer kernel's mask)."""
    fn = kernels.raster_gbuffer_hw if hw else kernels.raster_gbuffer
    return int(fn(records, binning, n_frames, width, height)[3].sum())


# The three resolves (vf::resolve_tile): phases 4b and 4c also give their
# device time per launch and their bound over the fields' sectors.
RESOLVES = {"vf_vtx_resolve_gbuffer", "vf_vtx_resolve_shade_shipped",
            "vf_packed_resolve_gbuffer"}


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
        stats = {}
        per = {
            "vf_vtx_cover": (lambda: kernels.vtx_cover(fields, VGRID, W, H),
                             lambda: vtx.cover_plain(fields, VGRID, W, H)),
            "vf_vtx_cover_big": (
                lambda: kernels.vtx_cover_big(fields, VGRID, winner, big, count),
                lambda: vtx.cover_big_plain(fields, VGRID, winner.clone(), big, count, stats)),
            "vf_vtx_resolve_gbuffer": (
                lambda: kernels.vtx_resolve_gbuffer(fields, VGRID, winner),
                lambda: vtx.resolve_gbuffer_plain(fields, VGRID, winner)),
            "vf_vtx_resolve_shade_shipped": (
                lambda: kernels.vtx_resolve_shade_shipped(fields, VGRID, winner, *shade),
                lambda: vtx.resolve_shade_shipped_plain(fields, VGRID, winner, *shade)),
        }
        for name, (k, p) in per.items():
            runs[name]["ms"].append(cuda_ms(k, reps=1, inner=KERNEL_INNER))
            runs[name]["plain_ms"].append(cuda_ms(p, reps=1, warmup=1))
        bounds, orbit_work = vtx_bounds(fields, winner, big, count, VGRID,
                                        stats["covered_pairs"])
        for name in per:
            runs[name]["bound_ms"].append(bounds[name]["bound_ms"])
        for name in RESOLVES & per.keys():
            runs[name].setdefault("device_ms", []).append(
                kernel_device_ms(per[name][0], key="resolve_kernel"))
            runs[name].setdefault("sector_bound_ms", []).append(
                bounds[name]["sector_bound_ms"])
        for key in ("full_setup_bound_ms", "survivor_share"):
            runs["vf_vtx_cover"].setdefault(key, []).append(orbit_work[key])
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
    for r, (views, projs) in enumerate(turns[:REPS]):
        fields = grid_fields(VGRID, views, projs, dev)
        if w_crossing_valid(fields, VGRID) == 0:
            raise AssertionError("loaded case: no valid triangle crosses w = 0")
        corners_of = lambda f, t: vtx.tri_corners(fields, VGRID, f, t)
        kern = lambda w, b, c, walked=None: kernels.vtx_cover_big(fields, VGRID, w, b, c, walked)
        plain = lambda w, st=None: vtx.cover_big_plain(fields, VGRID, w, big, count, st)
        winner, big, count = kernels.vtx_cover(fields, VGRID, W, H)
        _, p_big, p_count = vtx.cover_plain(fields, VGRID, W, H)
        data, bounds = loaded_big_pass(f"loaded set {r}", "vf_vtx_cover_big", kern, plain,
                                       corners_of, vtx.n_triangles(VGRID), winner, big,
                                       count, p_big, p_count,
                                       lambda cov: vtx_bounds(fields, winner, big, count,
                                                              VGRID, cov), warmup=1)
        for k in loaded:
            loaded[k].append(data[k])
        loaded_work.append(data)
        del fields, winner, big, p_big
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


# ---------------- slice 3: the Renderer and the indexed-mesh route ----------------

PACKED_KERNELS = (("vf_packed_cover", kernels.packed_cover),
                  ("vf_packed_cover_big", kernels.packed_cover_big),
                  ("vf_packed_resolve_gbuffer", kernels.packed_resolve_gbuffer))
DEM_SPACING, DEM_EXAG, DEM_RELIEF = (30.0, 30.0), 1.5, 1500.0
DEM_CHECK, DEM_MAIN = 256, 2048    # phase 2c's small DEM; the main path's DEM
SRTM = 3601                        # an SRTM 1-arc-second tile: T = 25,920,000
LATENCY_DEMS = (1024, 2048, SRTM)
SWEEP_DEMS = (32, 64, 128, 256, 512, 1024, 2048)


def dem_heights(n, seed):
    """An n x n DEM in metres: ``dem``'s smooth relief scaled to ~1.5 km."""
    return dem(n, n, seed) * np.float32(DEM_RELIEF)


def make_renderer(n, dev, seed=0, size=(W, H)):
    """The Renderer's main path up to the frame: add_terrain of an n x n
    DEM (30 m spacing, exaggeration 1.5, "terrain"), upload_height_r32f,
    set_sun, set_exposure; a ``size`` = (width, height) frame."""
    r = vt.Renderer(*size, device=dev)
    r.add_terrain(dem_heights(n, seed), DEM_SPACING, DEM_EXAG, "terrain")
    r.upload_height_r32f()
    r.set_sun(35.0, 120.0)
    r.set_exposure(1.1)
    return r


def rot_y(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float32)


def renderer_frame(r, views=None, projs=None):
    """(xyuv, int32 triangles, heights, views, projs) of a Renderer's frame
    on its device: the mesh, texture and default camera render_rgba uses,
    or the given cameras."""
    terr = r._terrain
    xyuv, tris = _renderer.grid_mesh(terr.width, terr.height, *terr.spacing, r.device)
    if views is None:
        view, proj = r._default_terrain_camera(terr)
        views, projs = view[None], proj[None]
    return xyuv, tris, r._height_tex, tensor(views, r.device), tensor(projs, r.device)


def turned_cameras(r, k):
    """The default camera turned by 0.3*k rad about the DEM's vertical axis."""
    view, proj = r._default_terrain_camera(r._terrain)
    return (view @ rot_y(0.3 * k))[None], proj[None]


def special_dem_cameras(r, turn=0.0):
    """A close-in camera (300 m above the DEM centre, near 0.1: 30 m cells
    span tens of pixels) and a w-crossing one (5 m above it, near 0.001:
    neighbouring triangles straddle the eye's plane and stay valid), both
    fovy 60 and turned by ``turn`` about the vertical axis."""
    terr = r._terrain
    h0 = float(terr.heights[terr.height // 2, terr.width // 2])
    aspect = np.float32(W) / np.float32(H)
    views, projs = [], []
    for above, near, target in ((300.0, 0.1, (-3000.0, h0 - 400.0, -2000.0)),
                                (5.0, 0.001, (3000.0, h0 - 100.0, 2500.0))):
        views.append(_camera.look_at_rh((0.0, h0 + above, 0.0), target, (0.0, 1.0, 0.0))
                     @ rot_y(turn))
        projs.append(_camera.perspective_wgpu(np.float32(math.radians(60.0)), aspect,
                                              np.float32(near), np.float32(1e6)))
    return np.stack(views), np.stack(projs)


def near_cut_dem_camera(r):
    """The Renderer's default camera with its near plane at 0.8 of the
    distance to the DEM centre, which cuts the mesh (fovy 45)."""
    terr = r._terrain
    view, _ = r._default_terrain_camera(terr)
    extent = max((terr.width - 1) * terr.spacing[0], (terr.height - 1) * terr.spacing[1])
    near = 0.8 * math.sqrt(2.0) * 0.9 * extent
    proj = _camera.perspective_wgpu(np.float32(math.radians(45.0)),
                                    np.float32(W) / np.float32(H), np.float32(near),
                                    np.float32(10.0 * near))
    return view[None], proj[None]


def frame_fields(xyuv, heights, views, projs):
    one = tensor(1.0, xyuv.device)
    return vtx.vs_fields(xyuv, heights, views, projs, one, one, W, H, "extended")


def record_gbuffer(xyuv, tris, heights, views, projs):
    """The record route's g-buffer of the same frames: the extended vertex
    stage, setup_cols + bin_tiles, vf_raster_gbuffer (tris int64)."""
    one = tensor(1.0, xyuv.device)
    records, binning = pipeline.terrain_records(xyuv, tris, heights, views, projs, one, one,
                                                W, H, fs_mode="extended")
    return kernels.raster_gbuffer(records, binning, views.shape[0], W, H)


def soup_frame(dev, n_tris=50_000, n_verts=20_000, seed=7):
    """An arbitrary triangle soup, made from a seed: random vertices over
    6 km x 6 km, a random height texture, a random index buffer."""
    rng = np.random.default_rng(seed)
    xyuv = np.concatenate([rng.uniform(-3000, 3000, (n_verts, 2)),
                           rng.uniform(0, 1, (n_verts, 2))], axis=1)
    tris = torch.as_tensor(rng.integers(0, n_verts, (n_tris, 3)), dtype=torch.int32, device=dev)
    view = _camera.look_at_rh((-5000.0, 4000.0, 1000.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    proj = _camera.perspective_wgpu(np.float32(math.radians(45.0)), np.float32(W) / np.float32(H),
                                    np.float32(1.0), np.float32(1e5))
    return (tensor(xyuv, dev), tris, tensor(rng.uniform(-500, 500, (64, 64)), dev),
            tensor(view[None], dev), tensor(proj[None], dev))


def check_packed_passes(fields, tris, label):
    """Each indexed kernel against its plain version on the same CUDA
    tensors. Returns the per-kernel errors, the big-list length, the
    g-buffer's bit equality, the big pass's walk (big_walk_work) and the
    cover pass's survivors."""
    survivors = torch.full((fields.shape[0],), -1, dtype=torch.int32, device=fields.device)
    stats = {}
    winner, big, count = kernels.packed_cover(fields, tris, W, H, survivors=survivors)
    p_winner, p_big, p_count = packed.cover_plain(fields, tris, W, H, stats)
    k = int(count[0])
    err = {"vf_packed_cover": int((winner - p_winner).abs().max())}
    if err["vf_packed_cover"] or k != int(p_count[0]) \
            or not torch.equal(torch.sort(big[:k]).values, p_big[:k]):
        raise AssertionError(f"{label}: vf_packed_cover differs from its plain version")
    kept = check_survivors(survivors, stats, label, "vf_packed_cover")
    walked = torch.full_like(big, -1)
    kernels.packed_cover_big(fields, tris, winner, big, count, walked)
    packed.cover_big_plain(fields, tris, p_winner, p_big, p_count)
    err["vf_packed_cover_big"] = int((winner - p_winner).abs().max())
    if err["vf_packed_cover_big"]:
        raise AssertionError(f"{label}: vf_packed_cover_big differs from its plain version")
    want, walk = big_walk_work(lambda f, t: packed.tri_corners(fields, tris, f, t),
                               tris.shape[0], p_big, p_count)
    check_walk_counts(big, count, walked, p_big, want, label, "vf_packed_cover_big")
    got = kernels.packed_resolve_gbuffer(fields, tris, winner)
    want = packed.resolve_gbuffer_plain(fields, tris, winner)
    err["vf_packed_resolve_gbuffer"] = assert_gbuffer_close(got, want, label)
    sync()
    return err, k, all(torch.equal(a, b) for a, b in zip(got, want)), walk, kept


def w_crossing_valid_indexed(fields, tris):
    """Valid triangles with a vertex at w <= eps (full-screen bboxes)."""
    corners = setup.indexed_corners([fields[:, f] for f in range(vtx.FIELDS)], tris)
    valid = setup.setup_fields_core(*corners, W, H)[5]
    clean = (corners[0][2] > 1e-8) & (corners[1][2] > 1e-8) & (corners[2][2] > 1e-8)
    return int((valid & ~clean).sum())


def phase2c_packed_kernels(dev):
    """The indexed kernels against their plain versions at 800x600;
    returns each kernel's max error over the cases."""
    small = make_renderer(DEM_CHECK, dev, seed=2)
    xyuv, tris, heights, _, _ = renderer_frame(small)
    close, wcross = (tuple(tensor(a[i:i + 1], dev) for a in special_dem_cameras(small))
                     for i in (0, 1))
    cut_cam = tuple(tensor(a, dev) for a in near_cut_dem_camera(small))
    cases = [(f"DEM-{DEM_CHECK} default camera", renderer_frame(small)),
             (f"DEM-{DEM_CHECK} close-in", (xyuv, tris, heights, *close)),
             (f"DEM-{DEM_CHECK} w-crossing", (xyuv, tris, heights, *wcross)),
             (f"DEM-{DEM_CHECK} near-cut", (xyuv, tris, heights, *cut_cam)),
             ("soup 50K", soup_frame(dev)),
             (f"DEM-{DEM_MAIN} default camera",
              renderer_frame(make_renderer(DEM_MAIN, dev, seed=3)))]
    errs, listed, bit_equal, walks, kept, cut = {}, {}, {}, {}, {}, {}
    for label, (xyuv, tris, heights, views, projs) in cases:
        fields = frame_fields(xyuv, heights, views, projs)
        if "w-crossing" in label and w_crossing_valid_indexed(fields, tris) == 0:
            raise AssertionError(f"{label}: no valid triangle crosses w = 0")
        if "near-cut" in label:
            cut[label] = near_cut_valid(
                setup.indexed_corners([fields[:, f] for f in range(vtx.FIELDS)], tris))
            if cut[label] == 0:
                raise AssertionError(f"{label}: the near plane cuts no valid triangle")
        err, listed[label], bit_equal[label], walks[label], kept[label] = check_packed_passes(
            fields, tris, f"{label} {W}x{H}")
        for name, e in err.items():
            errs[name] = max(errs.get(name, 0.0), float(e))
        del fields
    for label in (f"DEM-{DEM_CHECK} close-in", f"DEM-{DEM_CHECK} w-crossing"):
        if listed[label] == 0:
            raise AssertionError(f"{label}: the big-triangle pass got no triangle")

    # Two independent kernels on 4c's first loaded pair (close-in +
    # w-crossing at DEM-2048): the indexed g-buffer against the record
    # route's.
    main = make_renderer(DEM_MAIN, dev)
    xyuv, tris, heights, views, projs = renderer_frame(main, *special_dem_cameras(main))
    got = packed.render_gbuffer_packed_batch(frame_fields(xyuv, heights, views, projs),
                                             tris, W, H)
    want = record_gbuffer(xyuv, tris.long(), heights, views, projs)
    label = f"DEM-{DEM_MAIN} close-in + w-crossing vs record route"
    assert_gbuffer_close(got, want, label)
    bit_equal[label] = all(torch.equal(a, b) for a, b in zip(got, want))
    if not bit_equal[label]:
        raise AssertionError(f"{label}: the indexed g-buffer is not the record route's")
    del main, xyuv, tris, heights, got, want
    torch.cuda.empty_cache()
    say("packed_kernel_vs_plain", tolerance=f"winners and lists exact; masks exact; varyings "
        f"<= {VARYING_RTOL}*max(1,|x|); big-pass walk counts equal the mirror's; survivors "
        "equal the plain count", cases=[c[0] for c in cases], max_err=errs, big_listed=listed,
        big_walk=walks, survivors=kept, near_cut_straddling_valid=cut,
        gbuffer_bit_equal=bit_equal)
    return errs


def phase3c_renderer_main_path(dev):
    """Slice 3's main path: the Renderer on the card at DEM-2048 and at the
    3601^2 SRTM tile; returns the launch counts."""
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, f"renderer_dem{DEM_MAIN}_{W}x{H}.png")
    main = make_renderer(DEM_MAIN, dev)
    srtm = make_renderer(SRTM, dev, seed=1)
    every = PACKED_KERNELS + VTX_KERNELS + RECORD_KERNELS
    for _, fn in every:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    frame = main.render_rgba()
    main.render_png(png)
    metrics = main.render_metrics()
    sync()
    peak_main = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    frame_srtm = srtm.render_rgba()
    sync()
    peak_srtm = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in every}
    for name, _ in PACKED_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"slice 3's main path never launched {name}")
    for name, _ in VTX_KERNELS + RECORD_KERNELS:
        if launches[name] != 0:
            raise AssertionError(f"slice 3's main path launched {name}")

    if set(metrics) != {"render_ms", "readback_ms", "total_ms", "bytes", "width", "height"} \
            or not metrics["render_ms"] > 0 or metrics["bytes"] != W * H * 4:
        raise AssertionError(f"render_metrics not filled in: {metrics}")
    if not np.array_equal(png_pixels(png), frame):
        raise AssertionError("PNG does not round-trip the Renderer's pixels")
    clear = np.array([39, 39, 48], np.uint8)    # the clear colour in sRGB u8
    covered = {}
    for label, img in ((f"DEM-{DEM_MAIN}", frame), (f"DEM-{SRTM}", frame_srtm)):
        if img.dtype != np.uint8 or img.shape != (H, W, 4):
            raise AssertionError(f"{label}: bad image {img.dtype} {img.shape}")
        covered[label] = float((img[..., :3] != clear).any(-1).mean())
        if covered[label] < 0.2:
            raise AssertionError(f"{label}: the terrain covers {covered[label]:.3f} of the frame")

    # Two independent kernels on each frame: the indexed route's g-buffer
    # against the record route's, on the card.
    vs_record = {}
    for label, r in ((f"DEM-{DEM_MAIN}", main), (f"DEM-{SRTM}", srtm)):
        xyuv, tris, heights, views, projs = renderer_frame(r)
        got = packed.render_gbuffer_packed_batch(frame_fields(xyuv, heights, views, projs),
                                                 tris, W, H)
        n_tris = tris.shape[0]
        need = 492 * n_tris          # record-route bytes per triangle at peak (H100, g1024 x4)
        free = torch.cuda.mem_get_info()[0]
        if need > 0.8 * free:
            vs_record[label] = {"skipped": f"needs ~{need} B, {free} B free"}
            continue
        torch.cuda.reset_peak_memory_stats()
        want = record_gbuffer(xyuv, tris.long(), heights, views, projs)
        sync()
        vs_record[label] = {
            "triangles": n_tris,
            "gbuffer_bit_equal": all(torch.equal(a, b) for a, b in zip(got, want)),
            "gbuffer_max_abs_err": assert_gbuffer_close(got, want, f"{label}: indexed vs record"),
            "record_route_peak_bytes": int(torch.cuda.max_memory_allocated())}
        if not vs_record[label]["gbuffer_bit_equal"]:
            raise AssertionError(f"{label}: the indexed g-buffer is not the record route's")
        del got, want, xyuv, tris
        torch.cuda.empty_cache()

    small = {d: make_renderer(DEM_CHECK, d, seed=4).render_rgba() for d in (dev, "cpu")}
    parity = assert_fs_policy(small[dev], small["cpu"], f"DEM-{DEM_CHECK} cuda vs cpu")
    say("renderer_main_path", config=f"Renderer({W},{H}); add_terrain(DEM n x n, {DEM_SPACING}, "
        f"{DEM_EXAG}, 'terrain'); upload_height_r32f; set_sun(35,120); set_exposure(1.1); "
        f"render_rgba + render_png at n={DEM_MAIN}, render_rgba at n={SRTM}",
        launches=launches, render_metrics=metrics, covered_share=covered,
        peak_bytes={f"DEM-{DEM_MAIN}": int(peak_main), f"DEM-{SRTM}": int(peak_srtm)},
        vs_record_route=vs_record,
        small_cuda_vs_cpu={"dem": DEM_CHECK, "max_byte_delta": parity[0],
                           "frac_bytes_differ": parity[1]},
        sha256={f"DEM-{DEM_MAIN}": hashlib.sha256(frame.tobytes()).hexdigest(),
                f"DEM-{SRTM}": hashlib.sha256(frame_srtm.tobytes()).hexdigest()})
    return launches


def packed_bounds(fields, tris, winner, big, count, covered_big):
    """bound_ms of each indexed kernel on these inputs, counted from this
    run's data: the cover pass's as cover_bound counts it, with the
    indices read once and the winner plane written once (its former bound
    beside it as full_setup_bound_ms); the listed triangles' indices and
    distinct vertices, their setup and their covered_big (triangle, pixel)
    pairs (cover_big; its bound over every bbox pixel beside it as
    bbox_bound_ms); the winner plane, the winners' indices and distinct
    vertices, the g-buffer written (resolve; its sector_bound_ms charges
    instead the 32-byte sectors of the index buffer and of the 6 field
    planes a resolve reads that the winners touch,
    packed.resolve_sectors)."""
    B, T = fields.shape[0], tris.shape[0]
    valid, area, small, straddling = cover_work(
        setup.indexed_corners([fields[:, f] for f in range(vtx.FIELDS)], tris))
    pairs_small = int(area[small].sum())
    bbox_pairs = int(area[valid & ~small].sum())
    survivors = int(small.sum())
    listed = int(count[0])
    pixels = B * H * W
    covered = int((winner > 0).sum())
    frame = torch.arange(B, device=winner.device)[:, None, None]
    won = torch.unique((frame * T + winner - 1)[winner > 0])
    nv = fields.shape[2]

    def distinct_vertices(entries):
        f, tri = torch.div(entries, T, rounding_mode="floor"), entries % T
        return int(torch.unique(f[:, None] * nv + tris[tri].long()).numel())
    vertex_bytes = vtx.FIELDS * 4
    listed_bytes = listed * 16 + 4 + distinct_vertices(big[:listed].to(torch.long)) * vertex_bytes
    cover, full_setup = cover_bound(B * nv * POSITION_FIELDS * 4,
                                    tris.numel() * 4 + pixels * 4 + listed * 4 + 4,
                                    fields.numel() * 4, B * T, survivors, straddling,
                                    pairs_small)
    work = {
        "vf_packed_cover_big": (listed_bytes + min(covered_big, pixels) * 8,
                                listed * SETUP_OPS + covered_big * COVER_OPS),
        "vf_packed_resolve_gbuffer": (pixels * 4 + won.numel() * 12
                                      + distinct_vertices(won) * vertex_bytes + pixels * 13,
                                      covered * (SETUP_OPS + EVAL_OPS) + pixels * RESOLVE_OPS),
    }
    bbox_bound = bound_of(listed_bytes + min(bbox_pairs, pixels) * 8,
                          listed * SETUP_OPS + bbox_pairs * COVER_OPS)["bound_ms"]
    sectors = packed.resolve_sectors(fields, tris, winner)
    out = {"vf_packed_cover": cover, **{name: bound_of(*w) for name, w in work.items()}}
    out["vf_packed_resolve_gbuffer"]["sector_bound_ms"] = bound_of(
        pixels * 4 + sectors * vtx.SECTOR_BYTES + pixels * 13,
        work["vf_packed_resolve_gbuffer"][1])["bound_ms"]
    data = {"triangles": B * T, "valid": int(valid.sum()), "survivors": survivors,
            "survivor_share": survivors / (B * T), "straddling_edges": straddling,
            "pairs_small": pairs_small, "full_setup_bound_ms": full_setup,
            "listed": listed, "bbox_pairs": bbox_pairs, "covered_big_pairs": covered_big,
            "bbox_bound_ms": bbox_bound, "covered_pixels": covered,
            "distinct_winners": int(won.numel()), "resolve_sectors": sectors}
    return out, data


def packed_route_fns(r, dev):
    """Both routes over a Renderer's default frame, mesh and texture on the
    card (as the Renderer keeps them), each returning the (1, H, W) u32
    image: the indexed route (the pipeline) and the record route (its
    stages composed with the same extended shader)."""
    xyuv, tris, heights, views, projs = renderer_frame(r)
    tris64 = tris.long()
    g, meta = r._globals, r._terrain_meta
    lut, _ = _colormap.build_lut(r._terrain.colormap)
    shade = dict(lut=lut, h_min=meta.h_min, h_max=meta.h_max, exposure=g.exposure,
                 sun_dir=g.sun_dir)
    t = {k: tensor(v, dev) for k, v in shade.items()}
    nsp = tensor(DEM_SPACING[0], dev)

    def indexed():
        return pipeline.render_terrain_batch_u32(
            xyuv, tris, heights, views, projs, spacing=1.0, exaggeration=1.0,
            normal_spacing=DEM_SPACING[0], width=W, height=H, fs_mode="extended",
            device=dev, **shade)

    def record():
        gbuf = record_gbuffer(xyuv, tris64, heights, views, projs)
        return fragment.terrain_fs_extended(*gbuf, t["lut"], heights, t["h_min"], t["h_max"],
                                            t["exposure"], t["sun_dir"], nsp, tensor(1.0, dev))
    return {"record": record, "indexed": indexed}


def compare_dem_routes(r, dev, reps=REPS):
    """Host ms per frame of each route (record, indexed, indexed, record;
    ``reps`` timed calls each after a warm-up), and their images."""
    fns = packed_route_fns(r, dev)
    times = {"record": [], "indexed": []}
    for name in ("record", "indexed", "indexed", "record"):
        fns[name]()
        sync()
        times[name] += host_ms(fns[name], [()] * reps)
    return {k: statistics.median(v) for k, v in times.items()}, times, fns


def phase4c_packed_timing(smi, dev):
    """Slice 3's times; returns the per-kernel record (ms, plain_ms, bound)."""
    # Single-frame latency of render_rgba() (readback included), 20 calls
    # after a warm-up call that builds the mesh; render_metrics beside it.
    latency = {}
    for n in LATENCY_DEMS:
        r = make_renderer(n, dev)
        r.render_rgba()
        times, render, readback = [], [], []
        for _ in range(20):
            t0 = time.perf_counter()
            r.render_rgba()
            times.append((time.perf_counter() - t0) * 1e3)
            m = r.render_metrics()
            render.append(m["render_ms"])
            readback.append(m["readback_ms"])
        q = np.percentile(times, [50, 80])
        latency[f"DEM-{n}"] = {"median_ms": float(q[0]), "p80_ms": float(q[1]), "n": len(times),
                               "render_ms_median": statistics.median(render),
                               "readback_ms_median": statistics.median(readback),
                               "triangles": 2 * (n - 1) ** 2}
        del r
    torch.cuda.empty_cache()

    # Stages of one DEM-2048 frame (CUDA events), 5 frames after a warm-up.
    r = make_renderer(DEM_MAIN, dev)
    terr, meta, g = r._terrain, r._terrain_meta, r._globals
    lut = tensor(_colormap.build_lut(terr.colormap)[0], dev)
    names = ("mesh_build_upload", "vertex_stage", "vf_packed_cover", "vf_packed_cover_big",
             "vf_packed_resolve_gbuffer", "extended_shader", "readback")
    rows = []
    for _ in range(REPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        xyuv, tris = _renderer.grid_mesh(terr.width, terr.height, *terr.spacing, dev)
        ev[1].record()
        _, _, heights, views, projs = renderer_frame(r)
        fields = frame_fields(xyuv, heights, views, projs)
        ev[2].record()
        w_, b_, c_ = kernels.packed_cover(fields, tris, W, H)
        ev[3].record()
        kernels.packed_cover_big(fields, tris, w_, b_, c_)
        ev[4].record()
        gbuf = kernels.packed_resolve_gbuffer(fields, tris, w_)
        ev[5].record()
        img = fragment.terrain_fs_extended(
            *gbuf, lut, heights, tensor(meta.h_min, dev), tensor(meta.h_max, dev),
            tensor(g.exposure, dev), tensor(g.sun_dir, dev), tensor(DEM_SPACING[0], dev),
            tensor(1.0, dev))
        ev[6].record()
        _formats.u32_image_to_rgba_u8(img[0]).cpu().numpy()
        ev[7].record()
        sync()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
    split = {n: statistics.median(row[i] for row in rows[1:]) for i, n in enumerate(names)}
    del fields, w_, b_, gbuf, img

    # Each indexed kernel and its plain version at the main path's shape
    # (DEM-2048, 800x600, one frame), 5 cameras turned about the DEM's
    # axis (20 back-to-back launches each); medians.
    runs = {name: {"ms": [], "plain_ms": [], "bound_ms": []} for name, _ in PACKED_KERNELS}
    for k in range(REPS):
        xyuv, tris, heights, views, projs = renderer_frame(r, *turned_cameras(r, k))
        fields = frame_fields(xyuv, heights, views, projs)
        winner, big, count = kernels.packed_cover(fields, tris, W, H)
        kernels.packed_cover_big(fields, tris, winner, big, count)
        stats = {}
        per = {
            "vf_packed_cover": (lambda: kernels.packed_cover(fields, tris, W, H),
                                lambda: packed.cover_plain(fields, tris, W, H)),
            "vf_packed_cover_big": (
                lambda: kernels.packed_cover_big(fields, tris, winner, big, count),
                lambda: packed.cover_big_plain(fields, tris, winner.clone(), big, count,
                                               stats)),
            "vf_packed_resolve_gbuffer": (
                lambda: kernels.packed_resolve_gbuffer(fields, tris, winner),
                lambda: packed.resolve_gbuffer_plain(fields, tris, winner)),
        }
        for name, (kern, plain) in per.items():
            runs[name]["ms"].append(cuda_ms(kern, reps=1, inner=KERNEL_INNER))
            runs[name]["plain_ms"].append(cuda_ms(plain, reps=1, warmup=1))
        bounds, default_work = packed_bounds(fields, tris, winner, big, count,
                                             stats["covered_pairs"])
        for name in per:
            runs[name]["bound_ms"].append(bounds[name]["bound_ms"])
        for name in RESOLVES & per.keys():
            runs[name].setdefault("device_ms", []).append(
                kernel_device_ms(per[name][0], key="resolve_kernel"))
            runs[name].setdefault("sector_bound_ms", []).append(
                bounds[name]["sector_bound_ms"])
        for key in ("full_setup_bound_ms", "survivor_share"):
            runs["vf_packed_cover"].setdefault(key, []).append(default_work[key])
        del fields, winner, big
    rec = {}
    for name, run in runs.items():
        rec[name] = {k: statistics.median(v) for k, v in run.items()}
        rec[name]["bound_by"] = bounds[name]["bound_by"]
        rec[name]["all"] = run

    # The big-triangle pass under load: a close-in + w-crossing pair at
    # DEM-2048, 5 turned sets. The kernels line reports vf_packed_cover_big
    # here (at the default camera its list is near empty).
    rec["vf_packed_cover_big_default"] = rec["vf_packed_cover_big"]
    loaded = {"ms": [], "plain_ms": [], "bound_ms": []}
    loaded_work = []
    for k in range(REPS):
        xyuv, tris, heights, views, projs = renderer_frame(
            r, *special_dem_cameras(r, turn=0.1 * k))
        fields = frame_fields(xyuv, heights, views, projs)
        if w_crossing_valid_indexed(fields, tris) == 0:
            raise AssertionError("loaded case: no valid triangle crosses w = 0")
        corners_of = lambda f, t: packed.tri_corners(fields, tris, f, t)
        kern = lambda w, b, c, walked=None: kernels.packed_cover_big(fields, tris, w, b, c,
                                                                     walked)
        plain = lambda w, st=None: packed.cover_big_plain(fields, tris, w, big, count, st)
        winner, big, count = kernels.packed_cover(fields, tris, W, H)
        _, p_big, p_count = packed.cover_plain(fields, tris, W, H)
        # The plain pass takes ~8 s on an H100: its first call, timed alone,
        # is the measurement.
        data, bounds = loaded_big_pass(f"loaded set {k}", "vf_packed_cover_big", kern, plain,
                                       corners_of, tris.shape[0], winner, big, count, p_big,
                                       p_count,
                                       lambda cov: packed_bounds(fields, tris, winner, big,
                                                                 count, cov), warmup=0)
        for key in loaded:
            loaded[key].append(data[key])
        loaded_work.append(data)
        del fields, winner, big, p_big
    rec["vf_packed_cover_big"] = {k: statistics.median(v) for k, v in loaded.items()}
    rec["vf_packed_cover_big"].update(bound_by=bounds["vf_packed_cover_big"]["bound_by"],
                                      all=loaded)
    torch.cuda.empty_cache()

    # Both routes on the DEM-2048 frame: time and peak device memory.
    routes, routes_all, fns = compare_dem_routes(r, dev)
    peaks = {}
    for name, fn in fns.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        img = fn()
        sync()
        peaks[name] = {"peak_bytes": int(torch.cuda.max_memory_allocated()),
                       "above_resident_bytes": int(torch.cuda.max_memory_allocated() - base)}
        peaks[name]["image"] = img
    same = torch.equal(peaks["record"].pop("image"), peaks["indexed"].pop("image"))
    if not same:
        raise AssertionError("DEM-2048: the two routes' images differ")
    del r, fns
    torch.cuda.empty_cache()

    # Route sweep: one Renderer frame per DEM size on both routes.
    sweep = {}
    for n in SWEEP_DEMS:
        med, _, _ = compare_dem_routes(make_renderer(n, dev, seed=5), dev, reps=3)
        sweep[f"DEM-{n}"] = {"triangles": 2 * (n - 1) ** 2, **med}
    torch.cuda.empty_cache()
    say("packed_timing", card=smi, config=f"Renderer({W},{H}), DEM n x n, 30 m, x1.5",
        single_frame=latency, budget_ms={"render": 50.0, "readback": 30.0,
                                         "source": "BASELINE.md:9-10, DEM-1024"},
        dem2048_stage_ms=split, kernel_ms=rec, work=default_work,
        loaded_config=f"DEM-2048, {W}x{H}, close-in + w-crossing pair, 5 turned sets",
        loaded_work=loaded_work, dem2048_route_ms_median=routes, dem2048_route_ms_all=routes_all,
        dem2048_route_peak=peaks, routes_images_equal=same, route_sweep_ms=sweep,
        indexed_faster_at_every_sweep_point=all(v["indexed"] < v["record"]
                                                for v in sweep.values()))
    return rec


# ---------------- slice 4: the hardware fill rule (VF_FILL_RULE=hw) ----------------

HW_KERNELS = (("vf_raster_gbuffer_hw", kernels.raster_gbuffer_hw),
              ("vf_raster_shade_shipped_hw", kernels.raster_shade_shipped_hw))
QUAD_W, QUAD_H = 128, 96                   # tests/test_fillrule.py:23


def restore_fill_rule(previous):
    """Put VF_FILL_RULE back as it was before a phase set it."""
    if previous is None:
        os.environ.pop("VF_FILL_RULE", None)
    else:
        os.environ["VF_FILL_RULE"] = previous


def grid16_scene():
    """The grid-16 160x120 scene of tests/test_packed.py:261-283: clip
    coordinates and (h, x, z) varyings from numpy, draw-order indices."""
    w, h = 160, 120
    xyuv, idx = _mesh.build_grid_xyuv(16)
    x, z = xyuv[:, 0], xyuv[:, 1]
    ht = np.sin(x * 1.3) * 0.25 + np.cos(z * 1.1) * 0.25
    view = _camera.look_at_rh((3.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    proj = _camera.perspective_wgpu(np.float32(math.radians(45.0)), np.float32(w / h),
                                    np.float32(0.1), np.float32(100.0))
    clip = (np.stack([x, ht, z, np.ones_like(x)], axis=-1) @ view.T) @ proj.T
    return clip, np.stack([ht, x, z], axis=-1), idx.astype(np.int64).reshape(-1, 3), w, h


def watertight_quad():
    """Two front-facing triangles tiling a quad whose corners and shared
    diagonal lie on pixel centres (tests/test_fillrule.py:51-79), for a
    QUAD_W x QUAD_H frame."""
    def ndc(px, py):
        return (2 * (px + 0.5) / QUAD_W - 1, 1 - 2 * (py + 0.5) / QUAD_H)
    quad = [ndc(10, 10), ndc(70, 10), ndc(70, 70), ndc(10, 70)]
    clip = np.array([[x, y, 0.5, 1.0] for x, y in quad], np.float32)
    return clip, np.ones((4, 3), np.float32), np.array([[0, 2, 1], [0, 3, 2]], np.int64)


def hw_records(clip, vary, indices, width, height, dev):
    """(records, binning) of clip coordinates set up under the hw rule."""
    x, y, z, w = setup.clip_to_fb(tensor(clip, dev), width, height)
    records, bbox = setup.triangle_setup(
        x, y, z, w, tensor(vary, dev), torch.as_tensor(indices, device=dev), width, height,
        "hw")
    return records.reshape(-1, setup.REC_WIDTH), setup.bin_tiles(bbox, width, height)


def phase2d_hw_kernels(dev):
    """Both hw kernels against their plain versions over hw records: the
    grid-16 scene (its mask against the int64 oracle), the spike g128, a
    w-crossing camera, the main path's triangle, spike g1024 and Renderer
    DEM-2048 frames, the watertight quad (every interior pixel covered
    once).
    Returns each kernel's max error."""
    shade = spike_shading(dev)
    errs = {name: 0.0 for name, _ in HW_KERNELS}
    plain_ms, items = {}, {}

    def check(label, records, binning, width, height):
        kern, items[label] = walked(kernels.raster_gbuffer_hw, records, binning, 1, width,
                                    height)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = tiles.render_gbuffer(records, binning, 1, width, height)
        end.record()
        end.synchronize()
        plain_ms[label] = start.elapsed_time(end)
        errs["vf_raster_gbuffer_hw"] = max(errs["vf_raster_gbuffer_hw"], assert_gbuffer_close(
            kern, plain, f"{label}: vf_raster_gbuffer_hw"))
        img, n = walked(kernels.raster_shade_shipped_hw, records, binning, 1, width, height,
                        *shade)
        if n != items[label]:
            raise AssertionError(f"{label}: the hw kernels walked {items[label]} and {n} items")
        d, _ = assert_fs_policy(img, fragment.terrain_fs(*plain, *shade),
                                f"{label}: vf_raster_shade_shipped_hw")
        errs["vf_raster_shade_shipped_hw"] = max(errs["vf_raster_shade_shipped_hw"], float(d))
        sync()
        return kern[3][0]

    clip, vary, idx, w, h = grid16_scene()
    mask = check("grid-16 160x120", *hw_records(clip, vary, idx, w, h, dev), w, h)
    wid, _ = hw_oracle.rasterize_hw(clip, vary, idx, w, h)
    if not np.array_equal(mask.cpu().numpy(), wid >= 0):
        raise AssertionError("grid-16 160x120: the hw coverage is not the int64 oracle's")
    grid16 = {"covered": int(mask.sum()), "oracle_covered": int((wid >= 0).sum())}

    records, binning, _ = scene_inputs(vt.make_terrain(W, H, GRID, device="cpu"), dev, "hw")
    check(f"spike {W}x{H} g{GRID}", records, binning, W, H)

    views, projs = (a[1:] for a in special_cameras(W, H))
    crossing = w_crossing_valid(grid_fields(256, views, projs, dev), 256)
    if crossing == 0:
        raise AssertionError("g256 w-crossing: no valid triangle crosses w = 0")
    check(f"g256 w-crossing {W}x{H}", *record_route(256, views, projs, dev, "hw"), W, H)

    # The main path's shapes (phase 3d): the triangle (whose edge products
    # lie far outside the range where the snapped edge functions are
    # exact), the g1024 spike frame and the Renderer's DEM-2048 frame
    # (extended vertex stage) under hw.
    check(f"triangle {W}x{H}", *pipeline.triangle_records(W, H, dev, "hw"), W, H)
    records, binning, _ = scene_inputs(vt.make_terrain(W, H, VGRID, device="cpu"), dev, "hw")
    check(f"spike {W}x{H} g{VGRID}", records, binning, W, H)
    del records, binning
    xyuv, tris, heights, views, projs = renderer_frame(make_renderer(DEM_MAIN, dev))
    one = tensor(1.0, dev)
    check(f"Renderer {W}x{H} DEM-{DEM_MAIN}", *pipeline.terrain_records(
        xyuv, tris.long(), heights, views, projs, one, one, W, H, fs_mode="extended",
        fill_rule="hw"), W, H)
    del xyuv, tris, heights
    torch.cuda.empty_cache()

    clip, vary, idx = watertight_quad()
    count = sum(kernels.raster_gbuffer_hw(*hw_records(clip, vary, tri[None], QUAD_W, QUAD_H, dev),
                                          1, QUAD_W, QUAD_H)[3][0].to(torch.int32)
                for tri in idx)
    both = check("watertight quad", *hw_records(clip, vary, idx, QUAD_W, QUAD_H, dev),
                 QUAD_W, QUAD_H)
    interior = count[12:69, 12:69]
    if int(count.max()) > 1 or not bool((interior == 1).all()) or not torch.equal(both, count == 1):
        raise AssertionError(f"watertight quad: a pixel is covered {int(count.max())} times "
                             f"or an interior pixel is missed")
    say("hw_kernel_vs_plain", tolerance=f"masks exact; varyings <= {VARYING_RTOL}*max(1,|x|); "
        f"images: bytes off by <= 1 on <= {FS_MAX_FRACTION} of bytes; grid-16 mask equal to "
        "hw_oracle; evaluated equal to tiles.tile_work", cases=list(plain_ms),
        plain_ms=plain_ms, evaluated_items=items,
        max_err=errs, grid16=grid16, w_crossing_valid=crossing,
        quad={"max_cover": int(count.max()), "interior_pixels": int(interior.numel()),
              "covered_once": int((count == 1).sum())})
    return errs


def phase3d_hw_main_path(dev):
    """Slice 4's main path under VF_FILL_RULE=hw, set here and restored
    after: render_triangle_rgba(800,600), make_terrain(800,600,1024) and the
    Renderer at DEM-2048. Only the hw kernels may launch; a small Scene
    and the triangle are held to device="cpu". Returns the launch counts."""
    spike = vt.make_terrain(W, H, VGRID, device=dev)
    main = make_renderer(DEM_MAIN, dev)
    every = HW_KERNELS + RECORD_KERNELS + VTX_KERNELS + PACKED_KERNELS
    previous = os.environ.get("VF_FILL_RULE")
    os.environ["VF_FILL_RULE"] = "hw"
    try:
        for _, fn in every:
            fn.launches = 0
        out = {f"triangle_{W}x{H}": vt.render_triangle_rgba(W, H, device=dev),
               f"spike_{W}x{H}_g{VGRID}": spike.render_rgba(),
               f"renderer_{W}x{H}_dem{DEM_MAIN}": main.render_rgba()}
        sync()
        launches = {name: fn.launches for name, fn in every}
        scene = {}
        for d in (dev, "cpu"):
            s = vt.Scene(160, 120, 32, "magma", device=d)
            s.set_height_from_r32f(scene_height())
            scene[str(d)] = s.render_rgba()
        cpu_triangle = vt.render_triangle_rgba(W, H, device="cpu")
        os.environ["VF_FILL_RULE"] = "inclusive"
        inclusive = {f"triangle_{W}x{H}": vt.render_triangle_rgba(W, H, device=dev),
                     f"spike_{W}x{H}_g{VGRID}": spike.render_rgba(),
                     f"renderer_{W}x{H}_dem{DEM_MAIN}": main.render_rgba()}
    finally:
        restore_fill_rule(previous)
    for name, _ in HW_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"slice 4's main path never launched {name}")
    for name, _ in RECORD_KERNELS + VTX_KERNELS + PACKED_KERNELS:
        if launches[name] != 0:
            raise AssertionError(f"slice 4's main path launched {name}")
    # The three frames' hw records again, with the kernels' evaluated items
    # held to the mirror's (after the launch counts were read).
    xyuv, tris, heights, views, projs = renderer_frame(main)
    one = tensor(1.0, dev)
    items = {f"triangle_{W}x{H}": walked(kernels.raster_gbuffer_hw,
                                         *pipeline.triangle_records(W, H, dev, "hw"),
                                         1, W, H)[1]}
    records, binning, shade = scene_inputs(vt.make_terrain(W, H, VGRID, device="cpu"), dev,
                                           "hw")
    items[f"spike_{W}x{H}_g{VGRID}"] = walked(kernels.raster_shade_shipped_hw, records,
                                              binning, 1, W, H, *shade)[1]
    records, binning = pipeline.terrain_records(xyuv, tris.long(), heights, views, projs, one,
                                                one, W, H, fs_mode="extended", fill_rule="hw")
    items[f"renderer_{W}x{H}_dem{DEM_MAIN}"] = walked(kernels.raster_gbuffer_hw, records,
                                                      binning, 1, W, H)[1]
    del records, binning, xyuv, tris
    torch.cuda.empty_cache()
    parity = {"scene_magma_160x120_g32": assert_fs_policy(scene[str(dev)], scene["cpu"],
                                                          "hw Scene cuda vs cpu"),
              f"triangle_{W}x{H}": assert_fs_policy(out[f"triangle_{W}x{H}"], cpu_triangle,
                                                    "hw triangle cuda vs cpu")}
    # The rule moves only pixels whose centres lie on an edge: a terrain
    # frame's covered share (pixels off the clear colour) stays within 1% of
    # the inclusive frame's.
    clear = np.array([39, 39, 48], np.uint8)    # the terrain's clear colour in sRGB u8
    covered, differ = {}, {}
    for name, img in out.items():
        if img.dtype != np.uint8 or img.shape != (H, W, 4):
            raise AssertionError(f"{name}: bad image {img.dtype} {img.shape}")
        differ[name] = float((img != inclusive[name]).any(-1).mean())
        if not name.startswith("triangle"):
            share = [float((a[..., :3] != clear).any(-1).mean()) for a in (img, inclusive[name])]
            covered[name] = {"hw": share[0], "inclusive": share[1]}
            if share[0] < 0.1 or abs(share[0] - share[1]) > 0.01:
                raise AssertionError(f"{name}: the terrain covers {share[0]:.4f} of the frame "
                                     f"under hw, {share[1]:.4f} under inclusive")
    say("hw_main_path", config=f"VF_FILL_RULE=hw: render_triangle_rgba({W},{H}); "
        f"make_terrain({W},{H},{VGRID}).render_rgba(); Renderer({W},{H}) DEM-{DEM_MAIN} "
        "render_rgba", launches=launches, evaluated_items=items, covered_share=covered,
        pixels_differing_from_inclusive=differ,
        cuda_vs_cpu={k: {"max_byte_delta": v[0], "frac_bytes_differ": v[1]}
                     for k, v in parity.items()},
        sha256={k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in out.items()})
    return launches


def kernel_turns(inclusive, hw):
    """Per-launch ms of an inclusive kernel call and its hw counterpart,
    timed in turns (inclusive, hw, hw, inclusive; each a median of 5 runs of
    20 back-to-back launches); the mean of each one's two turns."""
    times = {"inclusive": [], "hw": []}
    for rule in ("inclusive", "hw", "hw", "inclusive"):
        times[rule].append(cuda_ms(inclusive if rule == "inclusive" else hw, inner=KERNEL_INNER))
    return {k: statistics.mean(v) for k, v in times.items()}, times


def phase4d_hw_timing(smi, dev):
    """Slice 4's times: each 3d frame under hw against inclusive (median
    and p80 of 20 calls, peak device memory), and each hw kernel per launch
    against its inclusive counterpart and its bound. Returns the per-kernel
    record of the kernels line."""
    spike = vt.make_terrain(W, H, VGRID, device=dev)
    main = make_renderer(DEM_MAIN, dev)
    frames = {f"triangle {W}x{H}": lambda: vt.render_triangle_rgba(W, H, device=dev),
              f"spike {W}x{H} g{VGRID}": spike.render_rgba,
              f"Renderer {W}x{H} DEM-{DEM_MAIN}": main.render_rgba}
    latency = {}
    previous = os.environ.get("VF_FILL_RULE")
    try:
        for label, fn in frames.items():
            times, peak = {"inclusive": [], "hw": []}, {}
            for rule in ("inclusive", "hw", "hw", "inclusive"):
                os.environ["VF_FILL_RULE"] = rule
                fn()
                sync()
                if rule not in peak:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    fn()
                    sync()
                    top = torch.cuda.max_memory_allocated()
                    peak[rule] = {"peak_bytes": int(top), "above_resident_bytes": int(top - base)}
                times[rule] += host_ms(fn, [()] * 10)
            latency[label] = {}
            for rule, t in times.items():
                q = np.percentile(t, [50, 80])
                latency[label][rule] = {"median_ms": float(q[0]), "p80_ms": float(q[1]),
                                        "n": len(t), **peak[rule]}
    finally:
        restore_fill_rule(previous)
    del frames
    torch.cuda.empty_cache()

    # Where the g1024 hw frame's time goes (host clock after a synchronize,
    # median of 5): the mesh's copy to the card, which the record route
    # makes every frame, setup and binning, the kernel, the readback.
    g = spike._globals
    t = lambda a: tensor(a, dev)
    mesh = lambda: (pipeline._f32(spike._xyuv, dev), pipeline._tri_indices(spike._indices, dev))
    xyuv, tris = mesh()
    records = lambda: pipeline.terrain_records(
        xyuv, tris, t(spike._heights), t(spike._view)[None], t(spike._proj)[None],
        t(g.spacing), t(g.exaggeration), W, H, fill_rule="hw")
    rb = records()
    kern = lambda: kernels.raster_shade_shipped_hw(
        *rb, 1, W, H, t(spike._lut), t(g.h_max) - t(g.h_min), t(g.exposure), t(g.sun_dir))
    img = kern()
    stages = {name: statistics.median(host_ms(fn, [()] * 5)) for name, fn in (
        ("mesh_to_device", mesh), ("setup_and_binning", records), ("kernel", kern),
        ("readback", lambda: _formats.u32_image_to_rgba_u8(img[0]).cpu()))}
    del xyuv, tris, rb, img
    torch.cuda.empty_cache()

    # Each record kernel per launch, the hw one against its inclusive twin on
    # the same scene's inclusive records, in turns, with its restated bound
    # (record_bound) and the former one (full_tile_bound_ms).
    shade = spike_shading(dev)
    rec, extra, turns = {}, {}, {}

    def time_pair(case, rules, n_frames, shaded, plain=False):
        """Turns of the inclusive and hw kernel of one kind on the records
        ``rules[rule]`` of ``case``; files the inclusive kernel's record in
        ``extra`` and returns the hw kernel's."""
        names = (("vf_raster_shade_shipped", "vf_raster_shade_shipped_hw") if shaded
                 else ("vf_raster_gbuffer", "vf_raster_gbuffer_hw"))
        fns = [getattr(kernels, n.removeprefix("vf_")) for n in names]
        args = shade if shaded else ()
        ms, turns[f"{'shade' if shaded else 'gbuffer'} {case}"] = kernel_turns(
            lambda: fns[0](*rules["inclusive"], n_frames, W, H, *args),
            lambda: fns[1](*rules["hw"], n_frames, W, H, *args))
        out = {}
        for rule, fn in zip(("inclusive", "hw"), fns):
            covered = covered_pixels(*rules[rule], n_frames, W, H, rule == "hw")
            out[rule] = {"ms": ms[rule], "device_ms": kernel_device_ms(
                             lambda: fn(*rules[rule], n_frames, W, H, *args)),
                         **record_bound(*rules[rule], n_frames, W, H, shaded, covered,
                                        rule == "hw")}
        out["hw"]["inclusive_ms"] = ms["inclusive"]
        if plain:
            out["hw"]["plain_ms"] = cuda_ms(lambda: fragment.terrain_fs(
                *tiles.render_gbuffer(*rules["hw"], n_frames, W, H), *shade) if shaded else
                tiles.render_gbuffer(*rules["hw"], n_frames, W, H), reps=1, warmup=0)
        extra[f"{names[0]} {case}"] = out["inclusive"]
        return out["hw"]

    tri = {rule: pipeline.triangle_records(W, H, dev, rule) for rule in ("inclusive", "hw")}
    rec["vf_raster_gbuffer_hw"] = time_pair("triangle", tri, 1, False)
    rec["vf_raster_gbuffer_hw"]["plain_ms"] = cuda_ms(
        lambda: tiles.render_gbuffer(*tri["hw"], 1, W, H))
    g128 = vt.make_terrain(W, H, GRID, device="cpu")
    s128 = {rule: scene_inputs(g128, dev, rule)[:2] for rule in ("inclusive", "hw")}
    for shaded, name in ((False, "vf_raster_gbuffer_hw"), (True, "vf_raster_shade_shipped_hw")):
        extra[f"{name} spike g{GRID}"] = time_pair(f"spike g{GRID}", s128, 1, shaded)
    del s128

    # The main path's shapes: the g1024 spike frame (shipped) and the
    # DEM-2048 Renderer frame (extended). The plain raster walks the g1024
    # frame's busiest tile list step by step (seconds on the card): its
    # first call, timed alone, is the measurement (phase 2d times it at
    # DEM-2048).
    g1024 = vt.make_terrain(W, H, VGRID, device="cpu")
    s1024 = {rule: scene_inputs(g1024, dev, rule)[:2] for rule in ("inclusive", "hw")}
    rec["vf_raster_shade_shipped_hw"] = time_pair(f"spike g{VGRID}", s1024, 1, True,
                                                  plain=True)
    del s1024
    torch.cuda.empty_cache()
    xyuv, tris, heights, views, projs = renderer_frame(main)
    one = tensor(1.0, dev)
    dem = {rule: pipeline.terrain_records(xyuv, tris.long(), heights, views, projs, one, one,
                                          W, H, fs_mode="extended", fill_rule=rule)
           for rule in ("inclusive", "hw")}
    extra[f"vf_raster_gbuffer_hw DEM-{DEM_MAIN}"] = time_pair(f"DEM-{DEM_MAIN}", dem, 1, False)
    del dem, main, xyuv, tris, heights
    torch.cuda.empty_cache()

    # Loaded: the close-in + w-crossing camera pair at grid=1024 through the
    # record route, whose w-crossing triangles bin into every tile with a
    # full-tile box.
    views, projs = special_cameras(W, H)
    loaded = {rule: record_route(VGRID, views, projs, dev, rule) for rule in ("inclusive", "hw")}
    case = f"g{VGRID} close-in + w-crossing"
    for shaded, name in ((False, "vf_raster_gbuffer_hw"), (True, "vf_raster_shade_shipped_hw")):
        extra[f"{name} {case}"] = time_pair(case, loaded, 2, shaded)
    del loaded
    torch.cuda.empty_cache()
    say("hw_timing", card=smi, config=f"{W}x{H}; VF_FILL_RULE=hw against inclusive, in turns",
        single_frame=latency, spike_hw_stages_ms=stages, kernel_ms=rec,
        kernel_ms_other_shapes=extra, kernel_turns=turns)
    return rec


# ---------------- slice 5: tall frames and the segment walk ----------------

SEG_KERNELS = (("vf_seg_gbuffer", kernels.seg_gbuffer),
               ("vf_seg_shade_shipped", kernels.seg_shade_shipped))
POSTER = (7680, 4320)                      # 8K UHD: a print-size poster
MAP_TILE = (4096, 4096)                    # a 4096^2 map tile
SEG_CHECK = (256, 4352)                    # tall, yet small enough for the plain walk
SEG_GRID, SEG_DEM = 256, 512               # phase 2e's spike grid and DEM
real_use_segment_route = pipeline.use_segment_route


def tall_spike_frame(spike, dev, views=None, projs=None, walk=None):
    """(fields, segment-walk inputs) on ``dev`` of a TerrainSpike's frame
    (its camera, or the given ones): pipeline.segment_frame on the vtx
    route's fields, or ``walk`` "rows" or "columns" forced."""
    w, h, g = spike.width, spike.height, spike._globals
    if views is None:
        views, projs = spike._view[None], spike._proj[None]
    fields = vtx.vs_fields(tensor(spike._xyuv, dev), tensor(spike._heights, dev),
                           tensor(views, dev), tensor(projs, dev), tensor(g.spacing, dev),
                           tensor(g.exaggeration, dev), w, h)
    if walk is None:
        frame = pipeline.segment_frame(fields, spike._indices, spike.grid, w, h)
    else:
        n = spike.grid - 1
        records, bbox = setup.corner_records(
            *setup.grid_corners([fields[:, k] for k in range(vtx.FIELDS)], spike.grid), w, h)
        perm = segments.column_major_perm(n, n, dev) if walk == "columns" else None
        b = bbox[0] if perm is None else bbox[0][perm]
        frame = (*segments.compact_valid(records[0], b, perm), segments.segment_bin(b, w, h, 2 * n))
    return fields, segments.stack_frames([frame])


def tall_renderer_frame(r):
    """(fields, segment-walk inputs) of a Renderer's frame on the card: the
    mesh, texture, default camera and row size render_rgba uses."""
    terr = r._terrain
    xyuv, tris = _renderer.grid_mesh(terr.width, terr.height, *terr.spacing, r.device)
    view, proj = r._default_terrain_camera(terr)
    one = tensor(1.0, r.device)
    fields = vtx.vs_fields(xyuv, r._height_tex, tensor(view[None], r.device),
                           tensor(proj[None], r.device), one, one, r.width, r.height, "extended")
    frame = pipeline.segment_frame(fields, tris, None, r.width, r.height, 2 * (terr.width - 1))
    return fields, tris, segments.stack_frames([frame])


def renderer_shading(r):
    """The extended shader's arguments of a Renderer's frame after the
    g-buffer: lut, heights, h_min, h_max, exposure, sun, normal spacing,
    exaggeration."""
    terr, meta, g = r._terrain, r._terrain_meta, r._globals
    d = r.device
    return (tensor(_colormap.build_lut(terr.colormap)[0], d), r._height_tex,
            tensor(meta.h_min, d), tensor(meta.h_max, d), tensor(g.exposure, d),
            tensor(g.sun_dir, d), tensor(terr.spacing[0], d), tensor(1.0, d))


def walked_pairs(binning):
    """The (tile, record) pairs the walk visits: for each tile, the
    interval lengths in its tile column of every row in its tile row's
    [r_lo, r_hi] (counts_est counts only the rows active there)."""
    seg_len = torch.clamp_min(binning.seg_hi.long() - binning.seg_lo.long() + 1, 0)
    cum = torch.nn.functional.pad(torch.cumsum(seg_len, -1), (1, 0))     # (B, NTX, ROWS+1)
    r_lo, r_hi = binning.r_bounds[:, 0].long(), binning.r_bounds[:, 1].long()
    at = lambda i: cum.gather(2, i[:, None, :].expand(-1, cum.shape[1], -1))
    n = at(torch.clamp_min(r_hi + 1, 0)) - at(torch.clamp_max(r_lo, cum.shape[2] - 1))
    return int(torch.where((r_hi >= r_lo)[:, None, :], n, 0).sum())


def skip_counts(binning):
    """The kernels' interval test, counted from the tables: the non-empty
    (tile, interval) pairs K8's walk visits, those whose y-extent misses
    the tile row (skipped), and the records the kernels scan with the bbox
    test. An interval's extent lies inside its row's active tile rows, so
    each tile row of its extent walks it."""
    n = torch.clamp_min(binning.seg_hi.long() - binning.seg_lo.long() + 1, 0)   # (B, NTX, ROWS)
    rows = n.shape[-1]
    r_lo, r_hi = binning.r_bounds[:, 0].long(), binning.r_bounds[:, 1].long()  # (B, NTY)
    live = r_hi >= r_lo
    diff = torch.zeros(n.shape[0], rows + 1, dtype=torch.long, device=n.device)
    diff.scatter_add_(1, torch.where(live, r_lo, rows), live.long())
    diff.scatter_add_(1, torch.where(live, r_hi + 1, rows), -live.long())
    walkers = torch.cumsum(diff[:, :rows], 1)          # (B, ROWS): tile rows walking row r
    ey = torch.div(binning.seg_y.long(), segments.TILE_H, rounding_mode="floor")
    scanners = torch.where(n > 0, ey[..., 1] - ey[..., 0] + 1, 0)              # (B, NTX, ROWS)
    walked = int(((n > 0) * walkers[:, None, :]).sum())
    return {"intervals_walked": walked, "intervals_skipped": walked - int(scanners.sum()),
            "records_scanned": int((n * scanners).sum())}


def overlap_pairs(fields, mesh, width, height):
    """The (8x128 tile, triangle) pairs whose pixel bbox overlaps the tile:
    the pairs a max-id g-buffer must evaluate (``record_bound``'s binned
    pairs, at the segment walk's tile). ``mesh`` is the grid size of the
    frame's fields (1, 7, N) or its (T, 3) index buffer."""
    f = [fields[:, k] for k in range(vtx.FIELDS)]
    corners = (setup.grid_corners(f, mesh) if isinstance(mesh, int) else
               setup.indexed_corners(f, pipeline._tri_indices_i32(mesh, fields.shape[2],
                                                                   fields.device)))
    b = setup.corner_records(*corners, width, height)[1][0].long()
    del corners, f
    b = b[b[:, 1] >= b[:, 0]]
    tw, th = segments.TILE_W, segments.TILE_H
    return int(((b[:, 1] // tw - b[:, 0] // tw + 1) * (b[:, 3] // th - b[:, 2] // th + 1)).sum())


def seg_bound(records, binning, pairs, width, height, shade):
    """bound of a segment kernel on these inputs: each compacted record's
    31 live columns, its id and its bbox read once, the tables it reads
    read once, the output written once; EVAL_OPS per (tile pixel, record)
    over the ``pairs`` (``overlap_pairs``) of tiles and records whose bbox
    overlaps them -- not the walk's conservative intervals
    (``walked_pairs``) --, and the resolve (and shader) per pixel."""
    n_frames = binning.r_bounds.shape[0]
    pixels = n_frames * width * height
    tables = (binning.seg_lo, binning.seg_hi, binning.row_base, binning.r_bounds,
              binning.seg_y, binning.tile_order)
    nbytes = (records.shape[0] * (setup.NUM_COLS + 1 + 4) * 4
              + sum(t.numel() * 4 for t in tables)
              + pixels * (4 if shade else 13) + (256 * 3 * 4 if shade else 0))
    ops = (pairs * segments.TILE_H * segments.TILE_W * EVAL_OPS
           + pixels * (RESOLVE_OPS + (SHADE_OPS if shade else 0)))
    return {**bound_of(nbytes, ops), "overlap_pairs": pairs,
            "walked_pairs": walked_pairs(binning), "records": records.shape[0]}


BAND_ROWS = 8       # tile rows of a 7680x4320 frame the plain walk is held to


def band_tables(binning, n=BAND_ROWS):
    """A single frame's walk tables cut to the ``n`` tile rows that walk
    the most records (counts_est): every other tile row's active-row range
    made empty. Returns (tables, the band's tile rows ascending)."""
    nty = binning.r_bounds.shape[-1]
    per_row = binning.counts_est[0].view(nty, -1).sum(1, dtype=torch.int64)
    band = torch.topk(per_row, min(n, nty)).indices.sort().values
    off = torch.ones(nty, dtype=torch.bool, device=band.device)
    off[band] = False
    r = binning.r_bounds.clone()
    r[:, 0, off], r[:, 1, off] = 0, -1
    return binning._replace(r_bounds=r.contiguous()), band


def band_check(frame, width, height, label, shade=None):
    """Both segment kernels against their plain version at the main path's
    shape, on the BAND_ROWS tile rows with the most walk: the plain walk
    over the band's tables (timed once; a whole 7680x4320 frame would take
    minutes), each kernel over the whole frame's tables and over the
    band's. G-buffers bit-equal on the band (the banded kernel: on the
    whole frame); with ``shade`` the shipped images under the FS policy
    there. Returns the band's plain ms, the kernels' ms on the band's
    tables and their max error."""
    records, ids, bbox, binning = frame
    tables, band = band_tables(binning)
    rows = (band[:, None] * segments.TILE_H + torch.arange(segments.TILE_H, device=band.device))
    rows = rows.reshape(-1)[rows.reshape(-1) < height]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    plain = segments.render_gbuffer_segments_plain(records, ids, tables, 1, width, height)
    ev[1].record()
    want = fragment.terrain_fs(*plain, *shade) if shade is not None else None
    ev[2].record()
    ev[2].synchronize()
    full = kernels.seg_gbuffer(records, ids, bbox, binning, 1, width, height)
    banded = kernels.seg_gbuffer(records, ids, bbox, tables, 1, width, height)
    on_band = lambda g: [p[:, rows] for p in g]
    for name, got, want_g in (("whole frame", on_band(full), on_band(plain)),
                              ("band's tables", banded, plain)):
        if not all(torch.equal(a, b) for a, b in zip(got, want_g)):
            raise AssertionError(f"{label}: vf_seg_gbuffer ({name}) is not bit-equal to its "
                                 "plain version on the band")
    out = {"band_tile_rows": band.tolist(), "band_walked_pairs": walked_pairs(tables),
           "band_covered": int(plain[3][:, rows].sum()),
           "plain_ms": ev[0].elapsed_time(ev[1]),
           "err": {"vf_seg_gbuffer": assert_gbuffer_close(on_band(full), on_band(plain), label)},
           "ms_band": {"vf_seg_gbuffer": cuda_ms(
               lambda: kernels.seg_gbuffer(records, ids, bbox, tables, 1, width, height),
               reps=3, warmup=1)}}
    if shade is not None:
        img = kernels.seg_shade_shipped(records, ids, bbox, binning, 1, width, height, *shade)
        img_band = kernels.seg_shade_shipped(records, ids, bbox, tables, 1, width, height,
                                             *shade)
        words = lambda t: t.view(torch.int32)[:, rows]     # uint32 has no CUDA gather
        d, _ = assert_fs_policy(words(img), words(want), f"{label}: vf_seg_shade_shipped")
        d_band, _ = assert_fs_policy(img_band, want, f"{label}: vf_seg_shade_shipped (band)")
        out["err"]["vf_seg_shade_shipped"] = float(max(d, d_band))
        out["shade_plain_ms"] = ev[0].elapsed_time(ev[2])
        out["ms_band"]["vf_seg_shade_shipped"] = cuda_ms(
            lambda: kernels.seg_shade_shipped(records, ids, bbox, tables, 1, width, height,
                                              *shade),
            reps=3, warmup=1)
    return out


def phase2e_seg_kernels(dev):
    """Both segment kernels against their plain version at a tall frame
    (256x4352): the spike g256 (shipped) on the estimate's walk and on each
    forced one, a w-crossing camera, and a Renderer DEM-512 (extended).
    Masks, winners and varyings bit-equal; images under the FS policy; the
    pairs each tile evaluated equal the skip mirror's (overlap_walk).
    Returns each kernel's max error."""
    w, h = SEG_CHECK
    shade = spike_shading(dev)
    spike = vt.make_terrain(w, h, SEG_GRID, device="cpu")
    views, projs = (a[1:] for a in special_cameras(w, h))
    cases = {f"spike g{SEG_GRID}": tall_spike_frame(spike, dev)[1],
             f"spike g{SEG_GRID} rows": tall_spike_frame(spike, dev, walk="rows")[1],
             f"spike g{SEG_GRID} columns": tall_spike_frame(spike, dev, walk="columns")[1]}
    fields, cases[f"spike g{SEG_GRID} w-crossing"] = tall_spike_frame(spike, dev, views, projs)
    corners = setup.grid_corners([fields[:, f] for f in range(vtx.FIELDS)], SEG_GRID)
    valid = setup.setup_fields_core(*corners, w, h)[5]
    clean = (corners[0][2] > 1e-8) & (corners[1][2] > 1e-8) & (corners[2][2] > 1e-8)
    crossing = int((valid & ~clean).sum())
    if crossing == 0:
        raise AssertionError("tall w-crossing: no valid triangle crosses w = 0")
    del fields, corners, valid, clean
    r = make_renderer(SEG_DEM, dev, seed=6, size=SEG_CHECK)
    _, _, cases[f"Renderer DEM-{SEG_DEM}"] = tall_renderer_frame(r)

    errs = {name: 0.0 for name, _ in SEG_KERNELS}
    plain_ms, work = {}, {}
    for label, (records, ids, bbox, binning) in cases.items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = segments.render_gbuffer_segments_plain(records, ids, binning, 1, w, h)
        end.record()
        end.synchronize()
        plain_ms[label] = start.elapsed_time(end)
        evaluated = torch.full(binning.tile_order.shape, -1, dtype=torch.int32, device=dev)
        got = kernels.seg_gbuffer(records, ids, bbox, binning, 1, w, h, evaluated=evaluated)
        err = assert_gbuffer_close(got, plain, f"{label}: vf_seg_gbuffer")
        if not all(torch.equal(a, b) for a, b in zip(got, plain)):
            raise AssertionError(f"{label}: vf_seg_gbuffer is not bit-equal to its plain version")
        errs["vf_seg_gbuffer"] = max(errs["vf_seg_gbuffer"], err)
        offsets = segments.overlap_walk(bbox, binning, 1, w, h)[1]
        if not torch.equal(evaluated.view(-1).long(), offsets[1:] - offsets[:-1]):
            raise AssertionError(f"{label}: vf_seg_gbuffer's evaluated pairs are not the "
                                 "skip mirror's")
        if not label.startswith("Renderer"):
            d, _ = assert_fs_policy(kernels.seg_shade_shipped(records, ids, bbox, binning, 1, w,
                                                              h, *shade),
                                    fragment.terrain_fs(*plain, *shade),
                                    f"{label}: vf_seg_shade_shipped")
            errs["vf_seg_shade_shipped"] = max(errs["vf_seg_shade_shipped"], float(d))
        work[label] = {"records": records.shape[0], "rows": binning.seg_lo.shape[-1],
                       "walked_pairs": walked_pairs(binning),
                       "evaluated_pairs": int(evaluated.sum(dtype=torch.int64)),
                       "estimate": int(binning.counts_est.sum(dtype=torch.int64)),
                       "covered": int(plain[3].sum())}
        sync()
    if work[f"spike g{SEG_GRID} rows"]["rows"] == work[f"spike g{SEG_GRID} columns"]["rows"] \
            and work[f"spike g{SEG_GRID} rows"]["walked_pairs"] \
            == work[f"spike g{SEG_GRID} columns"]["walked_pairs"]:
        raise AssertionError("the forced walks are the same walk")

    del cases, r
    torch.cuda.empty_cache()
    say("seg_kernel_vs_plain", tolerance="masks, winners and varyings bit-equal; images: bytes "
        f"off by <= 1 on <= {FS_MAX_FRACTION} of bytes", frame=f"{w}x{h}",
        cases=list(plain_ms), plain_ms=plain_ms, work=work, w_crossing_valid=crossing,
        max_err=errs)
    return errs


def poster_frames(dev, size=POSTER, dems=(DEM_MAIN, SRTM)):
    """The slice-5 frames at ``size``: make_terrain(g1024) and a Renderer
    per DEM size, each returning its frame through the public API."""
    spike = vt.make_terrain(*size, VGRID, device=dev)
    frames = {f"spike g{VGRID}": (spike, spike.render_rgba)}
    for n in dems:
        r = make_renderer(n, dev, seed=1 if n == SRTM else 0, size=size)
        frames[f"Renderer DEM-{n}"] = (r, r.render_rgba)
    return frames


def phase3e_seg_main_path(dev):
    """Slice 5's main path: at 7680x4320 make_terrain(g1024).render_rgba()
    and Renderer.render_rgba() at DEM-2048 and DEM-3601 (T > 2^24) on the
    card. Only the segment kernels may launch; each frame's g-buffer is
    held bit for bit to the vtx or indexed route's on the same frame, and
    its image to that route's under the FS policy; each frame's kernels are
    held to their plain version on a band of its tile rows (``band_check``).
    Returns the launch counts and each frame's ``band_check``."""
    w, h = POSTER
    frames = poster_frames(dev)
    every = SEG_KERNELS + RECORD_KERNELS + HW_KERNELS + VTX_KERNELS + PACKED_KERNELS
    out, peak, band = {}, {}, {}
    for _, fn in every:
        fn.launches = 0
    for label, (_, render) in frames.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[label] = render()
        sync()
        peak[label] = int(torch.cuda.max_memory_allocated())
    launches = {name: fn.launches for name, fn in every}
    for name, _ in SEG_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"slice 5's main path never launched {name}")
    for name, _ in RECORD_KERNELS + HW_KERNELS + VTX_KERNELS + PACKED_KERNELS:
        if launches[name] != 0:
            raise AssertionError(f"slice 5's main path launched {name}")

    clear = np.array([39, 39, 48], np.uint8)    # the terrain's clear colour in sRGB u8
    checks = {}
    for label, (obj, _) in frames.items():
        img = out[label]
        if img.dtype != np.uint8 or img.shape != (h, w, 4):
            raise AssertionError(f"{label}: bad image {img.dtype} {img.shape}")
        covered = float((img[..., :3] != clear).any(-1).mean())
        if covered < 0.05:
            raise AssertionError(f"{label}: the terrain covers {covered:.3f} of the frame")
        # The route the frame took before this slice, on the same frame.
        if label.startswith("spike"):
            fields, frame = tall_spike_frame(obj, dev)
            got = kernels.seg_gbuffer(*frame, 1, w, h)
            want = vtx.render_gbuffer_vtx_batch(fields, VGRID, w, h)
            old = vtx.render_image_vtx_batch(fields, *spike_shading(dev), VGRID, w, h)
        else:
            fields, tris, frame = tall_renderer_frame(obj)
            got = kernels.seg_gbuffer(*frame, 1, w, h)
            want = packed.render_gbuffer_packed_batch(fields, tris, w, h)
            old = fragment.terrain_fs_extended(*want, *renderer_shading(obj))
        sync()
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, want))
        if not bit_equal:
            raise AssertionError(f"{label}: the segment g-buffer is not the old route's")
        d, frac = assert_fs_policy(img, _formats.u32_image_to_rgba_u8(old[0]).cpu().numpy(),
                                   f"{label}: segment route vs old route")
        del got, want, old
        pairs = overlap_pairs(fields, VGRID if label.startswith("spike") else tris, w, h)
        band[label] = band_check(frame, w, h, label,
                                 spike_shading(dev) if label.startswith("spike") else None)
        checks[label] = {"covered_share": covered, "gbuffer_bit_equal": bit_equal,
                         "image_max_byte_delta": d, "image_frac_bytes_differ": frac,
                         "records": frame[0].shape[0], "walk_rows": frame[3].seg_lo.shape[-1],
                         "walked_pairs": walked_pairs(frame[3]), "overlap_pairs": pairs,
                         "peak_bytes": peak[label], "against_plain": band[label]}
        del fields, frame
        torch.cuda.empty_cache()
    say("seg_main_path", config=f"{w}x{h}: make_terrain({w},{h},{VGRID}).render_rgba(); "
        f"Renderer({w},{h}) DEM-{DEM_MAIN} and DEM-{SRTM} render_rgba", launches=launches,
        tolerance="against the old route: g-buffers bit-equal, images under the FS policy; "
        f"against plain on the {BAND_ROWS} tile rows of most walk: g-buffers bit-equal, images "
        f"bytes off by <= 1 on <= {FS_MAX_FRACTION} of bytes",
        frames=checks, sha256={k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in out.items()})
    return launches, band


def seg_stages(obj, dev, reps=REPS):
    """CUDA events around each stage of one segment-route frame (median of
    ``reps`` after a warm-up): vertex stage, setup, walk order (segment_bin
    with the axis estimate), compaction, kernel, shader, readback."""
    w, h = obj.width, obj.height
    spike = isinstance(obj, vt.TerrainSpike)
    if spike:
        g = obj._globals
        mesh = (tensor(obj._xyuv, dev), tensor(obj._heights, dev), tensor(g.spacing, dev),
                tensor(g.exaggeration, dev))
        view, proj, grid, tris, fs_mode, rs = obj._view, obj._proj, obj.grid, None, "shipped", \
            2 * (obj.grid - 1)
        shade = spike_shading(dev)
    else:
        terr = obj._terrain
        xyuv, tris = _renderer.grid_mesh(terr.width, terr.height, *terr.spacing, obj.device)
        one = tensor(1.0, dev)
        mesh = (xyuv, obj._height_tex, one, one)
        view, proj = obj._default_terrain_camera(terr)
        grid, fs_mode, rs = None, "extended", 2 * (terr.width - 1)
        shade = renderer_shading(obj)
    names = ("vertex_stage", "setup", "walk_order", "compaction", "kernel", "shader", "readback")
    rows = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        fields = vtx.vs_fields(mesh[0], mesh[1], tensor(view[None], dev),
                               tensor(proj[None], dev), mesh[2], mesh[3], w, h, fs_mode)
        ev[1].record()
        f = [fields[:, k] for k in range(vtx.FIELDS)]
        corners = (setup.grid_corners(f, grid) if spike else setup.indexed_corners(f, tris))
        records, bbox = setup.corner_records(*corners, w, h)
        del corners, f
        ev[2].record()
        perm, binning = segments.walk_order(bbox[0], w, h, rs)
        ev[3].record()
        frame = segments.stack_frames([(*segments.compact_valid(
            records[0], bbox[0] if perm is None else bbox[0][perm], perm), binning)])
        del records, bbox
        ev[4].record()
        if spike:
            img = kernels.seg_shade_shipped(*frame, 1, w, h, *shade)
            ev[5].record()
            ev[6].record()
        else:
            gbuf = kernels.seg_gbuffer(*frame, 1, w, h)
            ev[5].record()
            img = fragment.terrain_fs_extended(*gbuf, *shade)
            ev[6].record()
        _formats.u32_image_to_rgba_u8(img[0]).cpu().numpy()
        ev[7].record()
        sync()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
        del fields, frame, img
    return ({n: statistics.median(r[i] for r in rows[1:]) for i, n in enumerate(names)},
            "column-major" if perm is not None else "row-major")


def phase4e_seg_timing(smi, dev, band):
    """Slice 5's times: frame latency on the segment route and on the route
    it replaced (vtx or indexed), in turns, at 7680x4320 and 4096x4096;
    the stages of the segment route; each segment kernel at the main
    path's shapes against its bound, and the skip's counts on each
    7680x4320 frame. Returns the kernels line's record."""
    latency, stages, walk = {}, {}, {}
    for size, dems in ((POSTER, (DEM_MAIN, SRTM)), (MAP_TILE, (DEM_MAIN,))):
        tag = f"{size[0]}x{size[1]}"
        frames = poster_frames(dev, size, dems)
        for label, (obj, render) in frames.items():
            times = {"segment": [], "old": []}
            for route in ("segment", "old", "old", "segment"):
                pipeline.use_segment_route = (real_use_segment_route if route == "segment"
                                              else lambda *a: False)
                try:
                    render()
                    sync()
                    times[route] += host_ms(render, [()] * 5)
                finally:
                    pipeline.use_segment_route = real_use_segment_route
            latency[f"{label} {tag}"] = {
                route: {"median_ms": float(np.percentile(t, 50)),
                        "p80_ms": float(np.percentile(t, 80)), "n": len(t)}
                for route, t in times.items()}
            if label != f"Renderer DEM-{SRTM}":
                stages[f"{label} {tag}"], walk[f"{label} {tag}"] = seg_stages(obj, dev)
        del frames
        torch.cuda.empty_cache()

    # Each kernel per launch at the main path's shape (3 back-to-back
    # launches), against its bound, and the skip on each 7680x4320 frame:
    # the pairs the kernel evaluated (its ``evaluated`` output) must equal
    # the bbox-overlapping pairs; the intervals K8's walk visits and those
    # the y-extent test skips. The plain version's time is phase 3e's on
    # the same frame's band of tile rows, beside the kernel's on the band's
    # tables (ms_band).
    w, h = POSTER
    frames = poster_frames(dev, POSTER, (DEM_MAIN, SRTM))
    at = {"vf_seg_shade_shipped": f"spike g{VGRID}", "vf_seg_gbuffer": f"Renderer DEM-{DEM_MAIN}"}
    shade = spike_shading(dev)
    rec, skip = {}, {}
    for label, (obj, _) in frames.items():
        if label.startswith("spike"):
            fields, frame = tall_spike_frame(obj, dev)
            pairs = overlap_pairs(fields, VGRID, w, h)
            name = "vf_seg_shade_shipped"
            call = lambda e=None: kernels.seg_shade_shipped(*frame, 1, w, h, *shade, evaluated=e)
        else:
            fields, tris, frame = tall_renderer_frame(obj)
            pairs = overlap_pairs(fields, tris, w, h)
            name = "vf_seg_gbuffer"
            call = lambda e=None: kernels.seg_gbuffer(*frame, 1, w, h, evaluated=e)
        del fields
        evaluated = torch.full(frame[3].tile_order.shape, -1, dtype=torch.int32, device=dev)
        call(evaluated)
        sync()
        n_eval = int(evaluated.sum(dtype=torch.int64))
        if n_eval != pairs:
            raise AssertionError(f"{label}: {name} evaluated {n_eval} (tile, record) pairs, "
                                 f"the bboxes overlap {pairs}")
        ms = cuda_ms(call, reps=3, warmup=1, inner=3)
        skip[label] = {"kernel": name, "ms": ms, "ms_band": band[label]["ms_band"],
                       "evaluated_pairs": n_eval, "overlap_pairs": pairs,
                       "walked_pairs": walked_pairs(frame[3]), **skip_counts(frame[3]),
                       "max_tile_evaluated": int(evaluated.max())}
        if label == at[name]:
            rec[name] = {"ms": ms, **seg_bound(frame[0], frame[3], pairs, w, h,
                                               shade=name == "vf_seg_shade_shipped")}
        del frame, evaluated, call
        torch.cuda.empty_cache()
    for name, r in rec.items():
        b = band[at[name]]
        r["plain_ms"] = b["shade_plain_ms" if name == "vf_seg_shade_shipped" else "plain_ms"]
        r["plain_at"] = (f"{w}x{h} {at[name]}, the {BAND_ROWS} tile rows of most walk "
                         f"{b['band_tile_rows']} (phase 3e)")
        r["ms_band"] = b["ms_band"][name]
    del frames
    torch.cuda.empty_cache()
    say("seg_timing", card=smi, config="segment route vs the route each tall frame took before "
        "(vtx for the spike, indexed for the Renderer), in turns (segment, old, old, segment; 5 "
        "calls each after a warm-up), readback included", single_frame=latency,
        old_route_faster_everywhere=all(v["old"]["median_ms"] < v["segment"]["median_ms"]
                                        for v in latency.values()),
        segment_stage_ms=stages, walk=walk,
        kernel_at={name: f"{at[name]} {w}x{h}" for name in at}, kernel_ms=rec,
        skip={f"{label} {w}x{h}": v for label, v in skip.items()})
    return rec




# ---------------- slice 11: the public surface on the card ----------------

# render_spike_frames takes the vtx route's shaded path; the other kernels
# must not launch there.
SPIKE_KERNELS = tuple(k for k in VTX_KERNELS if k[0] != "vf_vtx_resolve_gbuffer")
# Grids above 1024 (the API admits up to 4096): frames per render_spike_frames
# call. Each frame is also checked alone against the plain version.
BIG_GRIDS = ((2048, 4), (4096, 4))
POSTER_EYE = (3.0, 2.0, 3.0)
TOOLS_TIMEOUT = 600
# The reference's budget for grid_generate(1024, 1024) (BASELINE.md:12).
GRID_GENERATE_BUDGET_MS = 80.0


def probe_checks():
    """device_probe and enumerate_adapters on the card."""
    probes = {str(b): vt.device_probe(b) for b in ("CUDA", None, "TPU")}
    for b in ("CUDA", "None"):
        p = probes[b]
        if p["status"] != "ok" or p.get("vendor_id") != _device.NVIDIA_VENDOR_ID:
            raise AssertionError(f"device_probe({b}) = {p}")
    if probes["TPU"]["status"] != "unsupported":
        raise AssertionError(f"device_probe('TPU') = {probes['TPU']}")
    adapters = vt.enumerate_adapters()
    cards = [a for a in adapters if a["backend"] == "CUDA"]
    if len(cards) != torch.cuda.device_count() or any(
            "max_framebuffer_dim=8192" not in a["limits"] or a["vendor_id"] != 0x10DE
            for a in cards):
        raise AssertionError(f"enumerate_adapters() = {adapters}")
    return {"millis": {b: p["millis"] for b, p in probes.items()},
            "status": {b: p["status"] for b, p in probes.items()},
            "cuda_adapters": len(cards), "features": cards[0]["features"],
            "limits": cards[0]["limits"]}


def spike_frames_headline(dev):
    """render_spike_frames at bench.py's headline shape on the card: launch
    counts, bytes against the direct batch and TerrainSpike; returns the
    launches."""
    eyes = orbit_eyes(VBATCH, phase=0.7)
    views, projs = orbit_cameras(VBATCH, W, H, phase=0.7)
    every = VTX_KERNELS + RECORD_KERNELS + PACKED_KERNELS + HW_KERNELS + SEG_KERNELS
    for _, fn in every:
        fn.launches = 0
    frames = vt.render_spike_frames(W, H, VGRID, eyes)
    sync()
    launches = {name: fn.launches for name, fn in every}
    for name, _ in every:
        if (launches[name] > 0) != (name in dict(SPIKE_KERNELS)):
            raise AssertionError(f"render_spike_frames launched {name} "
                                 f"{launches[name]} times")
    if frames.dtype != np.uint8 or frames.shape != (VBATCH, H, W, 4):
        raise AssertionError(f"bad frames {frames.dtype} {frames.shape}")
    xyuv, idx = _mesh.build_grid_xyuv(VGRID)
    direct = _formats.u32_image_to_rgba_u8(pipeline.render_terrain_batch_u32(
        xyuv, idx, np.zeros((1, 1), np.float32), views, projs, grid_n=VGRID,
        **batch_args(dev))).cpu().numpy()
    if not np.array_equal(frames, direct):
        raise AssertionError("render_spike_frames differs from render_terrain_batch_u32")
    spike = vt.TerrainSpike(W, H, VGRID, device=dev)
    for eye, frame in zip(eyes, frames):
        spike.set_camera_look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0, 0.1, 100.0)
        if not np.array_equal(frame, spike.render_rgba()):
            raise AssertionError(f"render_spike_frames differs from TerrainSpike at {eye}")
    return launches, hashlib.sha256(frames.tobytes()).hexdigest()


def spike_frames_timing(dev):
    """render_spike_frames against the direct batch (phase 4b's vtx route,
    mesh on the card, frames left there), in turns: spike, direct, direct,
    spike over 5 camera sets after a warm-up set; host clock after a
    synchronize."""
    phases = [0.31 * r + 0.05 for r in range(REPS + 1)]
    eyes = [(orbit_eyes(VBATCH, phase=ph),) for ph in phases]
    cams = [orbit_cameras(VBATCH, W, H, phase=ph) for ph in phases]
    fns = {"render_spike_frames": (lambda e: vt.render_spike_frames(W, H, VGRID, e), eyes),
           "direct_batch": (route_fn("vtx", VGRID, dev), cams)}
    times = {name: [] for name in fns}
    for name in ("render_spike_frames", "direct_batch", "direct_batch", "render_spike_frames"):
        fn, inputs = fns[name]
        fn(*inputs[-1])
        sync()
        times[name] += host_ms(fn, inputs[:REPS])
    med = {name: statistics.median(t) for name, t in times.items()}
    # Of the gap, the host's build of the spike mesh, which every call makes.
    mesh_ms = statistics.median(host_ms(lambda: _mesh.build_grid_xyuv(VGRID), [()] * REPS))
    return {"ms_median": med, "ms_all": times,
            "mpix_per_s": {n: VBATCH * W * H / (m * 1e3) for n, m in med.items()},
            "readback_and_assembly_ms": med["render_spike_frames"] - med["direct_batch"],
            "host_mesh_build_ms": mesh_ms}


def spike_frames_big_grids(dev, shade):
    """render_spike_frames above grid 1024: each frame's vtx kernels against
    their plain versions (phase 2b's bounds, check_vtx_passes) on that
    frame alone, and the frame's bytes against the kernels' image there."""
    out, errs = {}, {}
    for grid, n in BIG_GRIDS:
        eyes = orbit_eyes(n, phase=0.9)
        views, projs = orbit_cameras(n, W, H, phase=0.9)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        frames = vt.render_spike_frames(W, H, grid, eyes)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        plain_peak, listed = 0, []
        for b in range(n):
            fields = grid_fields(grid, views[b:b + 1], projs[b:b + 1], dev)
            torch.cuda.reset_peak_memory_stats()
            err, k, _, _ = check_vtx_passes(fields, grid, shade, f"g{grid} frame {b}")
            plain_peak = max(plain_peak, torch.cuda.max_memory_allocated())
            listed.append(k)
            for name, e in err.items():
                errs[name] = max(errs.get(name, 0.0), float(e))
            img = _formats.u32_image_to_rgba_u8(
                vtx.render_image_vtx_batch(fields, *shade, grid, W, H)).cpu().numpy()[0]
            if not np.array_equal(img, frames[b]):
                raise AssertionError(f"g{grid} frame {b}: render_spike_frames differs from "
                                     "the vtx kernels on the frame alone")
            del fields
        clear = np.array([39, 39, 48], np.uint8)
        out[f"g{grid} x{n}"] = {
            "triangles_per_frame": vtx.n_triangles(grid), "first_call_ms": ms,
            "peak_bytes": int(peak), "check_peak_bytes": int(plain_peak),
            "big_listed": listed,
            "covered_share": float((frames[..., :3] != clear).any(-1).mean()),
            "sha256": hashlib.sha256(frames.tobytes()).hexdigest()}
        del frames
        torch.cuda.empty_cache()
    return out, errs


def run_tools(specs):
    """Start each CLI twin (python -m vulkan_forge_torch.tools.<tool> ...
    --device cuda) together, each writing its output to a file; wait for
    all; kill any that outlives TOOLS_TIMEOUT. Returns {name: (rc, stdout)}."""
    out_dir = os.path.join(OUT_DIR, "tools")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs, files = {}, []
    try:
        for name, (tool, args, extra) in specs.items():
            log = open(os.path.join(out_dir, f"{name}.log"), "w+")
            files.append(log)
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", f"vulkan_forge_torch.tools.{tool}", *args,
                 "--device", "cuda"], cwd=ROOT, env=dict(env, **extra), stdout=log,
                stderr=subprocess.STDOUT, text=True), log)
        deadline = time.monotonic() + TOOLS_TIMEOUT
        results = {}
        for name, (p, log) in procs.items():
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            log.seek(0)
            results[name] = (p.returncode, log.read())
        return results
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in files:
            log.close()


def tools_checks(dev):
    """The six CLI twins on the card, with their checks."""
    d = os.path.join(OUT_DIR, "tools")
    spike_png = os.path.join(d, "terrain_spike.png")
    specs = {
        "device_diagnostics": ("device_diagnostics", ["--json", f"{d}/diag.json"], {}),
        "determinism_triangle": ("determinism_harness",
                                 ["--runs", "3", "--out-dir", f"{d}/det_triangle"], {}),
        "determinism_terrain": ("determinism_harness",
                                ["--runs", "3", "--scene", "terrain",
                                 "--out-dir", f"{d}/det_terrain"], {}),
        "backends_runner": ("backends_runner", ["--require-same", "--runs", "1",
                                                "--out-dir", f"{d}/backends"], {}),
        "terrain_spike": ("terrain_spike", ["--out", spike_png], {}),
        "parity_report": ("parity_report", ["--rules", "hw", "--json", f"{d}/parity.json"], {}),
    }
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_tools(specs)
    together_s = time.perf_counter() - t0
    # perf_sanity alone, so that no other process shares the card.
    res.update(run_tools({"perf_sanity": (
        "perf_sanity", ["--width", str(W), "--height", str(H), "--json", f"{d}/perf.json"],
        {"VF_ENFORCE_PERF": "1"})}))
    for name, (rc, log) in res.items():
        if rc != 0:
            raise AssertionError(f"tool {name} exited {rc}:\n{log[-4000:]}")
    load = lambda f: json.load(open(os.path.join(d, f)))

    diag = load("diag.json")
    if diag["probes"][0]["backend_request"] != "CUDA" or diag["probes"][0]["status"] != "ok":
        raise AssertionError(f"device_diagnostics: {diag['probes']}")
    det = {k: load(f"det_{k}/determinism_report.json") for k in ("triangle", "terrain")}
    tri = hashlib.sha256(vt.render_triangle_rgba(128, 128, device=dev).tobytes()).hexdigest()
    if not all(r["all_equal"] for r in det.values()) or det["triangle"]["unique"] != [tri]:
        raise AssertionError(f"determinism_harness: {det}")
    bk = load("backends/backends_report.json")
    if not bk["cross_backend_equal"] or bk["per_backend"]["TORCH_CUDA"]["status"] != "ok" \
            or bk["per_backend"]["TORCH_CPU"]["status"] != "ok":
        raise AssertionError(f"backends_runner: {bk}")
    if not np.array_equal(png_pixels(spike_png),
                          vt.make_terrain(512, 384, 128, device=dev).render_rgba()):
        raise AssertionError("terrain_spike's PNG is not make_terrain(512,384,128)'s frame")
    parity = load("parity.json")
    if not parity["hw_coverage_exact"] or any(c["cov_diff_px"] for c in parity["configs"]):
        raise AssertionError(f"parity_report: {parity}")
    perf = load("perf.json")
    budget = 40.0 * W * H / (512.0 * 512.0)
    return {"tools_together_s": together_s,
            "device_diagnostics": {"probes": {p["backend_request"]: p["status"]
                                              for p in diag["probes"]},
                                   "cuda_millis": diag["probes"][0]["millis"]},
            "determinism": {k: {"all_equal": r["all_equal"], "unique": r["unique"],
                                "avg_ms": r["avg_ms"]} for k, r in det.items()},
            "backends_runner": {k: {"status": v["status"], "sha256": v["sha256"],
                                    "avg_ms": v["avg_ms"]}
                                for k, v in bk["per_backend"].items()},
            "terrain_spike": "PNG pixels equal make_terrain(512,384,128).render_rgba()",
            "parity_report": {c["name"]: {"cov_diff_px": c["cov_diff_px"],
                                          "covered_px": c["covered_px"],
                                          "max_lsb_delta_all": c["max_lsb_delta_all"]}
                              for c in parity["configs"]},
            "perf_sanity_triangle": {"config": f"{W}x{H}, 30 runs after 3 warm-ups",
                                     "p95_ms": perf["steady"]["p95_ms"],
                                     "median_ms": perf["steady"]["median_ms"],
                                     "init_ms": perf["init_ms"], "budget_ms": budget,
                                     "enforced_limit_ms": 3.0 * budget}}


def numpy_grid(nx, nz):
    """grid_generate's numpy path before the core: make_grid and the u32 copy."""
    xy, uv, idx = _mesh.make_grid(nx, nz, 1.0, 1.0)
    return xy, uv, idx.astype(np.uint32)


def grid_generate_turns(reps=5):
    """grid_generate(1024, 1024), which runs the C++ core, and the numpy path
    (numpy_grid), in turns, reps calls each; host clock, ms."""
    times = {"core": [], "numpy": []}
    for _ in range(reps):
        calls = _native.grid_generate_native.calls
        t0 = time.perf_counter()
        vt.grid_generate(1024, 1024)
        times["core"].append((time.perf_counter() - t0) * 1e3)
        if _native.grid_generate_native.calls != calls + 1:
            raise AssertionError("grid_generate(1024, 1024) did not take the C++ core")
        t0 = time.perf_counter()
        numpy_grid(1024, 1024)
        times["numpy"].append((time.perf_counter() - t0) * 1e3)
    return times["core"], times["numpy"]


def host_paths():
    """The host paths that the JAX package builds in C++: grid_generate
    (1024, 1024) through the port's core (csrc/host.cpp), held bit for bit
    to make_grid and timed in turns with the numpy path against the
    reference's enforced 80 ms (median of 5 each), and the stdlib PNG
    encoder on a 7680x4320 frame (median of 3)."""
    for spacing in ((1.0, 1.0), (0.1, 1 / 3)):
        calls = _native.grid_generate_native.calls
        out = vt.grid_generate(1024, 1024, spacing)
        if _native.grid_generate_native.calls != calls + 1:
            raise AssertionError(f"grid_generate(1024, 1024, {spacing}) did not take "
                                 "the C++ core")
        want = _mesh.make_grid(1024, 1024, *spacing)
        for got, ref in zip(out[:2], want[:2]):
            if got.dtype != np.float32 or got.tobytes() != ref.tobytes():
                raise AssertionError(f"the C++ core's grid at {spacing} is not make_grid's")
        if out[2].dtype != np.uint32 or not np.array_equal(out[2], want[2]):
            raise AssertionError(f"the C++ core's indices at {spacing} are not make_grid's")
    core, numpy_path = grid_generate_turns()
    if statistics.median(core) > GRID_GENERATE_BUDGET_MS:
        raise AssertionError(f"grid_generate(1024, 1024) took {statistics.median(core)} ms "
                             f"(median of 5), over the reference's "
                             f"{GRID_GENERATE_BUDGET_MS} ms")
    frame = vt.render_spike_frames(POSTER[0], POSTER[1], VGRID, [POSTER_EYE])[0]
    path = os.path.join(OUT_DIR, "poster_7680x4320.png")
    png = []
    for _ in range(3):
        t0 = time.perf_counter()
        _io.save_png_rgba(path, frame)
        png.append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(png_pixels(path), frame):
        raise AssertionError("the 7680x4320 PNG does not round-trip its pixels")
    return {"grid_generate_1024_ms": {
                "median": statistics.median(core), "all": core,
                "budget": GRID_GENERATE_BUDGET_MS, "path": "C++ core (csrc/host.cpp)",
                "equal_to_make_grid": [[1.0, 1.0], [0.1, 1 / 3]]},
            "grid_generate_1024_numpy_ms": {
                "median": statistics.median(numpy_path), "all": numpy_path,
                "path": "make_grid + u32 copy", "in_turns_with": "core"},
            "save_png_rgba_7680x4320_ms": {"median": statistics.median(png), "all": png,
                                           "bytes": os.path.getsize(path)}}


def phase3f_public_surface(smi, dev):
    """Slice 11's public surface on the card."""
    probes = probe_checks()
    launches, sha = spike_frames_headline(dev)
    timing = spike_frames_timing(dev)
    big, big_err = spike_frames_big_grids(dev, spike_shading(dev))
    tools = tools_checks(dev)
    host = host_paths()
    say("public_surface", card=smi, probes=probes,
        spike_frames={"config": f"render_spike_frames({W},{H},{VGRID}, {VBATCH} orbit eyes)",
                      "launches": launches, "sha256": sha,
                      "equal_to": ["render_terrain_batch_u32", "TerrainSpike.render_rgba()"],
                      **timing},
        big_grids=big, big_grids_max_err=big_err,
        big_grids_tolerance=f"winners and lists exact; masks exact; varyings <= "
        f"{VARYING_RTOL}*max(1,|x|); images: bytes off by <= 1 on <= {FS_MAX_FRACTION} of "
        "bytes; each frame equal to the kernels on that frame alone",
        tools=tools, host_paths=host)


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
    packed_err = phase2c_packed_kernels(dev)
    sync()
    hw_err = phase2d_hw_kernels(dev)
    sync()
    seg_err = phase2e_seg_kernels(dev)
    sync()
    launches = phase3_main_path()
    sync()
    vtx_launches = phase3b_vtx_main_path(dev)
    launches.update({name: vtx_launches[name] for name, _ in VTX_KERNELS})
    sync()
    packed_launches = phase3c_renderer_main_path(dev)
    launches.update({name: packed_launches[name] for name, _ in PACKED_KERNELS})
    sync()
    hw_launches = phase3d_hw_main_path(dev)
    launches.update({name: hw_launches[name] for name, _ in HW_KERNELS})
    sync()
    seg_launches, seg_band = phase3e_seg_main_path(dev)
    launches.update({name: seg_launches[name] for name, _ in SEG_KERNELS})
    for b in seg_band.values():
        for name, err in b["err"].items():
            seg_err[name] = max(seg_err[name], err)
    sync()
    phase3f_public_surface(smi, dev)
    sync()
    phase4_batch(smi, dev)
    sync()
    vtx_rec = phase4b_vtx_timing(smi, dev)
    sync()
    packed_rec = phase4c_packed_timing(smi, dev)
    sync()
    hw_rec = phase4d_hw_timing(smi, dev)
    sync()
    seg_rec = phase4e_seg_timing(smi, dev, seg_band)
    sync()
    if opts.profile:
        phase5_profile(dev)
        sync()
    src = "vulkan_forge_torch/csrc/raster.cu"
    vsrc = "vulkan_forge_torch/csrc/vtx.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    # The record kernels' former bound (every binned pair at all 256 pixels
    # of its tile) stands beside the restated one, and their device time
    # (profiler) beside the per-call time, which their wrappers' host work
    # now exceeds.
    record_keys = keys + ("full_tile_bound_ms", "device_ms")
    line = [
        {"name": "vf_raster_gbuffer", "route": "cuda", "source": src,
         "replaces": "vulkan_forge/_raster/pallas_backend.py:33",
         "launches": launches["vf_raster_gbuffer"], "max_abs_err": rec["gbuffer"]["err"],
         **{k: rec["gbuffer"][k] for k in record_keys}, "library_ms": None},
        {"name": "vf_raster_shade_shipped", "route": "cuda", "source": src,
         "replaces": "vulkan_forge/_raster/packed.py:755",
         "launches": launches["vf_raster_shade_shipped"], "max_abs_err": rec["shade"]["err"],
         **{k: rec["shade"][k] for k in record_keys}, "library_ms": None},
    ]
    replaces = {"vf_vtx_cover": "vulkan_forge/_raster/vtx.py:616",
                "vf_vtx_cover_big": "vulkan_forge/_raster/vtx.py:616",
                "vf_vtx_resolve_gbuffer": "vulkan_forge/_raster/vtx.py:590",
                "vf_vtx_resolve_shade_shipped": "vulkan_forge/_raster/vtx.py:616"}
    # The cover passes' former bound (the whole record for every triangle)
    # stands beside the restated one; the resolves' bound over this layout's
    # sectors and their device time (profiler) beside theirs.
    extra = ("full_setup_bound_ms", "sector_bound_ms", "device_ms")
    for name, _ in VTX_KERNELS:
        line.append({"name": name, "route": "cuda", "source": vsrc, "replaces": replaces[name],
                     "launches": launches[name], "max_abs_err": vtx_err[name],
                     **{k: vtx_rec[name][k] for k in keys + extra if k in vtx_rec[name]},
                     "library_ms": None})
    # K6 (packed.py:580) computes the winner id, K5 (packed.py:222) the
    # g-buffer; the cover passes and the resolve split that function so.
    replaces = {"vf_packed_cover": "vulkan_forge/_raster/packed.py:580",
                "vf_packed_cover_big": "vulkan_forge/_raster/packed.py:580",
                "vf_packed_resolve_gbuffer": "vulkan_forge/_raster/packed.py:222"}
    for name, _ in PACKED_KERNELS:
        line.append({"name": name, "route": "cuda",
                     "source": "vulkan_forge_torch/csrc/packed.cu", "replaces": replaces[name],
                     "launches": launches[name], "max_abs_err": packed_err[name],
                     **{k: packed_rec[name][k] for k in keys + extra if k in packed_rec[name]},
                     "library_ms": None})
    # K1's hw branch (pallas_backend.py:78-80) serves the triangle; K7's hw
    # mode (strips.py:261-265) the terrain frames, shipped and extended.
    replaces = {"vf_raster_gbuffer_hw": "vulkan_forge/_raster/pallas_backend.py:33",
                "vf_raster_shade_shipped_hw": "vulkan_forge/_raster/strips.py:155"}
    for name, _ in HW_KERNELS:
        line.append({"name": name, "route": "cuda", "source": src, "replaces": replaces[name],
                     "launches": launches[name], "max_abs_err": hw_err[name],
                     **{k: hw_rec[name][k] for k in record_keys}, "library_ms": None})
    # K8 (segments.py:159); the shipped shader fused into the shading one.
    for name, _ in SEG_KERNELS:
        line.append({"name": name, "route": "cuda", "source": "vulkan_forge_torch/csrc/segments.cu",
                     "replaces": "vulkan_forge/_raster/segments.py:159",
                     "launches": launches[name], "max_abs_err": seg_err[name],
                     **{k: seg_rec[name][k] for k in keys + ("plain_at", "ms_band")},
                     "library_ms": None})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
