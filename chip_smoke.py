#!/usr/bin/env python3
"""Smoke run of vulkan_forge_torch on one CUDA card (an NVIDIA H100).

Usage, from the root of a checkout:  python3 chip_smoke.py [--profile]

Phases, each printing one line, in order:
  0. card: name and power limit (nvidia-smi), torch/CUDA/nvcc versions, TF32
     flags; requires a CUDA device of compute capability 9.0.
  1. build: compiles csrc/raster.cu, vtx.cu, packed.cu, segments.cu,
     fragment.cu and records.cu with nvcc (one process per source, started
     together) and prints the seconds and, per kernel,
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
  2f. vertex stage vs plain: vf_vs_fields (csrc/vtx.cu) against
     vtx.vs_fields_plain on the same CUDA tensors, both shaders, at the
     relight frame (a Renderer's 3601^2 mesh, texture and default camera,
     800x600) and at g1024 with 4 orbit cameras: every field bit for bit,
     NaN as NaN, one launch a call.
  2g. extended shader vs plain: vf_terrain_fs_extended (csrc/fragment.cu)
     against fragment.terrain_fs_extended_plain on the same CUDA tensors at
     the relight g-buffer (a Renderer's 3601^2 tile at 800x600, indexed
     route) and the poster's (the same at 7680x4320, segment walk), the
     normal spacing a number as render_rgba passes it: every word bit for
     bit, one launch a call; one render_rgba of each Renderer launches the
     port's kernels 5 and 17 times, the shader once.
  3. main path, slice 1: the public API on device="cuda"
     (make_terrain(800,600,128) render_rgba/render_png,
     Scene(160,120,32,"magma") with a height upload -- both name their grid
     and take the vtx route --, render_triangle_rgba(800,600),
     and the batched entry without grid_n, which takes any mesh through the
     record route, 2 cameras at g128); both record kernels' launch counters
     must advance, and vf_vs_fields' must read 4 (the vtx route's frames
     and the batch; in every main-path slice it reads one launch per frame
     batch on every route, the triangle's but, whose three vertices the
     record route's set-up takes as they are; the record set-up's chain,
     vf_rec_setup, launches exactly as kernels.rec_setup_launches says for
     each record frame batch, here the triangle and the batch, in 3d its
     three frames, in 3b, 3c and 3e never;
     vf_terrain_fs_extended's reads one launch per extended frame batch
     on every route: 0 here, 1 in 3b, 3 in 3c, 1 in 3d, 2 in 3e); each
     image is held to the same call on device="cpu"
     under the FS policy; after the counts are read, the triangle and the
     batch records again with evaluated items equal to the mirror's.
  3b. main path, slice 2: make_terrain(800,600,1024).render_rgba(), the
     batched entry with 4 orbit cameras at grid=1024, and one extended-
     shader frame at grid=1024, all on device="cuda"; every vertex-stream
     kernel's counter must advance and no record kernel may launch;
     vf_vs_fields 3. The single frames are held to device="cpu", the batch to the record route.
  3c. main path, slice 3: Renderer(800,600) on device="cuda" with
     add_terrain(DEM-2048, 30 m, x1.5, "terrain"), upload_height_r32f,
     set_sun, set_exposure, render_rgba and render_png, then render_rgba of
     a 3601^2 DEM (the SRTM 1" tile, T = 25.9M > 2^24); every indexed
     kernel's counter must advance and no record or vtx kernel may launch;
     vf_vs_fields 3.
     Both frames' g-buffers are held bit for bit to the record route's on
     the card (skipped if it cannot fit), a DEM-256 frame to device="cpu"
     under the FS policy; render_metrics must be filled in.
  3d. main path, slice 4: with VF_FILL_RULE=hw (set inside the phase and
     restored after) render_triangle_rgba(800,600),
     make_terrain(800,600,1024).render_rgba() and the Renderer's DEM-2048
     render_rgba() on device="cuda"; both hw kernels' counters must advance
     and no other kernel may launch but the record route's vertex stage and
     set-up (vf_vs_fields 2, vf_rec_setup its chain three times). The
     triangle and a Scene 160x120 g32
     are held to device="cpu" under the FS policy; after the counts are
     read, the three frames' hw records with evaluated items equal to the
     mirror's.
  3e. main path, slice 5: at 7680x4320 make_terrain(7680,4320,1024)
     .render_rgba() and Renderer.render_rgba() at DEM-2048 and DEM-3601
     on device="cuda"; both segment kernels' counters must advance and no
     other kernel may launch but vf_vs_fields, once a frame, and the
     set-up's chain, exactly as seg_setup_launches says for each frame (3
     to 3d, the twins and render_spike_frames launch it never). Each
     frame's g-buffer must equal the vtx or
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
     to 0 just before it (the three vtx kernels of the shaded path and
     vf_vs_fields must launch, no other), byte-equal to render_terrain_batch_u32 and to
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
  4g. the segment walk's set-up (kernels.seg_setup, the vf_seg_setup_*
     kernels of csrc/segments.cu) at 7680x4320, through the index buffer (a
     Renderer DEM-3601 at its default camera, the poster cell's frame) and
     on the grid (make_terrain g1024): held byte for byte to
     segments.setup_frame_plain on the same card tensors (records' bits,
     ids, bboxes, the seven tables, the walk axis), its launches exactly
     as seg_setup_launches says; at the Renderer's frame each set-up
     kernel's device ms (torch.profiler, per call it kept of 5) and the
     chain's (CUDA events) against its byte bound, the plain version's ms,
     and the frame on the segment route against the indexed route
     (render_rgba, in turns).
  4f. timing of the vertex stage: vf_vs_fields at 2f's shapes, both
     shaders: per call over 20 back-to-back launches (CUDA events), device
     time per launch (torch.profiler), vtx.vs_fields_plain's time, and the
     bound (bytes: xyuv, the distinct texels, the fields written).
  4h. timing of the extended shader: vf_terrain_fs_extended at 2g's
     g-buffers, as 4f times the vertex stage; the bound: 13 bytes of
     g-buffer and a 4-byte word a pixel, the LUT, the distinct texels the
     covered pixels read; 126 f32 operations a covered pixel.
  4i. the record route's set-up (kernels.rec_setup, the vf_rec_* kernels
     of csrc/records.cu) under the hw rule at the srtm1.relight_hw cell's
     frame (a Renderer DEM-3601 at 800x600, its default camera, the int32
     index buffer) and at make_terrain(800,600,1024)'s shipped frame (int64
     indices): held byte for byte to setup.rec_setup_plain on the same card
     tensors (records' bits, rows, offsets, boxes), its launches exactly as
     kernels.rec_setup_launches says; at the cell's frame each kernel's
     device ms (torch.profiler, per call it kept of 5) and the chain's ms
     between CUDA events (its one host read included) against its byte
     bound (rec_setup_bound), and the plain version's ms.
  5. profile, only with --profile: torch.profiler over 3 batches of each
     headline path (32 cameras g128 on the record route, 4 cameras g1024 on
     the vtx route); the device's busy share and the ops with the most
     device time. It runs after the main paths' launch counts are read.

  6. the last entry points, slice 14 (after the timing phases): python -m
     vulkan_forge_torch.bench as processes on the card -- the headline
     (g1024 x4, 800x600) twice, in turns with phase 4b's direct batch and
     with the bench's own window (bench.measure) in this process (bench,
     direct, in-process, in-process, direct, bench; 5 camera sets each),
     then VF_BENCH_GRID=128 (x32), VF_BENCH_DEM=2048 and VF_DENSE=record
     at g128 --, each run's stdout
     held to one JSON line with bench.py's metric for its environment, the
     route that ran (vtx, or record), device cuda, the card's nvidia-smi
     line, 5 reps, and its launches (counted in the process: each route
     kernel once per camera set, 6, vf_vs_fields too, and on the record
     route the set-up's chain, kernels.rec_setup_launches a set, no other
     kernel); then the five example
     twins (python -m vulkan_forge_torch.examples.<name> --device cuda)
     together in a temporary directory and again in-process in another:
     exit 0, the same printed lines (but the Renderer's timing metrics),
     PNG pixels equal, and the launches each twin makes (the triangles 2 of
     vf_raster_gbuffer and 2 of the set-up's chain, terrain 1 and
     terrain_normals_flip 2 of each indexed
     kernel, of vf_vs_fields and of vf_terrain_fs_extended, add_terrain
     none) in both runs.

  7. the lab kernels (csrc/lab.cu, built into a library of its own: its
     seconds and ptxas report): the four lab twins (python -m
     vulkan_forge_torch.lab.fs_ops, fs_chain, slab_copy, slab_transpose)
     as processes on the card, together, launches counted in each (each
     its own kernel only: 10, 1, 103, 9), their lines printed; then each
     kernel against its plain version on the card: every fs_ops op
     within the CUDA C++ Programming Guide's maximum ulp error against f64
     (lab/fs_ops.py GUIDE names the row), kernel against torch-CUDA
     reported; fs_chain's 15 rows bit-equal to the plain chain at the
     script's two pixels and 4096 seeded ones, and its u8f row equal to
     the probed channel's byte of shade_shipped's word; fs_chain
     --from-scene on each of its scenes (card and CPU bytes; the chain at
     any byte that differs, which must reproduce both images' bytes); the
     slab copy equal to plain at (32, 1024), (8, 384), (300, 4096) and the
     g1024 x4 fields as (28, 1048576), ragged columns refused; the
     transpose at (32, 128), (8, 384), (100, 70) and the loop at (128,
     128) x 4096 with and without it, exact; each with its per-call and
     device time, the plain version's, the library call's where one
     exists, and its bound. A line "lab_findings": (a) per op, kernel
     against torch-CUDA and both against f64; (b) per scene, the bytes
     that differ between card and CPU; (c) where some differ, the first
     intermediate that diverges; (d) the slab copy's times and the loop's
     ns per iteration with and without the transpose.
     Then the deposit probes: the five twins (python -m
     vulkan_forge_torch.lab.deposit_breakdown, deposit_trip,
     deposit_marginal, loop_floor, mosaic_facts) as processes one after
     another (each prints a single-block loop's time: processes share the
     card by time slices), launches counted (DEPOSIT_TWINS), their ns/step
     parsed for every body; vf_lab_step_loop against its plain version for
     all 32 bodies at 128 steps from a seeded scratch (bit for bit, out and
     final scratch, where no sum rounds; within 1e-5 of each element's
     scale for _bodies.SCALED), its ms and bound per body (LOOP_OPS);
     vf_lab_onehot_dot in each mode on E_exact's permutation and E1's
     one-hot (ffma bit-equal to plain, tf32 modes within DOT_TOLERANCE of
     sum |a||b|; ffma and tf32x3 keep every E_exact bit, tf32's mismatches
     reported); vf_lab_lane_ops equal to torch.roll and to the exponent in
     torch; vf_lab_slab_transpose at E2's three shapes; the SASS of each
     body's kernel (cuobjdump: its step loop's length); then the lines
     "lab_launch_split" (one slab_transpose call at (8, 128) cut into the
     parts of the lab's launch path: checks, the output's allocation,
     device test, raw stream, the ctypes call with the launch and
     cudaGetLastError), "lab_step_split" (a step-loop launch's fixed cost
     cut into the scratch's clone, the allocation and the launch) and
     "lab_floor" (lane_ops on (1, 32): the least a lab call costs, per
     call and on the device). Each lab kernel's per-call time is taken in
     turns with its library call. Findings (e) the products' f32 bits per
     mode, (f) the loop floor's ns per step, (g) the deposit bodies' ns per
     step, (h) the SASS loop lengths; then a line "lab_time" with the
     phase's seconds (the deposit probes' and the splits' apart).

Then a line that lists any device time whose profiler sessions all missed
(kernel_device_ms; that time is then queued_device_ms's: CUDA events around
launches queued behind a spin kernel), one JSON line with the per-kernel
record (an entry a kernel wrapper), and last the line {"ok": true, "device":
{...}}. Any failure raises and exits
nonzero. It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import bench
from vulkan_forge_torch import (_build, _camera, _colormap, _device, _formats, _io, _mesh,
                                _native, _renderer)
from vulkan_forge_torch._parity import (FS_MAX_FRACTION, VARYING_RTOL,
                                        assert_fs_policy, assert_gbuffer_close)
from vulkan_forge_torch._raster import (fragment, hw_oracle, kernels, packed, pipeline,
                                        segments, setup, tiles, transform, vtx)
from vulkan_forge_torch.lab import _bodies as lab_bodies
from vulkan_forge_torch.lab import _kernels as lab_kernels
from vulkan_forge_torch.lab import deposit_breakdown as lab_breakdown
from vulkan_forge_torch.lab import fs_chain as lab_fs_chain
from vulkan_forge_torch.lab import fs_ops as lab_fs_ops
from vulkan_forge_torch.lab import mosaic_facts as lab_facts
from vulkan_forge_torch.lab import slab_copy as lab_slab_copy
from vulkan_forge_torch.lab import slab_transpose as lab_slab_transpose

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
W, H, GRID, BATCH, REPS = 800, 600, 128, 32, 5
VGRID, VBATCH = 1024, 4                # bench.py:44,51: the headline scene
SWEEP_GRIDS = (8, 16, 32, 64, 128, 256, 512, 1024)

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores.
PEAK_BYTES, PEAK_F32, PEAK_TF32 = 3.35e12, 67e12, 495e12
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
PROFILE_ATTEMPTS = 12
# Spin cycles queued ahead of a timed burst of launches (torch.cuda._sleep):
# ~10 ms at the H100's clock, longer than the host takes to enqueue a burst.
QUEUE_SPIN_CYCLES = 20_000_000
# The kernel_device_ms calls whose profiler sessions all missed.
PROFILER_FALLBACKS = []


def queued_device_ms(fn, calls=KERNEL_INNER):
    """Device milliseconds per call of fn() from CUDA events around ``calls``
    calls queued behind a spin kernel: the device runs them back to back
    while the host enqueues them, so the host's work per call is hidden
    (the gaps between launches are not)."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def kernel_device_ms(fn, key="raster_kernel", calls=KERNEL_INNER):
    """Device milliseconds per launch of the kernel whose name holds ``key``
    over ``calls`` calls of fn (torch.profiler, the mean over the launches
    it recorded): the kernel alone, without its wrapper's host work, which
    CUDA events around back-to-back calls include once a kernel is shorter
    than that work (the record kernels since their redesign)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    # Sessions on the card drop activity records: some keep part of the
    # launches, and late in a long run several in a row have kept none
    # (phases 4b and 4d). Retries that alternate the set-up recovered every
    # such miss seen; should PROFILE_ATTEMPTS sessions all miss, the time is
    # queued_device_ms's, and PROFILER_FALLBACKS says so.
    setups = ([ProfilerActivity.CPU, ProfilerActivity.CUDA], [ProfilerActivity.CUDA])
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=setups[attempt % 2]) as prof:
            for _ in range(calls):
                fn()
            sync()
        ev = [a for a in prof.key_averages() if key in a.key]
        seen = sum(a.count for a in ev)
        if seen:
            break
    if seen > calls:
        raise AssertionError(f"the profiler recorded {seen} {key} launches in {calls} calls")
    if not seen:
        ms = queued_device_ms(fn, calls)
        PROFILER_FALLBACKS.append({"key": key, "profiler_sessions": PROFILE_ATTEMPTS,
                                   "queued_events_ms": ms})
        return ms
    return sum(a.self_device_time_total for a in ev) / seen / 1e3


def orbit_eyes(n, phase=0.0):
    """The eyes of n cameras orbiting the spike terrain (bench.py:55-67)."""
    angles = (2.0 * math.pi * i / max(n, 1) + phase for i in range(n))
    return [(3.0 * math.cos(a), 2.0 + 0.1 * math.sin(phase), 3.0 * math.sin(a))
            for a in angles]


def orbit_cameras(n, width, height, phase=0.0):
    """n cameras orbiting the spike terrain, looking at the origin: fovy 45,
    near 0.1, far 100 (render_spike_frames' defaults); the bench's
    (bench.py:55-67, bit for bit)."""
    return bench.orbit_cameras(n, phase, width, height)


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
    nvcc = subprocess.run([_build.nvcc(), "--version"], check=True,
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
           ("seg_kernelILb1", "vf_seg_shade_shipped"),
           ("vs_fields_kernelILb0", "vf_vs_fields, extended"),
           ("vs_fields_kernelILb1", "vf_vs_fields, shipped"),
           ("seg_bbox_kernelILb0", "vf_seg_setup_bbox, indexed"),
           ("seg_bbox_kernelILb1", "vf_seg_setup_bbox, grid"),
           ("seg_init_kernel", "vf_seg_setup_init"),
           ("seg_count_kernelILb0", "vf_seg_setup_count, rows"),
           ("seg_count_kernelILb1", "vf_seg_setup_count, columns"),
           ("seg_scan_kernel", "vf_seg_setup_scan (1024 threads)"),
           ("seg_bin_kernelILb0", "vf_seg_setup_bin, rows"),
           ("seg_bin_kernelILb1", "vf_seg_setup_bin, columns"),
           ("seg_tables_kernel", "vf_seg_setup_tables"),
           ("seg_prefix_kernel", "vf_seg_setup_prefix"),
           ("seg_compact_kernelILb0ELb0", "vf_seg_setup_compact, rows, indexed"),
           ("seg_compact_kernelILb0ELb1", "vf_seg_setup_compact, rows, grid"),
           ("seg_compact_kernelILb1ELb0", "vf_seg_setup_compact, columns, indexed"),
           ("seg_compact_kernelILb1ELb1", "vf_seg_setup_compact, columns, grid"),
           ("terrain_fs_extended_kernelILb0", "vf_terrain_fs_extended, by pixel"),
           ("terrain_fs_extended_kernelILb1", "vf_terrain_fs_extended, vectors"),
           ("rec_count_kernelIiLb0E", "vf_rec_setup_count, int32, inclusive"),
           ("rec_count_kernelIiLb1E", "vf_rec_setup_count, int32, hw"),
           ("rec_count_kernelIxLb0E", "vf_rec_setup_count, int64, inclusive"),
           ("rec_count_kernelIxLb1E", "vf_rec_setup_count, int64, hw"),
           ("rec_totals_kernel", "vf_rec_setup_totals (1024 threads)"),
           ("rec_emit_kernelIiLb0E", "vf_rec_setup_emit, int32, inclusive"),
           ("rec_emit_kernelIiLb1E", "vf_rec_setup_emit, int32, hw"),
           ("rec_emit_kernelIxLb0E", "vf_rec_setup_emit, int64, inclusive"),
           ("rec_emit_kernelIxLb1E", "vf_rec_setup_emit, int64, hw"),
           ("rec_sort_count_kernel", "vf_rec_sort_count"),
           ("rec_sort_scan_kernel", "vf_rec_sort_scan (1024 threads)"),
           ("rec_sort_scatter_kernel", "vf_rec_sort_scatter"),
           ("rec_offsets_kernel", "vf_rec_setup_offsets"))


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


def ptxas_summary(log, entries=ENTRIES):
    """Per kernel: registers, shared memory, stack and spills from ptxas -v,
    and the blocks per SM they allow."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((name for key, name in entries if key in ln), ln.split("'")[1])
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
    every = RECORD_KERNELS + VS_KERNELS + SEG_SETUP_KERNELS + FS_KERNELS + REC_SETUP_KERNELS
    for _, fn in every:
        fn.launches = 0

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
    launches = {name: fn.launches for name, fn in every}
    for name, _ in RECORD_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched {name}")
    for name, _ in SEG_SETUP_KERNELS:
        if launches[name] != 0:
            raise AssertionError(f"slice 1's main path launched {name}")
    # The vtx route's frames: the spike's render_rgba and render_png and the
    # Scene's; the batch without grid_n takes the record route after the
    # same vertex stage, the triangle that route without it.
    check_vs_launches(launches, 4, "slice 1's main path")
    check_rec_setup_launches(launches, [1, 2], "slice 1's main path")
    check_fs_launches(launches, 0, "slice 1's main path")    # shipped frames only
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
# The vertex stage of every terrain route (csrc/vtx.cu): one launch per
# frame batch on each; the triangle's three vertices skip it.
VS_KERNELS = (("vf_vs_fields", kernels.vs_fields),)
# The record route's set-up (csrc/records.cu): kernels.rec_setup_launches
# per record frame batch.
REC_SETUP_KERNELS = (("vf_rec_setup", kernels.rec_setup),)
# The extended fragment shader: once per extended frame batch, on every
# route (the shipped shader is fused into each route's last kernel).
FS_KERNELS = (("vf_terrain_fs_extended", kernels.terrain_fs_extended),)


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
    every = (VTX_KERNELS + RECORD_KERNELS + VS_KERNELS + SEG_SETUP_KERNELS + FS_KERNELS
             + REC_SETUP_KERNELS)
    for _, fn in every:
        fn.launches = 0

    spike = vt.make_terrain(W, H, VGRID, device=dev)
    frame = spike.render_rgba()
    batch = pipeline.render_terrain_batch_u32(xyuv, idx, heights, views, projs,
                                              grid_n=VGRID, **batch_args(dev))
    ext = pipeline.render_terrain_u8(xyuv, idx, ext_h, spike._view, spike._proj, **ext_args)
    sync()
    launches = {name: fn.launches for name, fn in every}
    for name, _ in VTX_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"slice 2's main path never launched {name}")
    for name, _ in RECORD_KERNELS + SEG_SETUP_KERNELS + REC_SETUP_KERNELS:
        if launches[name] != 0:
            raise AssertionError(f"slice 2's main path launched the record kernel {name}")
    check_vs_launches(launches, 3, "slice 2's main path")    # frame, batch, extended frame
    check_fs_launches(launches, 1, "slice 2's main path")    # the extended frame

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


def bound_of(nbytes, ops, peak=PEAK_F32):
    """The least time for a kernel's work: the larger of its bytes over
    HBM's rate and its operations over the peak rate for their type (f32
    outside the tensor cores unless ``peak`` says otherwise); and what
    binds."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
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
    every = (PACKED_KERNELS + VTX_KERNELS + RECORD_KERNELS + VS_KERNELS + SEG_SETUP_KERNELS
             + FS_KERNELS + REC_SETUP_KERNELS)
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
    for name, _ in VTX_KERNELS + RECORD_KERNELS + SEG_SETUP_KERNELS + REC_SETUP_KERNELS:
        if launches[name] != 0:
            raise AssertionError(f"slice 3's main path launched {name}")
    # DEM-2048's render_rgba and render_png, the SRTM tile's render_rgba.
    check_vs_launches(launches, 3, "slice 3's main path")
    check_fs_launches(launches, 3, "slice 3's main path")

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
    every = (HW_KERNELS + RECORD_KERNELS + VTX_KERNELS + PACKED_KERNELS + VS_KERNELS
             + SEG_SETUP_KERNELS + FS_KERNELS + REC_SETUP_KERNELS)
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
    for name, _ in RECORD_KERNELS + VTX_KERNELS + PACKED_KERNELS + SEG_SETUP_KERNELS:
        if launches[name] != 0:
            raise AssertionError(f"slice 4's main path launched {name}")
    # hw: the record route alone, the vertex stage but for the triangle.
    check_vs_launches(launches, 2, "slice 4's main path")
    check_rec_setup_launches(launches, [1, 1, 1], "slice 4's main path")
    check_fs_launches(launches, 1, "slice 4's main path")   # the Renderer's frame
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
    mesh = lambda: (pipeline._f32(spike._xyuv, dev), pipeline._rec_indices(spike._indices, dev))
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
# The segment walk's set-up: one wrapper over the vf_seg_setup_* chain,
# counting each of its launches; only the segment route runs it.
SEG_SETUP_KERNELS = (("vf_seg_setup", kernels.seg_setup),)
LAB_KERNELS = (("vf_lab_fs_ops", lab_kernels.fs_ops),
               ("vf_lab_fs_chain", lab_kernels.fs_chain),
               ("vf_lab_slab_copy", lab_kernels.slab_copy),
               ("vf_lab_slab_transpose", lab_kernels.slab_transpose),
               ("vf_lab_step_loop", lab_kernels.step_loop),
               ("vf_lab_onehot_dot", lab_kernels.onehot_dot),
               ("vf_lab_lane_ops", lab_kernels.lane_ops))
ALL_KERNELS = (VTX_KERNELS + RECORD_KERNELS + PACKED_KERNELS + HW_KERNELS + SEG_KERNELS
               + SEG_SETUP_KERNELS + VS_KERNELS + FS_KERNELS + REC_SETUP_KERNELS + LAB_KERNELS)
POSTER = (7680, 4320)                      # 8K UHD: a print-size poster
MAP_TILE = (4096, 4096)                    # a 4096^2 map tile
SEG_CHECK = (256, 4352)                    # tall, yet small enough for the plain walk
SEG_GRID, SEG_DEM = 256, 512               # phase 2e's spike grid and DEM
real_use_segment_route = pipeline.use_segment_route


def spike_fields(spike, dev, views=None, projs=None):
    """The post-VS fields on ``dev`` of a TerrainSpike's frame (its camera,
    or the given ones)."""
    g = spike._globals
    if views is None:
        views, projs = spike._view[None], spike._proj[None]
    return vtx.vs_fields(tensor(spike._xyuv, dev), tensor(spike._heights, dev),
                         tensor(views, dev), tensor(projs, dev), tensor(g.spacing, dev),
                         tensor(g.exaggeration, dev), spike.width, spike.height)


def tall_spike_frame(spike, dev, views=None, projs=None, walk=None):
    """(fields, segment-walk inputs) on ``dev`` of a TerrainSpike's frame
    (its camera, or the given ones): pipeline.segment_frame on the vtx
    route's fields, or ``walk`` "rows" or "columns" forced."""
    w, h = spike.width, spike.height
    fields = spike_fields(spike, dev, views, projs)
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


def seg_setup_launches(n_tris, row_size, valid):
    """kernels.seg_setup's launches for one frame: the bbox pass, per walk
    axis (segments.walk_streams) the init and the prefix and four more
    over a non-empty stream, the compaction where a triangle is valid."""
    walks = segments.walk_streams(n_tris, row_size)
    return (n_tris > 0) + sum(2 + 4 * (w.length > 0) for w in walks) + (valid > 0)


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
    card. Only the segment kernels and the set-up's may launch, the
    set-up's exactly as often as ``seg_setup_launches`` says for each
    frame; each frame's g-buffer is held bit for bit to the vtx or indexed
    route's on the same frame, and its image to that route's under the FS
    policy; each frame's kernels are held to their plain version on a band
    of its tile rows (``band_check``). Returns the launch counts and each
    frame's ``band_check``."""
    w, h = POSTER
    frames = poster_frames(dev)
    every = (SEG_KERNELS + SEG_SETUP_KERNELS + RECORD_KERNELS + HW_KERNELS + VTX_KERNELS
             + PACKED_KERNELS + VS_KERNELS + FS_KERNELS + REC_SETUP_KERNELS)
    out, peak, band, setup_launches = {}, {}, {}, {}
    for _, fn in every:
        fn.launches = 0
    for label, (_, render) in frames.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n = kernels.seg_setup.launches
        out[label] = render()
        sync()
        setup_launches[label] = kernels.seg_setup.launches - n
        peak[label] = int(torch.cuda.max_memory_allocated())
    launches = {name: fn.launches for name, fn in every}
    for name, _ in SEG_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"slice 5's main path never launched {name}")
    for name, _ in (RECORD_KERNELS + HW_KERNELS + VTX_KERNELS + PACKED_KERNELS
                    + REC_SETUP_KERNELS):
        if launches[name] != 0:
            raise AssertionError(f"slice 5's main path launched {name}")
    check_vs_launches(launches, len(frames), "slice 5's main path")
    check_fs_launches(launches, sum(label.startswith("Renderer") for label in frames),
                      "slice 5's main path")

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
            n_tris, row_size = vtx.n_triangles(VGRID), 2 * (VGRID - 1)
        else:
            fields, tris, frame = tall_renderer_frame(obj)
            got = kernels.seg_gbuffer(*frame, 1, w, h)
            want = packed.render_gbuffer_packed_batch(fields, tris, w, h)
            old = fragment.terrain_fs_extended(*want, *renderer_shading(obj))
            n_tris, row_size = tris.shape[0], 2 * (obj._terrain.width - 1)
        sync()
        expected = seg_setup_launches(n_tris, row_size, frame[0].shape[0])
        if setup_launches[label] != expected:
            raise AssertionError(f"{label}: vf_seg_setup launched {setup_launches[label]} "
                                 f"times, expected {expected}")
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
                         "setup_launches": setup_launches[label],
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
    ``reps`` after a warm-up): vertex stage, set-up (kernels.seg_setup:
    records, walk order, compaction), kernel, shader, readback."""
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
    names = ("vertex_stage", "setup", "kernel", "shader", "readback")
    rows = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        fields = vtx.vs_fields(mesh[0], mesh[1], tensor(view[None], dev),
                               tensor(proj[None], dev), mesh[2], mesh[3], w, h, fs_mode)
        ev[1].record()
        *frame, columns = kernels.seg_setup(fields, None if spike else tris,
                                            grid if spike else None, w, h, rs)
        frame = segments.stack_frames([frame])
        ev[2].record()
        if spike:
            img = kernels.seg_shade_shipped(*frame, 1, w, h, *shade)
            ev[3].record()
            ev[4].record()
        else:
            gbuf = kernels.seg_gbuffer(*frame, 1, w, h)
            ev[3].record()
            img = fragment.terrain_fs_extended(*gbuf, *shade)
            ev[4].record()
        _formats.u32_image_to_rgba_u8(img[0]).cpu().numpy()
        ev[5].record()
        sync()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
        del fields, frame, img
    return ({n: statistics.median(r[i] for r in rows[1:]) for i, n in enumerate(names)},
            "column-major" if columns else "row-major")


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




# The set-up's kernels (csrc/segments.cu), as the profiler names them.
SETUP_NAMES = ("seg_bbox_kernel", "seg_init_kernel", "seg_count_kernel", "seg_scan_kernel",
               "seg_bin_kernel", "seg_tables_kernel", "seg_prefix_kernel", "seg_compact_kernel")


def setup_bound(n_tris, n_vertices, valid):
    """The set-up's least time: its inputs read once (the fields' 7 planes,
    the index buffer) and its outputs written once (the compacted records,
    ids and bboxes; the tables are ~0.1% of it), at HBM's rate; and the
    bytes its chain moves (``design_bytes``): fields and indices read twice,
    the bbox written once and read about three times, the outputs."""
    inputs = vtx.FIELDS * 4 * n_vertices + 12 * n_tris
    outputs = valid * (setup.REC_WIDTH * 4 + 4 + 16)
    return {**bound_of(inputs + outputs, 0),
            "design_bytes": 2 * inputs + 4 * 16 * n_tris + outputs}


def setup_against_plain(args, label):
    """kernels.seg_setup(*args) held byte for byte to
    segments.setup_frame_plain(*args) on the same card tensors (records'
    bits, ids, bboxes, the seven tables, the walk axis) and its launches to
    ``seg_setup_launches``. Returns (valid records, column-major walk,
    launches)."""
    fields, indices, grid_n, w, h, row_size = args
    n = kernels.seg_setup.launches
    got = kernels.seg_setup(*args)
    sync()
    launches = kernels.seg_setup.launches - n
    want = segments.setup_frame_plain(*args)
    sync()
    names = ("records", "ids", "bbox") + segments.SegmentBinning._fields
    pairs = list(zip(got[:3], want[:3])) + list(zip(got[3], want[3]))
    equal = {name: a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        *(x.view(torch.int32) if x.dtype == torch.float32 else x for x in (a, b)))
        for name, (a, b) in zip(names, pairs)}
    equal["columns"] = got[4] == want[4]
    if not all(equal.values()):
        raise AssertionError(f"{label}: the set-up kernels differ from the plain version: "
                             f"{equal}")
    n_tris = vtx.n_triangles(grid_n) if indices is None else indices.shape[0]
    expected = seg_setup_launches(n_tris, row_size, got[0].shape[0])
    if launches != expected:
        raise AssertionError(f"{label}: vf_seg_setup launched {launches} times, "
                             f"expected {expected}")
    out = got[0].shape[0], got[4], launches
    del got, want, pairs
    torch.cuda.empty_cache()
    return out


def phase4g_seg_setup(smi, dev):
    """The segment walk's set-up at the poster's shape: held to its plain
    version through the index buffer (a Renderer DEM-3601, the poster
    cell's frame) and on the grid (make_terrain g1024); its kernels' and
    its chain's time on the Renderer's frame against its bound and the
    plain version's; the frame on the segment route against the indexed
    route. Returns the kernels line's record."""
    w, h = POSTER
    spike = vt.make_terrain(w, h, VGRID, device=dev)
    fields = spike_fields(spike, dev)
    cases = {f"spike g{VGRID}": setup_against_plain(
        (fields, None, VGRID, w, h, 2 * (VGRID - 1)), f"spike g{VGRID}")}
    del spike, fields
    r = make_renderer(SRTM, dev, seed=1, size=POSTER)
    terr = r._terrain
    xyuv, tris = _renderer.grid_mesh(terr.width, terr.height, *terr.spacing, dev)
    view, proj = r._default_terrain_camera(terr)
    one = tensor(1.0, dev)
    fields = vtx.vs_fields(xyuv, r._height_tex, tensor(view[None], dev),
                           tensor(proj[None], dev), one, one, w, h, "extended")
    args = (fields, tris, None, w, h, 2 * (terr.width - 1))
    label = f"Renderer DEM-{SRTM}"
    cases[label] = setup_against_plain(args, label)
    valid = cases[label][0]

    from torch.profiler import ProfilerActivity, profile
    calls = 5
    kernels.seg_setup(*args)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kernels.seg_setup(*args)
        sync()
    total = {k: 0.0 for k in SETUP_NAMES}
    seen = {k: 0 for k in SETUP_NAMES}
    for a in prof.key_averages():
        for k in SETUP_NAMES:
            if k in a.key:
                total[k] += a.self_device_time_total / 1e3
                seen[k] += a.count
    # Per call over the calls the trace kept (one bbox pass a call): the
    # profiler may drop one of the window's calls.
    kept = seen["seg_bbox_kernel"]
    per = {k: t / kept for k, t in total.items()} if kept else {}
    chain_ms = cuda_ms(lambda: kernels.seg_setup(*args), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: segments.setup_frame_plain(*args), reps=3, warmup=1)
    bound = setup_bound(tris.shape[0], fields.shape[2], valid)
    del fields, xyuv, tris, args
    torch.cuda.empty_cache()

    times = {"segment": [], "indexed": []}
    for route in ("segment", "indexed", "indexed", "segment"):
        pipeline.use_segment_route = (real_use_segment_route if route == "segment"
                                      else lambda *a: False)
        try:
            r.render_rgba()
            sync()
            times[route] += host_ms(r.render_rgba, [()] * 5)
        finally:
            pipeline.use_segment_route = real_use_segment_route
    device_ms = sum(per.values())
    rec = {"ms": chain_ms, "device_ms": device_ms, "plain_ms": plain_ms, **bound,
           "bound_share": bound["bound_ms"] / device_ms if device_ms else None,
           "at": f"Renderer({w},{h}) DEM-{SRTM}, default camera, row_size {2 * (terr.width - 1)}"}
    say("seg_setup", card=smi, config=rec["at"], cases={
        k: {"equal": True, "valid": v, "walk": "column-major" if c else "row-major",
            "launches": n} for k, (v, c, n) in cases.items()},
        kernel_device_ms=per, kernel_launches_seen=seen, calls=calls, calls_kept=kept, **rec,
        routes={route: {"median_ms": float(np.percentile(t, 50)), "n": len(t), "all_ms": t}
                for route, t in times.items()},
        routes_config="render_rgba with readback, in turns (segment, indexed, indexed, "
        "segment; 5 calls each after a warm-up)")
    del r
    torch.cuda.empty_cache()
    return rec


# ---------------- the vertex stage (vf_vs_fields) ----------------

# f32 operations of vf_vs_fields, counted from csrc/vtx.cu: per vertex the
# texel index (per axis a multiply, floor, two compares and the NaN test),
# the spacing clamp and the world position (VS_OPS_VERTEX), the shipped
# shader's relief besides (sinf, cosf, four multiplies, two adds:
# VS_OPS_RELIEF); per vertex and frame the two 4x4 products (16 multiplies
# and 12 adds each) and clip_to_fb (abs, compare, 3 divides, 6 multiplies
# and adds): VS_OPS_FRAME.
VS_OPS_VERTEX, VS_OPS_RELIEF, VS_OPS_FRAME = 15, 8, 67


def check_vs_launches(launches, calls, label):
    """vf_vs_fields launched once per terrain frame batch, ``calls`` of them
    (the triangle's vertices skip it)."""
    if launches["vf_vs_fields"] != calls:
        raise AssertionError(f"{label}: vf_vs_fields launched {launches['vf_vs_fields']} "
                             f"times, expected {calls}")


def check_rec_setup_launches(launches, batches, label):
    """The record set-up's chain launched as kernels.rec_setup_launches says
    for record frame batches of ``batches`` frames at W x H, each with a
    binned triangle."""
    want = sum(kernels.rec_setup_launches(b, W, H, True) for b in batches)
    if launches["vf_rec_setup"] != want:
        raise AssertionError(f"{label}: vf_rec_setup launched {launches['vf_rec_setup']} "
                             f"times, expected {want}")


def vs_shapes(dev):
    """The vertex stage's inputs (xyuv, heights, views, projs, spacing,
    exaggeration) at the main path's shapes, one shape at a time: the
    relight frame (a Renderer's own 3601^2 mesh, height texture and default
    camera at 800x600, as each srtm1.relight call draws it) and the
    headline batch (the g1024 spike grid, its 1x1 zero texture, 4 orbit
    cameras and make_terrain's spacing and exaggeration)."""
    xyuv, _, heights, views, projs = renderer_frame(make_renderer(SRTM, dev, seed=1))
    one = tensor(1.0, dev)
    yield f"relight DEM-{SRTM} x1", (xyuv, heights, views, projs, one, one)
    del xyuv, heights
    torch.cuda.empty_cache()
    views, projs = orbit_cameras(VBATCH, W, H, phase=0.7)
    a = batch_args(dev)
    yield f"spike g{VGRID} x{VBATCH}", (
        tensor(_mesh.build_grid_xyuv(VGRID)[0], dev), tensor(np.zeros((1, 1)), dev),
        tensor(views, dev), tensor(projs, dev), tensor(a["spacing"], dev),
        tensor(a["exaggeration"], dev))


def vs_bound(args, fs_mode):
    """bound_of vf_vs_fields on these inputs: 16 bytes of xyuv per vertex,
    the distinct texels read (4 bytes each), the fields written (7 f32 per
    vertex and frame); VS_OPS_* operations."""
    n, frames = args[0].shape[0], args[2].shape[0]
    nbytes = n * 16 + 4 * min(n, args[1].numel()) + frames * n * vtx.FIELDS * 4
    ops = n * (VS_OPS_VERTEX + VS_OPS_RELIEF * (fs_mode == "shipped") + frames * VS_OPS_FRAME)
    return bound_of(nbytes, ops)


def phase2f_vs_kernel(dev):
    """vf_vs_fields against vs_fields_plain on the same CUDA tensors at the
    main path's shapes, both shaders: every field bit for bit (NaN as NaN),
    one launch a call. Returns its max_abs_err (0.0: any difference
    raises)."""
    cases = {}
    for label, args in vs_shapes(dev):
        for mode in ("extended", "shipped"):
            n = kernels.vs_fields.launches
            got = kernels.vs_fields(*args, W, H, mode)
            sync()
            if kernels.vs_fields.launches != n + 1:
                raise AssertionError(f"{label} {mode}: {kernels.vs_fields.launches - n} "
                                     "vf_vs_fields launches in one call")
            want = vtx.vs_fields_plain(*args, W, H, mode)
            differ = got.view(torch.int32) != want.view(torch.int32)
            count = int(differ.sum())
            if count:
                b, k, v = (int(i) for i in differ.nonzero()[0])
                raise AssertionError(
                    f"{label} {mode}: vf_vs_fields differs from vs_fields_plain in {count} "
                    f"values; first frame {b}, field {k}, vertex {v}: {float(got[b, k, v])!r} "
                    f"against {float(want[b, k, v])!r}")
            cases[f"{label} {mode}"] = {"vertices": args[0].shape[0],
                                        "frames": args[2].shape[0], "bit_equal": True,
                                        "nan_values": int(torch.isnan(got).sum())}
            del got, want, differ
    torch.cuda.empty_cache()
    say("vs_kernel_vs_plain", tolerance="every field bit for bit, NaN as NaN", cases=cases)
    return 0.0


def phase4f_vs_timing(smi, dev):
    """vf_vs_fields at the main path's shapes, both shaders: per call over
    20 back-to-back launches (CUDA events), device time per launch
    (torch.profiler), the plain version's time and the bound (vs_bound).
    Returns the kernels line's record: the relight frame, extended (what
    each srtm1.relight call runs), and every case under ``cases``."""
    cases = {}
    for label, args in vs_shapes(dev):
        for mode in ("extended", "shipped"):
            kern = lambda: kernels.vs_fields(*args, W, H, mode)
            rec = {"ms": cuda_ms(kern, inner=KERNEL_INNER),
                   "device_ms": kernel_device_ms(kern, key="vs_fields_kernel"),
                   "plain_ms": cuda_ms(lambda: vtx.vs_fields_plain(*args, W, H, mode)),
                   **vs_bound(args, mode)}
            rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
            cases[f"{label} {mode}"] = rec
    torch.cuda.empty_cache()
    at = f"relight DEM-{SRTM} x1 extended"
    say("vs_timing", card=smi, config=f"{W}x{H}; kernel: 20 back-to-back launches, median of "
        f"{REPS}; device_ms: torch.profiler per launch; plain: vtx.vs_fields_plain, median of "
        f"{REPS} calls", kernel_ms=cases)
    return {**cases[at], "at": at, "cases": cases}


# ---------------- the extended shader (vf_terrain_fs_extended) ----------------

# f32 operations of vf_terrain_fs_extended at one covered pixel, counted
# from csrc/fragment.cu as vfbench/roofline.py's EXTENDED_SHADE_OPS counts
# them: height normalisation 4, bilinear LUT 21, texel indices 10,
# neighbours 8, steps 4, two slopes 10, normal length 6, Lambert 7, ambient
# 2, exposure and Reinhard 12, sRGB encode 24, quantisation 18.
FS_OPS = 126
# Port launches of one Renderer.render_rgba call on each route: the vertex
# stage, the indexed route's three kernels or the segment route's set-up
# chain (14 a frame) and walk, and the extended shader.
RENDERER_CALL_LAUNCHES = {"indexed": 1 + 3 + 1, "segment": 1 + 14 + 1 + 1}


def check_fs_launches(launches, calls, label):
    """vf_terrain_fs_extended launched once per extended frame batch,
    ``calls`` of them, on whatever route drew the g-buffer."""
    if launches["vf_terrain_fs_extended"] != calls:
        raise AssertionError(f"{label}: vf_terrain_fs_extended launched "
                             f"{launches['vf_terrain_fs_extended']} times, expected {calls}")


def fs_shapes(dev):
    """The extended shader's inputs at the two cells' shapes, one at a
    time: (label, route, renderer, g-buffer, shading arguments with the
    normal spacing as render_rgba passes it, a number). Relight: a
    Renderer's 3601^2 tile at 800x600 through the indexed route; the
    poster: the same tile at 7680x4320 through the segment walk."""
    r = make_renderer(SRTM, dev, seed=1)
    xyuv, tris, heights, views, projs = renderer_frame(r)
    gbuf = packed.render_gbuffer_packed_batch(frame_fields(xyuv, heights, views, projs), tris,
                                              W, H)
    del xyuv, tris
    shade = renderer_shading(r)
    yield f"relight DEM-{SRTM} {W}x{H}", "indexed", r, gbuf, (*shade[:6], DEM_SPACING[0],
                                                                 shade[7])
    del r, gbuf, shade
    torch.cuda.empty_cache()
    w, h = POSTER
    r = make_renderer(SRTM, dev, seed=1, size=POSTER)
    _, _, frame = tall_renderer_frame(r)
    gbuf = kernels.seg_gbuffer(*frame, 1, w, h)
    del frame
    shade = renderer_shading(r)
    yield f"poster DEM-{SRTM} {w}x{h}", "segment", r, gbuf, (*shade[:6], DEM_SPACING[0],
                                                               shade[7])
    del r, gbuf, shade
    torch.cuda.empty_cache()


def fs_plain(gbuf, shade):
    """terrain_fs_extended_plain on the same tensors, the numeric spacing as
    a tensor on their device."""
    *rest, sp, ex = shade
    return fragment.terrain_fs_extended_plain(*gbuf, *rest, tensor(sp, gbuf[0].device), ex)


def fs_bound(gbuf, shade):
    """bound_of vf_terrain_fs_extended on this g-buffer: 13 bytes of
    g-buffer read and a 4-byte word written a pixel, the LUT, the distinct
    texels the covered pixels read (4 bytes each); FS_OPS a covered pixel."""
    _, u, v, mask = gbuf
    heights = shade[1]
    ht, wt = heights.shape
    tx = torch.clamp(torch.floor(u[mask] * wt), 0, wt - 1).long()
    ty = torch.clamp(torch.floor(v[mask] * ht), 0, ht - 1).long()
    seen = torch.zeros(ht * wt, dtype=torch.bool, device=u.device)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        seen[torch.clamp(ty + dy, 0, ht - 1) * wt + torch.clamp(tx + dx, 0, wt - 1)] = True
    covered, texels = int(mask.sum()), int(seen.sum())
    nbytes = mask.numel() * (13 + 4) + 256 * 4 * 4 + texels * 4
    return {**bound_of(nbytes, covered * FS_OPS), "covered": covered, "texels": texels}


def phase2g_fs_kernel(dev):
    """vf_terrain_fs_extended against terrain_fs_extended_plain on the same
    CUDA tensors at relight's and the poster's g-buffers: every word bit
    for bit, one launch a call; one render_rgba of each Renderer launches
    the port's kernels RENDERER_CALL_LAUNCHES times, the shader once.
    Returns its max_abs_err (0.0: any difference raises)."""
    cases = {}
    for label, route, r, gbuf, shade in fs_shapes(dev):
        n = kernels.terrain_fs_extended.launches
        got = kernels.terrain_fs_extended(*gbuf, *shade)
        sync()
        if kernels.terrain_fs_extended.launches != n + 1:
            raise AssertionError(f"{label}: {kernels.terrain_fs_extended.launches - n} "
                                 "vf_terrain_fs_extended launches in one call")
        want = fs_plain(gbuf, shade)
        differ = got.view(torch.int32) != want.view(torch.int32)
        count = int(differ.sum())
        if count:
            b, y, x = (int(i) for i in differ.nonzero()[0])
            raise AssertionError(
                f"{label}: vf_terrain_fs_extended differs from terrain_fs_extended_plain in "
                f"{count} words; first frame {b}, pixel ({x}, {y}): "
                f"{int(got.view(torch.int32)[b, y, x]):#010x} against "
                f"{int(want.view(torch.int32)[b, y, x]):#010x}")
        del got, want, differ
        before = {name: fn.launches for name, fn in ALL_KERNELS}
        r.render_rgba()
        sync()
        moved = {name: fn.launches - before[name] for name, fn in ALL_KERNELS
                 if fn.launches != before[name]}
        if sum(moved.values()) != RENDERER_CALL_LAUNCHES[route] \
                or moved.get("vf_terrain_fs_extended") != 1:
            raise AssertionError(f"{label}: render_rgba launched {moved}, expected "
                                 f"{RENDERER_CALL_LAUNCHES[route]} in all, the shader once")
        cases[label] = {"pixels": gbuf[3].numel(), "covered": int(gbuf[3].sum()),
                        "bit_equal": True, "render_rgba_launches": moved}
    say("fs_kernel_vs_plain", tolerance="every word bit for bit", cases=cases)
    return 0.0


def phase4h_fs_timing(smi, dev):
    """vf_terrain_fs_extended at relight's and the poster's g-buffers: per
    call over 20 back-to-back launches (CUDA events), device time per
    launch (torch.profiler), the plain torch shader's time and the bound
    (fs_bound). Returns the kernels line's record: the poster (the cell
    whose frame time it moved most), both cases under ``cases``."""
    cases = {}
    for label, _, _, gbuf, shade in fs_shapes(dev):
        kern = lambda: kernels.terrain_fs_extended(*gbuf, *shade)
        rec = {"ms": cuda_ms(kern, inner=KERNEL_INNER),
               "device_ms": kernel_device_ms(kern, key="terrain_fs_extended_kernel"),
               "plain_ms": cuda_ms(lambda: fs_plain(gbuf, shade)), **fs_bound(gbuf, shade)}
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        cases[label] = rec
    at = f"poster DEM-{SRTM} {POSTER[0]}x{POSTER[1]}"
    say("fs_timing", card=smi, config=f"kernel: 20 back-to-back launches, median of {REPS}; "
        f"device_ms: torch.profiler per launch; plain: terrain_fs_extended_plain, median of "
        f"{REPS} calls", kernel_ms=cases)
    return {**cases[at], "at": at, "cases": cases}


# ---------------- the record route's set-up (vf_rec_*) ----------------

REC_SETUP_NAMES = ("rec_count_kernel", "rec_totals_kernel", "rec_emit_kernel",
                   "rec_sort_count_kernel", "rec_sort_scan_kernel", "rec_sort_scatter_kernel",
                   "rec_offsets_kernel")


def rec_setup_bound(fields, indices, records, binning, passes):
    """The record set-up's least time: its inputs read once (the index
    buffer, the four position planes, the binned triangles' varyings) and
    its outputs written once (the records, each pair's row and box, the
    offsets), at HBM's rate; and the bytes its chain moves
    (``design_bytes``): besides, the binned triangles' corners and indices
    read again, the binned bits written and read, and the pairs' keys, rows
    and boxes read and written once a sort pass."""
    n_tris, nv = indices.shape[0], fields.shape[2]
    frames, binned, pairs = fields.shape[0], records.shape[0], binning.rows.numel()
    idx_row = 3 * indices.element_size()
    inputs = frames * (4 * 4 * nv + idx_row * n_tris) + binned * 3 * 3 * 4
    outputs = binned * setup.REC_WIDTH * 4 + pairs * 8 + binning.offsets.numel() * 4
    chain = (inputs + binned * (idx_row + 3 * vtx.FIELDS * 4) + 2 * frames * n_tris // 8
             + pairs * 4 + passes * pairs * (4 + 2 * 12) + outputs)
    return {**bound_of(inputs + outputs, 0), "design_bytes": chain}


def rec_setup_against_plain(args, label):
    """kernels.rec_setup(*args) held byte for byte to setup.rec_setup_plain(
    *args) on the same card tensors (records' bits, rows, offsets, boxes)
    and its launches to kernels.rec_setup_launches. Returns (binned
    records, pairs, launches)."""
    fields, indices, w, h, rule = args
    n = kernels.rec_setup.launches
    got = kernels.rec_setup(*args)
    sync()
    launches = kernels.rec_setup.launches - n
    want = setup.rec_setup_plain(*args)
    sync()
    pairs = [("records", got[0], want[0])] + [
        (name, getattr(got[1], name), getattr(want[1], name)) for name in setup.Binning._fields]
    equal = {name: a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        *(x.view(torch.int32) if x.dtype == torch.float32 else x for x in (a, b)))
        for name, a, b in pairs}
    if not all(equal.values()):
        raise AssertionError(f"{label}: the record set-up differs from the plain version: "
                             f"{equal}")
    binned = got[0].shape[0]
    expected = kernels.rec_setup_launches(fields.shape[0], w, h, binned > 0)
    if launches != expected:
        raise AssertionError(f"{label}: vf_rec_setup launched {launches} times, "
                             f"expected {expected}")
    out = binned, got[1].rows.numel(), launches
    del got, want, pairs
    torch.cuda.empty_cache()
    return out


def phase4i_rec_setup(smi, dev):
    """The record route's set-up under the hw rule at the srtm1.relight_hw
    cell's frame (a Renderer DEM-3601 at 800x600, its int32 index buffer)
    and at make_terrain(800,600,1024)'s shipped frame (int64 indices): held
    to its plain version; its kernels' and its chain's time at the cell's
    frame against its bound and the plain version's. Returns the kernels
    line's record."""
    spike = vt.make_terrain(W, H, VGRID, device=dev)
    idx = torch.as_tensor(spike._indices.astype(np.int64).reshape(-1, 3), device=dev)
    cases = {f"spike g{VGRID} shipped": rec_setup_against_plain(
        (spike_fields(spike, dev), idx, W, H, "hw"), f"spike g{VGRID} shipped")}
    del spike, idx
    xyuv, tris, heights, views, projs = renderer_frame(make_renderer(SRTM, dev, seed=1))
    fields = frame_fields(xyuv, heights, views, projs)
    del xyuv, heights
    args = (fields, tris, W, H, "hw")
    label = f"Renderer DEM-{SRTM}"
    cases[label] = rec_setup_against_plain(args, label)

    from torch.profiler import ProfilerActivity, profile
    calls = 5
    records, binning = kernels.rec_setup(*args)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kernels.rec_setup(*args)
        sync()
    total = {k: 0.0 for k in REC_SETUP_NAMES}
    seen = {k: 0 for k in REC_SETUP_NAMES}
    for a in prof.key_averages():
        for k in REC_SETUP_NAMES:
            if k in a.key:
                total[k] += a.self_device_time_total / 1e3
                seen[k] += a.count
    # Per call over the calls the trace kept (one count pass a call).
    kept = seen["rec_count_kernel"]
    per = {k: t / kept for k, t in total.items()} if kept else {}
    chain_ms = cuda_ms(lambda: kernels.rec_setup(*args), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: setup.rec_setup_plain(*args), reps=3, warmup=1)
    ntx, nty = setup.tile_grid(W, H)
    bound = rec_setup_bound(fields, tris, records, binning, kernels.rec_sort_passes(ntx * nty))
    del fields, tris, args, records, binning
    torch.cuda.empty_cache()
    device_ms = sum(per.values())
    rec = {"ms": chain_ms, "device_ms": device_ms, "plain_ms": plain_ms, **bound,
           "bound_share": bound["bound_ms"] / device_ms if device_ms else None,
           "at": f"Renderer({W},{H}) DEM-{SRTM} under hw, default camera, int32 indices"}
    say("rec_setup", card=smi, config=rec["at"], cases={
        k: {"equal": True, "binned": b, "pairs": p, "launches": n}
        for k, (b, p, n) in cases.items()},
        kernel_device_ms=per, kernel_launches_seen=seen, calls=calls, calls_kept=kept, **rec)
    return rec


# ---------------- slice 11: the public surface on the card ----------------

# render_spike_frames takes the vtx route's shaded path (and its vertex
# stage); the other kernels must not launch there.
SPIKE_KERNELS = tuple(k for k in VTX_KERNELS if k[0] != "vf_vtx_resolve_gbuffer") + VS_KERNELS
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
    every = ALL_KERNELS
    for _, fn in every:
        fn.launches = 0
    frames = vt.render_spike_frames(W, H, VGRID, eyes)
    sync()
    launches = {name: fn.launches for name, fn in every}
    for name, _ in every:
        if (launches[name] > 0) != (name in dict(SPIKE_KERNELS)):
            raise AssertionError(f"render_spike_frames launched {name} "
                                 f"{launches[name]} times")
    check_vs_launches(launches, 1, "render_spike_frames")   # one batch on the one card
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


# ---------------- slice 14: the bench entry and the example twins ----------------

# python -m vulkan_forge_torch.bench runs: (label, environment, route). The
# headline is bench.py's scene; the others are the configurations PERF.md
# records beside it.
BENCH_RUNS = (("headline", {}, "vtx"),
              ("g128", {"VF_BENCH_GRID": "128"}, "vtx"),
              ("dem2048", {"VF_BENCH_DEM": "2048"}, "vtx"),
              ("record_g128", {"VF_BENCH_GRID": "128", "VF_DENSE": "record"}, "record"))
# The launches of each route's shaded batch per camera set: one of each
# kernel, and the record set-up's chain over the g128 batch of BATCH frames.
ROUTE_KERNELS = {"vtx": dict.fromkeys(("vf_vs_fields", "vf_vtx_cover", "vf_vtx_cover_big",
                                       "vf_vtx_resolve_shade_shipped"), 1),
                 "record": {"vf_vs_fields": 1, "vf_raster_shade_shipped": 1,
                            "vf_rec_setup": kernels.rec_setup_launches(BATCH, W, H, True)}}
# The example twins and the launches each makes (none: add_terrain renders
# nothing; the Renderer's frames take the indexed route, one launch of each
# of its kernels, the vertex stage's and the extended shader's included).
INDEXED_NAMES = (("vf_vs_fields", "vf_terrain_fs_extended")
                 + tuple(name for name, _ in PACKED_KERNELS))
EXAMPLES = {"triangle": {"vf_raster_gbuffer": 2,
                         "vf_rec_setup": 2 * kernels.rec_setup_launches(1, 512, 512, True)},
            "two_triangles": {"vf_raster_gbuffer": 2,
                              "vf_rec_setup": 2 * kernels.rec_setup_launches(1, 256, 256, True)},
            "terrain": dict.fromkeys(INDEXED_NAMES, 1),
            "add_terrain": {},
            "terrain_normals_flip": dict.fromkeys(INDEXED_NAMES, 2)}
ENTRY_TIMEOUT = 300
# Runs a module as `python -m` does, then writes every kernel wrapper's launch
# count to the JSON file VF_SMOKE_LAUNCHES names (the module's exit code stands).
LAUNCHER = (
    "import json, os, runpy, sys\n"
    "from vulkan_forge_torch._raster import kernels\n"
    "from vulkan_forge_torch.lab import _kernels as lab\n"
    "mod = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    with open(os.environ['VF_SMOKE_LAUNCHES'], 'w') as f:\n"
    "        counts = {'vf_' + n: w.launches for n, w in vars(kernels).items()\n"
    "                  if hasattr(w, 'launches')}\n"
    "        counts.update({'vf_lab_' + w.__name__: w.launches for w in lab.LAUNCHED})\n"
    "        json.dump(counts, f)\n")


def run_entries(specs, cwd):
    """Start each entry point (``python -m <module> <args>`` through
    LAUNCHER, on the card) together; wait for all; kill any that outlives
    ENTRY_TIMEOUT. specs: {label: (module, args, extra env)}. Returns
    {label: (rc, stdout, stderr, launches)}."""
    out_dir = os.path.join(OUT_DIR, "entries")
    os.makedirs(out_dir, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("VF_ENFORCE_PERF", "VF_UPDATE_PERF_BASELINE")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    procs, files = {}, []
    try:
        for label, (module, args, extra) in specs.items():
            logs = [open(os.path.join(out_dir, f"{label}.{s}"), "w+") for s in ("out", "err")]
            files += logs
            counts = os.path.join(out_dir, f"{label}.launches.json")
            if os.path.exists(counts):
                os.remove(counts)
            procs[label] = (subprocess.Popen(
                [sys.executable, "-c", LAUNCHER, module, *args], cwd=cwd,
                env=dict(env, VF_SMOKE_LAUNCHES=counts, **extra), stdout=logs[0],
                stderr=logs[1], text=True), logs, counts)
        deadline = time.monotonic() + ENTRY_TIMEOUT
        results = {}
        for label, (p, logs, counts) in procs.items():
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            for log in logs:
                log.seek(0)
            launches = json.load(open(counts)) if os.path.exists(counts) else None
            results[label] = (p.returncode, logs[0].read(), logs[1].read(), launches)
        return results
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in files:
            log.close()


def check_launches(launches, want, label):
    """Each kernel launched exactly as often as ``want`` says, the rest never."""
    every = [name for name, _ in ALL_KERNELS]
    got = {name: (launches or {}).get(name, 0) for name in every}
    if launches is None or got != {name: want.get(name, 0) for name in every}:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return {name: n for name, n in got.items() if n}


def bench_run(label, extra, route, smi):
    """One ``python -m vulkan_forge_torch.bench`` on the card, its line held
    to the contract: one JSON line, bench.py's metric for the environment,
    the route that ran, the card, 5 reps, each route kernel launched once per
    camera set and no other kernel. Returns (line, per-rep ms, launches)."""
    rc, out, err, launches = run_entries(
        {label: ("vulkan_forge_torch.bench", [], extra)}, ROOT)[label]
    if rc != 0:
        raise AssertionError(f"bench {label} exited {rc}:\n{out}\n{err[-4000:]}")
    lines = out.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench {label}: stdout is not one line:\n{out}")
    line = json.loads(lines[0])
    grid = int(extra.get("VF_BENCH_GRID", VGRID))
    batch = VBATCH if grid >= 512 else BATCH
    dem = int(extra.get("VF_BENCH_DEM", 0))
    metric = f"terrain_throughput_grid{grid}_{W}x{H}_b{batch}" + (f"_dem{dem}" if dem else "")
    ms = line.get("ms_per_batch", {})
    ok = (line.get("metric") == metric and line.get("path") == route
          and line.get("device") == "cuda" and line.get("card") == smi
          and line.get("unit") == "Mpix/s" and ms.get("reps") == REPS
          and line.get("value", 0) > 0
          and math.isclose(line["value"], W * H * batch / (ms["median"] * 1e3), rel_tol=1e-9)
          and math.isclose(line["vs_baseline"], line["value"] / 21.0, rel_tol=1e-9))
    if not ok:
        raise AssertionError(f"bench {label}: line {line} breaks the contract "
                             f"(metric {metric}, path {route}, card {smi!r})")
    diag = json.loads([e for e in err.splitlines() if e.startswith('{"bench"')][-1])
    used = check_launches(launches, {k: n * (REPS + 1) for k, n in ROUTE_KERNELS[route].items()},
                          f"bench {label}")
    return line, diag["times_ms"], used


def headline_turns(smi, dev):
    """The bench's headline in turns with phase 4b's direct batch (the vtx
    route, mesh on the card; cameras, LUT and scalars copied in the window)
    and with the bench's own window in this process (bench.measure:
    everything on the card first): bench, direct, in-process, in-process,
    direct, bench. Each bench run is a process of its own."""
    cams = [orbit_cameras(VBATCH, W, H, phase=0.31 * r + 0.05) for r in range(REPS + 1)]
    direct = route_fn("vtx", VGRID, dev)
    times = {"bench": [], "direct_batch": [], "bench_in_process": []}
    lines, launches = [], None
    for arm in ("bench", "direct_batch", "bench_in_process", "bench_in_process",
                "direct_batch", "bench"):
        if arm == "bench":
            line, ms, launches = bench_run("headline", {}, "vtx", smi)
            lines.append(line)
            times["bench"].append(ms)
        elif arm == "bench_in_process":
            times[arm].append([t * 1e3 for t in bench.measure(bench.config({}), dev)["times"]])
        else:
            direct(*cams[-1])
            sync()
            times["direct_batch"].append(host_ms(direct, cams[:REPS]))
    med = {arm: [statistics.median(t) for t in runs] for arm, runs in times.items()}
    return {"lines": lines, "ms_all": times, "ms_median_per_run": med,
            "spread_ms": {arm: max(map(max, runs)) - min(map(min, runs))
                          for arm, runs in times.items()},
            "mpix_per_s_median": {arm: VBATCH * W * H / (statistics.median(
                [t for r in runs for t in r]) * 1e3) for arm, runs in times.items()},
            "launches": launches}


def example_checks(dev):
    """The five example twins as processes on the card, together, in a
    temporary directory; each again in-process (main(["--device", "cuda"])
    in a second one). Exit 0, the same printed lines (but the Renderer's
    timing metrics), the same PNG pixels, and the launches EXAMPLES names,
    in both runs."""
    out = {}
    with tempfile.TemporaryDirectory() as sub_dir, tempfile.TemporaryDirectory() as own_dir:
        t0 = time.perf_counter()
        res = run_entries({name: (f"vulkan_forge_torch.examples.{name}", ["--device", "cuda"],
                                  {}) for name in EXAMPLES}, sub_dir)
        together_s = time.perf_counter() - t0
        cwd = os.getcwd()
        for name, want in EXAMPLES.items():
            rc, stdout, err, launches = res[name]
            if rc != 0:
                raise AssertionError(f"example {name} exited {rc}:\n{stdout}\n{err[-4000:]}")
            used = check_launches(launches, want, f"example {name}")
            mod = importlib.import_module(f"vulkan_forge_torch.examples.{name}")
            for _, fn in ALL_KERNELS:
                fn.launches = 0
            text = io.StringIO()
            os.chdir(own_dir)
            try:
                with contextlib.redirect_stdout(text):
                    mod.main(["--device", "cuda"])
                sync()
            finally:
                os.chdir(cwd)
            check_launches({n: fn.launches for n, fn in ALL_KERNELS}, want,
                           f"example {name} in-process")
            keep = lambda s: [ln for ln in s.splitlines() if not ln.startswith("metrics:")]
            if keep(stdout) != keep(text.getvalue()):
                raise AssertionError(f"example {name} printed\n{stdout}\nin-process\n"
                                     f"{text.getvalue()}")
            pngs = sorted(f for f in os.listdir(sub_dir) if f in stdout)
            for png in pngs:
                if not np.array_equal(png_pixels(os.path.join(sub_dir, png)),
                                      png_pixels(os.path.join(own_dir, png))):
                    raise AssertionError(f"example {name}: {png} differs from the "
                                         "in-process frame")
            out[name] = {"lines": stdout.splitlines(), "pngs_equal": pngs, "launches": used}
        if sorted(os.listdir(sub_dir)) != sorted(os.listdir(own_dir)):
            raise AssertionError(f"examples wrote {os.listdir(sub_dir)}, in-process "
                                 f"{os.listdir(own_dir)}")
    return {"together_s": together_s, **out}


def phase6_entry_points(smi, dev):
    """Slice 14's entry points on the card."""
    turns = headline_turns(smi, dev)
    runs = {}
    for label, extra, route in BENCH_RUNS[1:]:
        line, ms, used = bench_run(label, extra, route, smi)
        runs[label] = {"line": line, "ms_all": ms, "launches": used}
    examples = example_checks(dev)
    say("entry_points", card=smi, bench_headline=turns, bench=runs, examples=examples)


# ---------------- phase 7: the lab kernels (slice 16) ----------------

# Kernel name of each compiled lab entry (a substring of its mangled name).
LAB_ENTRIES = (("lab_fs_ops_kernel", "vf_lab_fs_ops"),
               ("lab_fs_chain_kernel", "vf_lab_fs_chain"),
               ("lab_slab_copy_kernel", "vf_lab_slab_copy"),
               ("lab_transpose_kernel", "vf_lab_slab_transpose"),
               ("lab_slab_loop_kernelILb0", "vf_lab_slab_transpose, loop"),
               ("lab_slab_loop_kernelILb1", "vf_lab_slab_transpose, loop with transpose"),
               ("lab_onehot_dot_ffma_kernel", "vf_lab_onehot_dot, ffma"),
               ("lab_onehot_dot_mma_kernelILi1E", "vf_lab_onehot_dot, tf32"),
               ("lab_onehot_dot_mma_kernelILi3E", "vf_lab_onehot_dot, tf32x3"),
               ("lab_lane_ops_kernel", "vf_lab_lane_ops"))
# One entry per body of the step loop (its template argument, BODIES' order).
LOOP_ENTRIES = tuple((f"lab_step_loop_kernelILi{i}E", f"vf_lab_step_loop, {name}")
                     for i, name in enumerate(lab_kernels.BODIES))
# The lab twins (python -m vulkan_forge_torch.lab.<name> on the card) and
# the launches each makes: fs_ops one per op and one for exp_log_pow's logf;
# fs_chain one; slab_copy the check and the timing (2 warm-ups + 5 x 20);
# slab_transpose the check and two loops (a warm-up + 3 timed each).
LAB_TWINS = {"fs_ops": {"vf_lab_fs_ops": len(lab_kernels.OPS) + 1},
             "fs_chain": {"vf_lab_fs_chain": 1},
             "slab_copy": {"vf_lab_slab_copy": 1 + 2 + 5 * 20},
             "slab_transpose": {"vf_lab_slab_transpose": 1 + 2 * 4}}
# The deposit probes' twins, one after another: what they print
# is a single-block loop's time, and processes share the card by time
# slices. Each body one launch and 3 timed (a warm-up, then the median of
# 3); E_exact one product per mode; E1, E2, E3 and E4 a check and 2 + 5 x
# 20 timed calls each (3 modes, 3 shapes, 2 ops).
_N_BODIES = {script: sum(b.script == script for b in lab_bodies.BODIES)
             for script in lab_bodies.SCRIPTS}
DEPOSIT_TWINS = {
    "deposit_breakdown": {"vf_lab_step_loop": 4 * _N_BODIES["exp_deposit_breakdown"],
                          "vf_lab_onehot_dot": len(lab_kernels.DOT_MODES)},
    "deposit_trip": {"vf_lab_step_loop": 4 * _N_BODIES["exp_deposit3"]},
    "deposit_marginal": {"vf_lab_step_loop": 4 * _N_BODIES["exp_deposit2"]},
    "loop_floor": {"vf_lab_step_loop": 4 * _N_BODIES["exp_loop_floor"]},
    "mosaic_facts": {"vf_lab_onehot_dot": 3 * 103, "vf_lab_slab_transpose": 3 * 103,
                     "vf_lab_lane_ops": 2 * 103,
                     "vf_lab_step_loop": 4 * _N_BODIES["exp_mosaic_facts"]}}
LAB_TWINS.update(DEPOSIT_TWINS)
# f32 operations per element of each fs_ops op (the product, then the
# function; max, log, product and exp for exp_log_pow).
LAB_OP_COUNT = {"sin": 2, "cos": 2, "sqrt": 1, "inv_sqrt": 2, "rsqrt": 1, "pow_srgb": 1,
                "exp": 2, "log": 1, "exp_log_pow": 4}
# The chain's f32 operations per pixel: shade_shipped's (SHADE_OPS) and the
# chain's own copy of one channel's (about 40, counted from csrc/lab.cu).
LAB_CHAIN_OPS = SHADE_OPS + 40
LAB_CHAIN_PIXELS = 4096
# Turns of kernel and library call (20 calls each) for the rows whose
# per-call time is held against a PyTorch call's: E2, k_correct, E_exact, E1.
LAB_TURNS = 9
# The slab copy at the resolves' fields: g1024 x4 as (frames * 7, N).
LAB_FIELDS = (VBATCH * vtx.FIELDS, VGRID * VGRID)


def lab_time(run, plain, key, nbytes, ops, library=None, inner=KERNEL_INNER, reps=REPS):
    """A lab kernel's per-call ms (CUDA events) and the library call's, in
    turns (kernel, library, library, kernel, ...; the median of each), its
    device ms (profiler key ``key``), its plain version's ms and the
    bound."""
    ks, ls = [], []
    for r in range(reps):
        for fn in ((run, library) if r % 2 == 0 else (library, run)):
            if fn is not None:
                (ks if fn is run else ls).append(cuda_ms(fn, reps=1, inner=inner))
    return {"ms": statistics.median(ks),
            "device_ms": kernel_device_ms(run, key=key, calls=max(inner, 3)),
            "plain_ms": cuda_ms(plain, reps=reps, inner=inner),
            "library_ms": statistics.median(ls) if ls else None,
            **bound_of(nbytes, ops)}


def bits_equal(a, b):
    return bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def lab_fs_ops_checks(dev):
    """Finding (a): each op on the card against torch-CUDA and against f64,
    within the CUDA C++ Programming Guide's bound; per-op times."""
    rows = lab_fs_ops.measure(dev)
    for r in rows:
        if not lab_fs_ops.within_guide(r):
            raise AssertionError(f"vf_lab_fs_ops {r['op']} exceeds the guide's bound: {r}")
    t, u, p = (torch.from_numpy(a).to(dev) for a in lab_fs_ops.make_inputs())
    library = {"sqrt": lambda: torch.sqrt(p), "rsqrt": lambda: torch.rsqrt(p),
               "pow_srgb": lambda: torch.pow(u, 1.0 / 2.4), "log": lambda: torch.log(p)}
    per_op = {}
    for r in rows:
        op = r["op"]
        run = lambda op=op: lab_kernels.fs_ops(t, u, p, op)
        plain = lambda op=op: lab_kernels.fs_ops_plain(t, u, p, op)
        err = float((run() - plain()).abs().max())
        per_op[op] = {**r, "max_abs_err": err,
                      **lab_time(run, plain, "lab_fs_ops_kernel", 2 * t.numel() * 4,
                                 LAB_OP_COUNT[op] * t.numel(), library.get(op))}
    return per_op


def lab_chain_inputs(dev, n=LAB_CHAIN_PIXELS, seed=5):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(-0.7, 0.7, n), rng.uniform(-16, 16, n), rng.uniform(-16, 16, n)]
    cols = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in cols]
    return cols + [torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)]


def lab_fs_chain_checks(dev):
    """vf_lab_fs_chain against its plain version on the card, all 15 rows bit
    for bit (tolerance 0: the card's plain ops are the kernel's functions),
    and its u8f row equal to the probed channel's byte of shade_shipped's
    word; at the script's two pixels and 4096 seeded ones. Times at both."""
    _, lut_rgb, par = lab_fs_chain.script_inputs(dev)
    script = [torch.tensor([px[i] for px in lab_fs_chain.PIXELS], device=dev,
                           dtype=torch.float32 if i < 3 else torch.int32) for i in range(4)]
    out = {}
    u8f = lab_kernels.CHAIN_NAMES.index("u8f")
    for label, cols in (("script_pixels", script), ("seeded_4096", lab_chain_inputs(dev))):
        got = lab_kernels.fs_chain(*cols, lut_rgb, par)
        want = lab_kernels.fs_chain_plain(*cols, lut_rgb, par)
        if not bits_equal(got, want):
            rows = [n for i, n in enumerate(lab_kernels.CHAIN_NAMES + ("word",))
                    if not bits_equal(got[i], want[i])]
            raise AssertionError(f"vf_lab_fs_chain differs from plain ({label}) in {rows}")
        byte = (got[-1].view(torch.int32) >> (8 * cols[3])) & 0xFF
        if not torch.equal(got[u8f], byte.to(torch.float32)):
            raise AssertionError(f"vf_lab_fs_chain ({label}): u8f is not shade_shipped's byte")
        n = cols[0].numel()
        run = lambda cols=cols: lab_kernels.fs_chain(*cols, lut_rgb, par)
        plain = lambda cols=cols: lab_kernels.fs_chain_plain(*cols, lut_rgb, par)
        out[label] = {"pixels": n, "max_abs_err": 0.0,
                      **lab_time(run, plain, "lab_fs_chain_kernel",
                                 n * (3 * 4 + 4 + lab_kernels.CHAIN_ROWS * 4) + 256 * 3 * 4 + 20,
                                 n * LAB_CHAIN_OPS)}
    return out


def lab_slab_copy_checks(dev):
    """vf_lab_slab_copy equal to its plain version at the script's shape,
    (8, 384), (300, 4096) (dynamic shared memory above 48 KB) and the
    resolves' fields (g1024 x4 as (28, 1048576)); ragged columns raise.
    Times at the script's shape and at the fields'."""
    for shape in ((32, 1024), (8, 384), (300, 4096), LAB_FIELDS):
        src = lab_slab_copy.source(*shape, device=dev)
        if not torch.equal(lab_kernels.slab_copy(src), lab_kernels.slab_copy_plain(src)):
            raise AssertionError(f"vf_lab_slab_copy differs from plain at {shape}")
    try:
        lab_kernels.slab_copy(torch.zeros(8, 1000, device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError("vf_lab_slab_copy took 1000 columns")
    out = {}
    for label, shape in (("script", (lab_slab_copy.ROWS, lab_slab_copy.NLANES)),
                         ("fields_g1024_x4", LAB_FIELDS)):
        src = lab_slab_copy.source(*shape, device=dev)
        out[label] = {"shape": list(shape), "max_abs_err": 0.0, **lab_time(
            lambda src=src: lab_kernels.slab_copy(src),
            lambda src=src: lab_kernels.slab_copy_plain(src), "lab_slab_copy_kernel",
            2 * src.numel() * 4, src.numel(),
            library=lambda src=src: src.unflatten(1, (-1, 128)).transpose(0, 1)
            .reshape(-1, 128) * 2.0)}
    return out


def lab_slab_transpose_checks(dev):
    """vf_lab_slab_transpose equal to its plain version: k_correct at the
    script's (32, 128) and at (8, 384), (100, 70); k_loop at the script's
    (128, 128) x 4096 with and without the transpose (integer sums below
    2**24: exact in any order). Finding (d): ns per iteration of both loops;
    the kernel's and the plain loop's times."""
    for shape in ((32, 128), (8, 384), (100, 70)):
        src = torch.arange(shape[0] * shape[1], dtype=torch.float32, device=dev).reshape(shape)
        if not torch.equal(lab_kernels.slab_transpose(src), src.T):
            raise AssertionError(f"vf_lab_slab_transpose differs from src.T at {shape}")
    src = lab_slab_transpose.loop_source(dev)
    iters = lab_slab_transpose.ITERS
    S, cols = src.shape[0] // 4, src.shape[1]
    out = {}
    for transpose in (False, True):
        got = lab_kernels.slab_transpose(src, iters, transpose)
        if not torch.equal(got, lab_kernels.slab_transpose_plain(src, iters, transpose)):
            raise AssertionError(f"vf_lab_slab_transpose's loop (transpose={transpose}) "
                                 "differs from plain")
        run = lambda t=transpose: lab_kernels.slab_transpose(src, iters, t)
        plain = lambda t=transpose: lab_kernels.slab_transpose_plain(src, iters, t)
        rec = {"iters": iters, "max_abs_err": 0.0,
               **lab_time(run, plain, "lab_slab_loop_kernel", (src.numel() + cols) * 4,
                          iters * (S + 1) * cols, inner=1, reps=3)}
        rec["ns_per_iter"] = rec["ms"] * 1e6 / iters
        rec["device_ns_per_iter"] = rec["device_ms"] * 1e6 / iters
        out["loop_with_transpose" if transpose else "loop_without_transpose"] = rec
    small = torch.arange(32 * 128, dtype=torch.float32, device=dev).reshape(32, 128)
    out["k_correct"] = {"shape": [32, 128], **lab_time(
        lambda: lab_kernels.slab_transpose(small), lambda: lab_kernels.slab_transpose_plain(small),
        "lab_transpose_kernel", 2 * small.numel() * 4, 0,
        library=lambda: small.T.contiguous(), reps=LAB_TURNS)}
    return out


# ---------------- phase 7, continued: the deposit probes ----------------

LOOP_CHECK_STEPS = 128
LOOP_SCRATCH_SEED = 17
# f32 operations of one step of each body, counted from csrc/lab.cu (the
# function's: a product's live rows only, 2 x 128 per output; one-hot builds
# 2 per element of P), per element of the (8, 128) tile unless scalar.
_T, _MM, _OH = 1024, 256, 2 * 128 * 128
_EV = {"edges": 39, "aw": 48, "asum": 53}          # eval_slot per element


def _full_ops(ev):
    return 4 * (_T * (ev + 12) + _OH + 6 * _T * _MM + 6 * _T + 2 * (_T * _MM + _T)) + _T * 16


LOOP_OPS = {
    "v_eval": _T * 4 * (_EV["edges"] + 5), "v_pbuild": _T * 12, "v_tr": _T * 2,
    "v_mm4": 4 * _T * (_MM + 1), "v_mm1": _T * (4 * _MM + 1), "v_mm48": _T * (4 * _MM + 1),
    "v_gb": _T * (4 * _MM + 1),
    "v_full": (_T * 4 * (_EV["edges"] + 8) + 4 * _OH + 6 * _T * _MM + 12 * _T
               + 4 * _T * (_MM + 1) + _T * _MM + 4 * _T),
    "d_base": _T * 2, "d_strips": _T * (8 * 53 + 7 + 16 + 64 + 6),
    "d_eval4": _T * (4 * (_EV["asum"] + 5) + 1), "d_mm": 4 * _T * (3 * _MM + 3) + 3 * _T,
    "d_full": _full_ops(_EV["asum"]),
    "b_base": _T * 2, "b_eval1": _T * (_EV["aw"] + 5), "b_eval4": _T * (4 * (_EV["aw"] + 5) + 1),
    "b_bm": _T * (4 * (_EV["aw"] + 8) + 1), "b_tr": _T * 2, "b_p1": _T * 3,
    "b_mmA": _T * (_MM + 2), "b_full": _full_ops(_EV["aw"]),
    "c_scalar": 1, "c_slice": 1, "c_rmwf": _T, "c_rmwd": _T, "c_rmwd_and": _T, "c_u4": _T,
    "c_u8": _T, "c_eval4_u1": _T * (4 * (_EV["aw"] + 5) + 1),
    "c_eval4_u4": _T * (4 * (_EV["aw"] + 5) + 1), "c_eval4_u8": _T * (4 * (_EV["aw"] + 5) + 1),
    "e5": _T * 4 * (_EV["edges"] + 7) + 4 * _OH + 4 * _T * (2 * _MM + 2) + _T}


def loop_scratch(script, dev):
    rows = lab_bodies.SCRIPTS[script]["scratch"]
    rng = np.random.default_rng(LOOP_SCRATCH_SEED)
    return torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32)).to(dev)


def bits_differ(a, b):
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def lab_step_loop_checks(dev):
    """vf_lab_step_loop against its plain version, every body at 128 steps
    from a seeded scratch (the script's input): bodies with no product
    whose sums round bit for bit on out and on the final scratch; the
    others (_bodies.SCALED) bit for bit too or, where a bit differs, within
    1e-5 of each element's scale (the plain run with every product's terms
    taken by magnitude, from the scratch's magnitudes). Per body: the
    kernel's ms (CUDA events around one launch, median of 3), the plain
    run's (host clock, one run) and the bound."""
    out = {}
    n = LOOP_CHECK_STEPS
    for body in lab_bodies.BODIES:
        script = lab_bodies.SCRIPTS[body.script]
        big = lab_bodies.script_big(body.script, dev)
        init = loop_scratch(body.script, dev)
        got, acc = lab_kernels.step_loop(body.name, big, n, init)
        sync()
        t0 = time.perf_counter()
        want, want_acc = lab_kernels.step_loop_plain(body.name, big, n, init)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = {"out": bits_differ(got, want), "scratch": bits_differ(acc, want_acc)}
        err = max(float((got - want).abs().max()), float((acc - want_acc).abs().max()))
        if body.name in lab_bodies.SCALED and (diff["out"] or diff["scratch"]):
            mag_acc = init.abs()
            mag = lab_bodies.run(body.name, big, n, mag_acc, product=lab_bodies.mm_magnitude)
            for label, a, b, m in (("out", got, want, mag), ("scratch", acc, want_acc, mag_acc)):
                if not bool(((a - b).abs() <= 1e-5 * m).all()):
                    raise AssertionError(f"vf_lab_step_loop {body.name}: {label} beyond 1e-5 of "
                                         "its scale")
        elif diff["out"] or diff["scratch"]:
            raise AssertionError(f"vf_lab_step_loop {body.name} differs from plain: {diff}")
        run = lambda body=body, big=big, init=init: lab_kernels.step_loop(body.name, big, n, init)
        ms = cuda_ms(run, reps=3, warmup=1)
        nbytes = (script["big"] * 128 + 2 * script["scratch"] * 128 + 1024) * 4
        out[body.name] = {"nstep": n, "bits_differ": diff, "max_abs_err": err, "ms": ms,
                          "ns_per_step": ms * 1e6 / n, "plain_ms": plain_ms,
                          **bound_of(nbytes, LOOP_OPS[body.name] * n)}
    return out


def dot_blocks(m, n, mode):
    """The blocks vf_lab_onehot_dot launches (csrc/lab.cu): ffma a thread
    per output, 128 a block; the tf32 modes a one-warp block per 16 x 8
    output tile."""
    return -(-m * n // 128) if mode == "ffma" else -(-m // 16) * -(-n // 8)


# Calls over which each part of a lab launch's split is timed: host stamps
# (time.perf_counter_ns) between the parts of one call, the median of each.
SPLIT_CALLS = 2000
STEP_SPLIT_CALLS = 200


def stamp_medians(parts, calls, warmup=50):
    """{part: median ns} over ``calls`` calls of parts(), which returns
    {part: ns} for one call."""
    for _ in range(warmup):
        parts()
    sync()
    stamps = [parts() for _ in range(calls)]
    sync()
    return {k: statistics.median(s[k] for s in stamps) for k in stamps[0]}


def lab_launch_split(dev):
    """One vf_lab_slab_transpose call at (8, 128) cut into the parts of the
    port's launch path (_build.launch), with no synchronize between calls:
    the checks, the output's new_empty, the current-device test, the raw stream
    handle and the ctypes call (the launch and cudaGetLastError); beside
    them the wrapper's whole call, a ctypes call of vf_lab_ops (no CUDA
    call) and the function's call with 0 rows (cudaGetLastError, no
    launch)."""
    ns = time.perf_counter_ns
    src = torch.rand(8, 128, device=dev)
    rows, cols = src.shape
    lib = lab_kernels.load()
    fns = {name: getattr(lib, name) for name in lab_kernels._SIGNATURES}

    def parts():
        t0 = ns()
        lab_kernels._check("src", src, torch.float32, 2)
        t1 = ns()
        out = src.new_empty((cols, rows))
        t2 = ns()
        index = src.get_device()
        ready = torch._C._cuda_getDevice() == index and index in lab_kernels._prepared
        t3 = ns()
        stream = torch._C._cuda_getCurrentRawStream(index)
        t4 = ns()
        err = fns["vf_lab_slab_transpose"](src.data_ptr(), rows, cols, 0, 1, out.data_ptr(),
                                           stream)
        t5 = ns()
        assert err == 0 and ready, err
        return {"checks": t1 - t0, "new_empty": t2 - t1, "device_test": t3 - t2,
                "raw_stream": t4 - t3, "ctypes_call": t5 - t4, "sum": t5 - t0}

    def alone():
        out = src.new_empty((cols, rows))
        stream = torch._C._cuda_getCurrentRawStream(src.get_device())
        t0 = ns()
        lab_kernels.slab_transpose(src)
        t1 = ns()
        fns["vf_lab_ops"]()
        t2 = ns()
        fns["vf_lab_slab_transpose"](src.data_ptr(), 0, cols, 0, 1, out.data_ptr(), stream)
        t3 = ns()
        return {"whole_call": t1 - t0, "ops_call": t2 - t1, "no_launch_call": t3 - t2}

    lab_kernels.slab_transpose(src)        # the device's opt-ins, before the stamps
    return {"shape": [8, 128], "calls": SPLIT_CALLS,
            "ns": {"parts": stamp_medians(parts, SPLIT_CALLS),
                   "alone": stamp_medians(alone, SPLIT_CALLS)}}


def lab_step_split(dev):
    """A step-loop launch's fixed cost (body c_scalar, 128 steps,
    exp_loop_floor's input and a zero scratch): the wrapper's call between
    CUDA events (one call after a synchronize), the kernel's device time and
    their difference; the call cut into its parts by host stamps, a
    synchronize after each call (the checks with the scratch's clone, the
    output's allocation, the device test and raw stream, the ctypes call);
    the clone and the whole call alone."""
    ns = time.perf_counter_ns
    body, nstep = "c_scalar", 128
    big = lab_bodies.script_big("exp_loop_floor", dev)
    scratch = torch.zeros((lab_bodies.SCRIPTS["exp_loop_floor"]["scratch"], lab_bodies.LANES),
                          device=dev)
    index = lab_kernels.BODIES.index(body)
    iters = nstep // lab_bodies.BY_NAME[body].unroll
    step = lab_kernels.load().vf_lab_step_loop

    def call():
        return lab_kernels.step_loop(body, big, nstep, scratch)

    def parts():
        t0 = ns()
        acc = lab_kernels._step_checks(body, big, nstep, scratch)
        t1 = ns()
        out = big.new_empty((lab_bodies.TILE, lab_bodies.LANES))
        t2 = ns()
        ready = torch._C._cuda_getDevice() == big.get_device()
        stream = torch._C._cuda_getCurrentRawStream(big.get_device())
        t3 = ns()
        err = step(big.data_ptr(), acc.data_ptr(), acc.shape[0], index, iters, out.data_ptr(),
                   stream)
        t4 = ns()
        sync()
        assert err == 0 and ready, err
        return {"checks_and_clone": t1 - t0, "new_empty": t2 - t1, "device_and_stream": t3 - t2,
                "ctypes_call": t4 - t3, "sum": t4 - t0}

    def alone():
        t0 = ns()
        scratch.clone()
        t1 = ns()
        call()
        t2 = ns()
        sync()
        return {"clone": t1 - t0, "whole_call": t2 - t1}

    ms = cuda_ms(call, warmup=1)
    dev_ms = kernel_device_ms(call, key="lab_step_loop_kernel", calls=REPS)
    return {"body": body, "nstep": nstep, "calls": STEP_SPLIT_CALLS, "ms": ms,
            "kernel_device_ms": dev_ms, "fixed_ms": ms - dev_ms,
            "clone_ms": cuda_ms(lambda: scratch.clone(), inner=KERNEL_INNER),
            "ns": {"parts": stamp_medians(parts, STEP_SPLIT_CALLS, warmup=5),
                   "alone": stamp_medians(alone, STEP_SPLIT_CALLS, warmup=5)}}


def lab_floor(dev):
    """The least a lab call costs: vf_lab_lane_ops' exponent on a (1, 32)
    tensor, per call (CUDA events) and on the device."""
    x = torch.rand(1, 32, device=dev) + 1.0
    fn = lambda: lab_kernels.lane_ops(x, "exponent")
    return {"shape": [1, 32], "op": "exponent", "ms": cuda_ms(fn, inner=KERNEL_INNER),
            "device_ms": kernel_device_ms(fn, key="lab_lane_ops_kernel")}


def lab_onehot_dot_checks(dev):
    """vf_lab_onehot_dot on E_exact's permutation and E1's one-hot: ffma
    bit-equal to its plain version, tf32 and tf32x3 within DOT_TOLERANCE of
    sum_k |a||b|; ffma and tf32x3 give every E_exact column its one
    contributor bit for bit (tf32's mismatches are reported). Per mode at
    E1: E1's facts, times, the bound, torch.matmul (full f32) beside."""
    facts, timing = {}, {}
    vals, p = lab_breakdown.exact_inputs(dev)
    a1, b1 = lab_facts.e1_inputs(dev)
    for mode in lab_kernels.DOT_MODES:
        for label, a, b in (("e_exact", vals, p), ("e1", a1, b1)):
            got = lab_kernels.onehot_dot(a, b, mode)
            want = lab_kernels.onehot_dot_plain(a, b, mode)
            if mode == "ffma":
                ok = bits_differ(got, want) == 0
            else:
                scale = lab_kernels.onehot_dot_plain(a.abs(), b.abs(), "ffma")
                ok = bool(((got - want).abs() <= lab_kernels.DOT_TOLERANCE * scale).all())
            if not ok:
                raise AssertionError(f"vf_lab_onehot_dot {mode} differs from plain on {label}")
        bad = lab_breakdown.single_contrib_mismatches(lab_kernels.onehot_dot(vals, p, mode),
                                                      vals, p)
        if mode != "tf32" and bad:
            raise AssertionError(f"vf_lab_onehot_dot {mode}: {bad} E_exact elements are not "
                                 "their contributor's bits")
        got1 = lab_kernels.onehot_dot(a1, b1, mode)
        facts[mode] = {"e_exact_mismatches": bad, "e_exact_elements": vals.numel(),
                       **lab_facts.e1_facts(got1, a1, b1),
                       "e1_kernel_vs_plain_bits_differ": bits_differ(
                           got1, lab_kernels.onehot_dot_plain(a1, b1, mode))}
        for label, a, b in (("e1", a1, b1), ("e_exact", vals, p)):
            m, n = a.shape[0], b.shape[1]
            nbytes = (m * 128 + 128 * n + m * n) * 4
            rec = {"shape": [m, 128, n], "max_abs_err": float(
                (lab_kernels.onehot_dot(a, b, mode) - lab_kernels.onehot_dot_plain(a, b, mode))
                .abs().max()), **lab_time(
                lambda mode=mode, a=a, b=b: lab_kernels.onehot_dot(a, b, mode),
                lambda mode=mode, a=a, b=b: lab_kernels.onehot_dot_plain(a, b, mode),
                "lab_onehot_dot", nbytes, 0,
                library=lambda a=a, b=b: torch.matmul(a, b), inner=KERNEL_INNER,
                reps=LAB_TURNS)}
            rec.update(bound_of(nbytes, 2 * m * n * 128 * (3 if mode == "tf32x3" else 1),
                                PEAK_F32 if mode == "ffma" else PEAK_TF32))
            rec["blocks"] = dot_blocks(m, n, mode)
            timing.setdefault(mode, {})[label] = rec
    return facts, timing


def lab_lane_ops_checks(dev):
    """vf_lab_lane_ops equal to torch.roll (E3's (8, 128) by 5, and a (3,
    1000) by -7) and to the exponent in torch (E4's bitmask sums, equal to
    floor(log2) as well); vf_lab_slab_transpose at E2's three shapes equal
    to x.T. Times, bounds and the library calls."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((8, 128), dtype=np.float32)).to(dev)
    wide = torch.from_numpy(rng.random((3, 1000), dtype=np.float32)).to(dev)
    masks = lab_facts.e4_inputs(dev)
    for a, shift in ((x, lab_facts.ROLL), (wide, -7)):
        if not torch.equal(lab_kernels.lane_ops(a, "roll", shift), torch.roll(a, shift, 1)):
            raise AssertionError(f"vf_lab_lane_ops roll {shift} differs from torch.roll")
    expo = lab_kernels.lane_ops(masks, "exponent")
    if not torch.equal(expo, lab_kernels.lane_ops_plain(masks, "exponent")) or not np.array_equal(
            expo.cpu().numpy(), np.floor(np.log2(masks.cpu().numpy())).astype(np.float32)):
        raise AssertionError("vf_lab_lane_ops exponent differs from plain or floor(log2)")
    ops = {"roll": {"max_abs_err": 0.0, **lab_time(
               lambda: lab_kernels.lane_ops(x, "roll", lab_facts.ROLL),
               lambda: lab_kernels.lane_ops_plain(x, "roll", lab_facts.ROLL),
               "lab_lane_ops_kernel", 2 * x.numel() * 4, 0,
               library=lambda: torch.roll(x, lab_facts.ROLL, 1), reps=3)},
           "exponent": {"max_abs_err": 0.0, **lab_time(
               lambda: lab_kernels.lane_ops(masks, "exponent"),
               lambda: lab_kernels.lane_ops_plain(masks, "exponent"),
               "lab_lane_ops_kernel", 2 * masks.numel() * 4, 4 * masks.numel(), reps=3)}}
    e2 = {}
    for shape in ((1, 128), (8, 128), (32, 128)):
        src = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
        if not torch.equal(lab_kernels.slab_transpose(src), src.T):
            raise AssertionError(f"vf_lab_slab_transpose differs from x.T at {shape} (E2)")
        e2[str(list(shape))] = lab_time(
            lambda src=src: lab_kernels.slab_transpose(src),
            lambda src=src: lab_kernels.slab_transpose_plain(src), "lab_transpose_kernel",
            2 * src.numel() * 4, 0, library=lambda src=src: src.T.contiguous(), reps=LAB_TURNS)
    return ops, e2


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_BRA = re.compile(r"\bBRA\b[^;]*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def sass_loops(path):
    """Per step-loop body, from ``cuobjdump -sass`` of the lab library: the
    kernel's instructions and its longest backward branch's span (the step
    loop's body with the loops inside it): where nvcc hoisted a body's
    work out of the step loop, that span is short."""
    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([exe, "-sass", str(path)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    funcs, cur = {}, None
    for ln in text.splitlines():
        if "Function : " in ln:
            cur = ln.split("Function : ")[1].strip()
            funcs[cur] = {"insns": [], "labels": {}, "pending": []}
            continue
        if cur is None:
            continue
        f = funcs[cur]
        m = _SASS_LABEL.match(ln)
        if m:
            f["pending"].append(m.group(1))
            continue
        m = _SASS_INSN.search(ln)
        if m:
            addr = int(m.group(1), 16)
            for label in f["pending"]:
                f["labels"][label] = addr
            f["pending"] = []
            f["insns"].append((addr, m.group(2)))
    out = {}
    for name, f in funcs.items():
        m = re.search(r"lab_step_loop_kernelILi(\d+)E", name)
        if not m:
            continue
        spans = []
        for addr, insn in f["insns"]:
            b = _SASS_BRA.search(insn)
            if not b:
                continue
            target = f["labels"].get(b.group(1)) if b.group(1) else int(b.group(2), 16)
            if target is not None and target <= addr:
                spans.append((addr - target) // 16 + 1)
        out[lab_kernels.BODIES[int(m.group(1))]] = {
            "instructions": len(f["insns"]), "backward_branches": len(spans),
            "step_loop_instructions": max(spans) if spans else 0}
    if len(out) != len(lab_kernels.BODIES):
        raise AssertionError(f"cuobjdump showed {len(out)} step-loop kernels, not "
                             f"{len(lab_kernels.BODIES)}")
    return out


_NS_LINE = re.compile(r"^(.*?): (\d+) ns/(?:step|logical-step)")


def twin_ns(lines):
    """{body: ns per logical step} from a loop twin's lines."""
    labels = {b.label: b.name for b in lab_bodies.BODIES}
    out = {}
    for ln in lines:
        m = _NS_LINE.match(ln)
        if m and m.group(1) in labels:
            out[labels[m.group(1)]] = int(m.group(2))
    return out


def phase7_lab(smi, dev):
    """The lab kernels: build, the twins as processes on the card (the main
    path, launches counted in each: the shader and slab probes' four
    together, then the deposit probes' five one after another), each
    kernel against its plain version, findings (a)-(h). Returns the
    kernels line's records."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    path = lab_kernels.build()
    lab_kernels.load()
    seconds = time.perf_counter() - t0
    ptxas = ptxas_summary(open(str(path) + ".log").read(), LAB_ENTRIES + LOOP_ENTRIES)
    for entry in ptxas.values():      # the loops launch cols threads, dynamic smem
        entry.pop("blocks_per_sm", None)
    missing = [name for _, name in LAB_ENTRIES + LOOP_ENTRIES if name not in ptxas]
    if missing:
        raise AssertionError(f"ptxas reported no entry for {missing}")
    with tempfile.TemporaryDirectory() as cwd:
        res = run_entries({name: (f"vulkan_forge_torch.lab.{name}", [], {})
                           for name in LAB_TWINS if name not in DEPOSIT_TWINS}, cwd)
        t_twins = time.perf_counter()
        for name in DEPOSIT_TWINS:
            res.update(run_entries({name: (f"vulkan_forge_torch.lab.{name}", [], {})}, cwd))
    twins_seconds = time.perf_counter() - t_twins
    launches, twins = dict.fromkeys(dict(LAB_KERNELS), 0), {}
    for name, want in LAB_TWINS.items():
        rc, stdout, err, counts = res[name]
        if rc != 0:
            raise AssertionError(f"lab twin {name} exited {rc}:\n{stdout}\n{err[-4000:]}")
        for k, n in check_launches(counts, want, f"lab twin {name}").items():
            launches[k] += n
        if f"device: cuda ({smi})" not in stdout:
            raise AssertionError(f"lab twin {name} did not name the card:\n{stdout}")
        print(stdout, end="", flush=True)
        twins[name] = stdout.splitlines()
    if "lane-sliced DMA OK, match: True" not in twins["slab_copy"] \
            or "in-kernel (32,128) transpose: OK" not in twins["slab_transpose"]:
        raise AssertionError("a slab twin did not print its original's OK line")
    twin_steps = {}
    for name in DEPOSIT_TWINS:
        twin_steps.update(twin_ns(twins[name]))
    if sorted(twin_steps) != sorted(lab_kernels.BODIES):
        raise AssertionError(f"the deposit twins printed ns/step for {sorted(twin_steps)}")
    wanted = ("E_exact HIGHEST single-contrib bitexact=True",
              "E_exact tf32x3 single-contrib bitexact=True")
    if any(w not in twins["deposit_breakdown"] for w in wanted):
        raise AssertionError("deposit_breakdown: ffma or tf32x3 lost an E_exact bit")
    facts_lines = [ln for ln in twins["mosaic_facts"] if ln.startswith(("E2", "E3", "E4"))]
    if len(facts_lines) != 5 or not all(ln.endswith("correct=True") for ln in facts_lines):
        raise AssertionError(f"mosaic_facts: E2-E4 not all correct: {facts_lines}")

    ops = lab_fs_ops_checks(dev)
    chain = lab_fs_chain_checks(dev)
    scenes = {}
    for name in lab_fs_chain.SCENES:
        s = lab_fs_chain.from_scene(name, dev)
        if not s["reproduces_images"]:
            raise AssertionError(f"fs_chain --from-scene {name}: the chain's words do not "
                                 "reproduce the images' bytes")
        scenes[name] = s
    sync()
    copy = lab_slab_copy_checks(dev)
    transpose = lab_slab_transpose_checks(dev)
    t_checks = time.perf_counter()
    loops = lab_step_loop_checks(dev)
    for name, rec in loops.items():
        # The twin's launch at the script's NSTEP against this one at 128
        # steps: the cost of a step without the launch's fixed cost.
        nstep = lab_bodies.SCRIPTS[lab_bodies.BY_NAME[name].script]["nstep"]
        rec["twin_ns_per_step"] = twin_steps[name]
        rec["marginal_ns_per_step"] = ((twin_steps[name] * nstep - rec["ms"] * 1e6)
                                       / (nstep - rec["nstep"]))
    dot_facts, dots = lab_onehot_dot_checks(dev)
    lane, e2 = lab_lane_ops_checks(dev)
    sass = sass_loops(path)
    sync()
    # The deposit probes' part of the phase: their five twins and checks.
    t_split = time.perf_counter()
    added = {"deposit_twins_seconds": twins_seconds,
             "deposit_checks_seconds": t_split - t_checks}
    added["added_seconds"] = added["deposit_twins_seconds"] + added["deposit_checks_seconds"]
    say("lab_launch_split", card=smi, **lab_launch_split(dev))
    say("lab_step_split", card=smi, **lab_step_split(dev))
    say("lab_floor", card=smi, **lab_floor(dev))
    sync()
    added["launch_split_seconds"] = time.perf_counter() - t_split
    say("lab", card=smi, build={"seconds": seconds, "library": os.path.relpath(path, ROOT),
                                "ptxas": ptxas},
        launches=launches, fs_ops=ops, fs_chain=chain, slab_copy=copy,
        slab_transpose=transpose, step_loop=loops, onehot_dot=dots, lane_ops=lane, e2=e2)
    say("lab_findings", card=smi,
        a={op: {k: r[k] for k in ("mismatches", "max_ulp", "kernel_vs_f64",
                                  "kernel_vs_f64_misses", "plain_vs_f64",
                                  "plain_vs_f64_misses", "guide_row")}
           for op, r in ops.items()},
        b={name: {"differ": s["differ"], "bytes": s["bytes"], "max_delta": s["max_delta"]}
           for name, s in scenes.items()},
        c={name: s["first_divergence"] for name, s in scenes.items() if s["differ"]},
        d={"slab_copy": {k: {f: v[f] for f in ("ms", "device_ms", "plain_ms", "bound_ms")}
                         for k, v in copy.items()},
           "ns_per_iter": {k: transpose[k]["ns_per_iter"]
                           for k in ("loop_without_transpose", "loop_with_transpose")},
           "device_ns_per_iter": {k: transpose[k]["device_ns_per_iter"]
                                  for k in ("loop_without_transpose", "loop_with_transpose")}},
        e={mode: f for mode, f in dot_facts.items()},
        f={name: {"ns_per_step": twin_steps[name],
                  "marginal_ns_per_step": loops[name]["marginal_ns_per_step"]}
           for name in lab_kernels.BODIES if name.startswith("c_")},
        g={name: {"ns_per_step": twin_steps[name],
                  "marginal_ns_per_step": loops[name]["marginal_ns_per_step"]}
           for name in ("d_base", "d_strips", "d_eval4", "d_mm", "d_full", "v_eval", "v_full",
                        "b_full", "e5")},
        h=sass)
    say("lab_time", seconds=time.perf_counter() - t_phase, **added)
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    total = lambda key: sum(r[key] for r in ops.values())
    return {
        "vf_lab_fs_ops": {
            "launches": launches["vf_lab_fs_ops"],
            "max_abs_err": max(r["max_abs_err"] for r in ops.values()),
            **{k: total(k) for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes", "library_ms": None,
            "per_op": {op: {k: r[k] for k in keys + ("max_ulp", "kernel_vs_f64")}
                       for op, r in ops.items()}},
        "vf_lab_fs_chain": {"launches": launches["vf_lab_fs_chain"],
                            **{k: chain["script_pixels"][k] for k in keys + ("max_abs_err",)},
                            "at_4096_pixels": {k: chain["seeded_4096"][k] for k in keys}},
        "vf_lab_slab_copy": {"launches": launches["vf_lab_slab_copy"],
                             **{k: copy["script"][k] for k in keys + ("max_abs_err",)},
                             "at_fields_g1024_x4": {k: copy["fields_g1024_x4"][k]
                                                    for k in keys}},
        "vf_lab_slab_transpose": {
            "launches": launches["vf_lab_slab_transpose"],
            **{k: transpose["loop_with_transpose"][k] for k in keys + ("max_abs_err",)},
            "ns_per_iter": transpose["loop_with_transpose"]["ns_per_iter"],
            "without_transpose": {k: transpose["loop_without_transpose"][k]
                                  for k in keys + ("ns_per_iter",)},
            "k_correct": {k: transpose["k_correct"][k] for k in keys},
            "e2": {shape: {k: r[k] for k in keys} for shape, r in e2.items()}},
        "vf_lab_step_loop": {
            "launches": launches["vf_lab_step_loop"],
            "max_abs_err": max(r["max_abs_err"] for r in loops.values()),
            **{k: sum(r[k] for r in loops.values()) for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "operations" if sum(r["ops"] for r in loops.values()) / PEAK_F32
            > sum(r["bytes"] for r in loops.values()) / PEAK_BYTES else "bytes",
            "library_ms": None, "at": f"one launch of each of the {len(loops)} bodies, "
                                      f"{LOOP_CHECK_STEPS} steps",
            "per_body": {name: {k: r[k] for k in ("ms", "ns_per_step", "twin_ns_per_step",
                                                  "marginal_ns_per_step", "plain_ms",
                                                  "bound_ms", "bound_by", "bits_differ",
                                                  "max_abs_err")}
                         for name, r in loops.items()}},
        "vf_lab_onehot_dot": {"launches": launches["vf_lab_onehot_dot"],
                              **{k: dots["ffma"]["e1"][k] for k in keys + ("max_abs_err",)},
                              "at": "E1, (96, 128) @ (128, 128), ffma",
                              "per_mode": {mode: {label: {k: r[k] for k in keys + ("max_abs_err",)}
                                                  for label, r in shapes.items()}
                                           for mode, shapes in dots.items()}},
        "vf_lab_lane_ops": {"launches": launches["vf_lab_lane_ops"],
                            **{k: lane["roll"][k] for k in keys + ("max_abs_err",)},
                            "at": "E3, (8, 128) roll by 5",
                            "exponent": {k: lane["exponent"][k] for k in keys}},
    }


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
    vs_err = phase2f_vs_kernel(dev)
    sync()
    fs_err = phase2g_fs_kernel(dev)
    sync()
    launches = phase3_main_path()
    vs_launches = launches["vf_vs_fields"]
    fs_launches = launches["vf_terrain_fs_extended"]
    sync()
    vtx_launches = phase3b_vtx_main_path(dev)
    launches.update({name: vtx_launches[name] for name, _ in VTX_KERNELS})
    sync()
    packed_launches = phase3c_renderer_main_path(dev)
    launches.update({name: packed_launches[name] for name, _ in PACKED_KERNELS})
    sync()
    hw_launches = phase3d_hw_main_path(dev)
    launches.update({name: hw_launches[name] for name, _ in HW_KERNELS})
    launches["vf_rec_setup"] += hw_launches["vf_rec_setup"]
    sync()
    seg_launches, seg_band = phase3e_seg_main_path(dev)
    launches.update({name: seg_launches[name] for name, _ in SEG_KERNELS + SEG_SETUP_KERNELS})
    # The vertex stage runs on every main path (not for the triangle).
    launches["vf_vs_fields"] = vs_launches + sum(
        d["vf_vs_fields"] for d in (vtx_launches, packed_launches, hw_launches, seg_launches))
    # The extended shader runs on every route that shades a g-buffer.
    launches["vf_terrain_fs_extended"] = fs_launches + sum(
        d["vf_terrain_fs_extended"]
        for d in (vtx_launches, packed_launches, hw_launches, seg_launches))
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
    setup_rec = phase4g_seg_setup(smi, dev)
    sync()
    vs_rec = phase4f_vs_timing(smi, dev)
    sync()
    fs_rec = phase4h_fs_timing(smi, dev)
    sync()
    rec_setup_rec = phase4i_rec_setup(smi, dev)
    sync()
    if opts.profile:
        phase5_profile(dev)
        sync()
    phase6_entry_points(smi, dev)
    sync()
    lab_rec = phase7_lab(smi, dev)
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
    # The segment walk's set-up: the JAX pipeline's valid count, walk
    # estimates and compaction around its segment kernel (host and XLA
    # work, no pallas_call); byte-equal to the plain version (4g); the
    # launches are 3e's, the times at the poster cell's frame (4g).
    line.append({"name": "vf_seg_setup", "route": "cuda",
                 "source": "vulkan_forge_torch/csrc/segments.cu",
                 "replaces": "vulkan_forge/_raster/pipeline.py:709-719",
                 "launches": launches["vf_seg_setup"], "max_abs_err": 0,
                 **{k: setup_rec[k] for k in keys + ("device_ms", "bound_share", "at")},
                 "library_ms": None})
    # The vertex stage: the JAX pipeline's vs_fields (terrain_vs or its
    # extended body, then clip_to_fb, stacked), which XLA fuses on the TPU;
    # the times at the relight frame, extended, every shape under "cases".
    line.append({"name": "vf_vs_fields", "route": "cuda", "source": vsrc,
                 "replaces": "vulkan_forge/_raster/pipeline.py:467-482",
                 "launches": launches["vf_vs_fields"], "max_abs_err": vs_err,
                 **{k: vs_rec[k] for k in keys + ("device_ms", "bound_share", "at", "cases")},
                 "library_ms": None})
    # The extended shader: the JAX package's terrain_fs_extended, XLA code
    # (no pallas_call); the times at the poster's g-buffer, relight's under
    # "cases".
    line.append({"name": "vf_terrain_fs_extended", "route": "cuda",
                 "source": "vulkan_forge_torch/csrc/fragment.cu",
                 "replaces": "vulkan_forge/_raster/fragment.py:151-201",
                 "launches": launches["vf_terrain_fs_extended"], "max_abs_err": fs_err,
                 **{k: fs_rec[k] for k in keys + ("device_ms", "bound_share", "at", "cases")},
                 "library_ms": None})
    # The record route's set-up and binning: the JAX package's
    # triangle_setup and bin_triangles (XLA work, no pallas_call);
    # byte-equal to the plain version (4i); the launches are 3's and 3d's,
    # the times at the srtm1.relight_hw cell's frame (4i).
    line.append({"name": "vf_rec_setup", "route": "cuda",
                 "source": "vulkan_forge_torch/csrc/records.cu",
                 "replaces": "vulkan_forge/_raster/setup.py:450-584",
                 "launches": launches["vf_rec_setup"], "max_abs_err": 0,
                 **{k: rec_setup_rec[k] for k in keys + ("device_ms", "bound_share", "at")},
                 "library_ms": None})
    # The lab kernels (csrc/lab.cu): each replaces the kernel a probe script
    # launches; the times are at the twins' shapes (phase 7).
    replaces = {"vf_lab_fs_ops": "scripts/exp_fs_ops.py:70",
                "vf_lab_fs_chain": "scripts/exp_fs_mosaic_ops.py:100",
                "vf_lab_slab_copy": "scripts/exp_lane_dma.py:38",
                "vf_lab_slab_transpose": "scripts/exp_transpose.py:67",
                "vf_lab_step_loop": "scripts/exp_deposit_breakdown.py:56",
                "vf_lab_onehot_dot": "scripts/exp_deposit_breakdown.py:221",
                "vf_lab_lane_ops": "scripts/exp_mosaic_facts.py:130"}
    also = {"vf_lab_slab_transpose": ["scripts/exp_transpose.py:31",
                                      "scripts/exp_mosaic_facts.py:102"],
            "vf_lab_step_loop": ["scripts/exp_deposit3.py:46", "scripts/exp_deposit2.py:54",
                                 "scripts/exp_loop_floor.py:42",
                                 "scripts/exp_mosaic_facts.py:228"],
            "vf_lab_onehot_dot": ["scripts/exp_mosaic_facts.py:61"],
            "vf_lab_lane_ops": ["scripts/exp_mosaic_facts.py:155"]}
    for name, _ in LAB_KERNELS:
        line.append({"name": name, "route": "cuda", "source": "vulkan_forge_torch/csrc/lab.cu",
                     "replaces": replaces[name], **lab_rec[name],
                     **({"also_replaces": also[name]} if name in also else {})})
    say("profiler", fallbacks=PROFILER_FALLBACKS)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
