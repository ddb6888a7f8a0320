"""End-to-end render pipelines of the port.

Port of the main path of ``vulkan_forge/_raster/pipeline.py``:

  - ``render_terrain_batch_u32``: B frames of one scene, one camera each
    (mirrors ``_terrain_render_batch_resident``, pipeline.py:374-399, and
    ``_terrain_render_batch_vtx``, pipeline.py:452-514).
  - ``render_terrain_u8``: one frame, shipped or extended fragment shader.
  - ``render_triangle_u8``: the gradient triangle.

Four routes for terrain, picked by ``use_segment_route``,
``use_vtx_route`` and ``use_indexed_route``:

  - segment-walk route (single frames only, inclusive rule, more than
    ``SEGMENT_THRESHOLD`` triangles, and a height of ``STRIP_LIMIT_H`` or
    more in whole 8-row tiles, i.e. H >= 4089; every mesh, either shader;
    the JAX package's tall-frame route, pipeline.py:705-723): vertex
    shader + clip_to_fb into per-vertex fields (vtx.py) -> inclusive
    records (setup.py) -> culled, compacted stream and per-(mesh-row,
    tile-column) interval tables, row-major or column-major by a work
    estimate (segments.py) -> the kernels of ``csrc/segments.cu``;
  - vertex-stream route (``grid_n`` given and the mesh is
    ``build_grid_xyuv(grid_n)``'s, at any size): vertex shader +
    clip_to_fb into per-vertex fields (vtx.py) -> the kernels of
    ``csrc/vtx.cu``, which build each triangle's record in registers from
    its grid corners;
  - indexed-mesh route (no ``grid_n``, the extended shader: every
    ``Renderer`` frame): the same per-vertex fields -> the kernels of
    ``csrc/packed.cu``, which read each triangle's corners through the
    int32 index buffer (packed.py);
  - record route (the rest: shipped-shader meshes without ``grid_n``, the
    triangle): vertex shader (transform.py) -> clip_to_fb + triangle setup
    + binning (setup.py) -> the raster kernels of ``csrc/raster.cu``.
    Passing ``grid_n=None`` takes a shipped grid mesh through it.

The shipped shader runs inside the last kernel of each route; the
extended shader (``fragment.terrain_fs_extended``, the kernel
``vf_terrain_fs_extended`` on the card) runs after the route's g-buffer
kernel, with a numeric ``normal_spacing`` passed by value. On the CPU
every kernel is its plain version (kernels.py). The TPU routing
thresholds (VMEM sizing) and experiment knobs of the JAX pipeline are
not carried over, except the tall-frame condition, which the port
copies so that the same frames walk segments
(the reference's narrow-frame exception, ``_vtx_ok`` admitting W <= 128
up to H ~ 4915, is VMEM sizing and is not copied).

``VF_FILL_RULE=hw`` (read by the single-frame entries, ``fill_rule=`` on
the batched one) selects the hardware fill rule: 8.8-snapped setup and
top-left edge thresholds. Its records exist only on the record route, so
every hw frame takes it, grid or not, shipped or extended, tall or not, as
every hw frame of ``vulkan_forge`` takes its record kernels
(pipeline.py:605-613, 705).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import _formats, _trace
from .._device import resolve_device
from . import fragment, kernels, packed, segments, transform, vtx
from .setup import (FILL_RULES, REC_WIDTH, bin_tiles, check_fill_rule, clip_to_fb,
                    tile_grid, triangle_setup)

# Fixed geometry (src/lib.rs:73-78): CCW, u16 indices [0,1,2].
_TRI_POS = np.array([[-0.8, -0.8], [0.8, -0.8], [0.0, 0.8]], dtype=np.float32)
_TRI_COLOR = np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0]],
                      dtype=np.float32)

FS_MODES = ("shipped", "extended")

# The JAX package's tall-frame condition. Above this triangle count a
# single frame streams its mesh (vulkan_forge/_raster/pipeline.py:66) ...
SEGMENT_THRESHOLD = 20_000
# ... and its strip accumulators fit VMEM while the frame's height, in whole
# 8-row tiles, stays below this (``_strips_fit``, pipeline.py:205-208:
# h8 * 128 * 4 * 6 < 12 MiB); taller frames walk segments (:705-723).
STRIP_LIMIT_H = 4096


def fill_rule_from_env() -> str:
    """``VF_FILL_RULE``: "hw" (8.8 snap + top-left rule) or "inclusive";
    any other value means "inclusive", as in ``vulkan_forge`` (pipeline.py:
    609-611)."""
    rule = os.environ.get("VF_FILL_RULE", "inclusive")
    return rule if rule in FILL_RULES else "inclusive"


def _check_render_env() -> None:
    """Refuse settings the port does not render faithfully."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on; the renderer's "
            "parity contract is full float32")


def _f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, dtype=np.float32)
    return _trace.h2d(x, torch.as_tensor(x, dtype=torch.float32, device=device))


def _tri_indices(indices, device) -> torch.Tensor:
    if not isinstance(indices, torch.Tensor):
        indices = np.asarray(indices, dtype=np.int64)
    return _trace.h2d(indices, torch.as_tensor(indices, dtype=torch.long,
                                               device=device)).reshape(-1, 3)


def _tri_indices_i32(indices, n_vertices: int, device) -> torch.Tensor:
    """The indexed route's (T, 3) int32 index buffer on ``device``; an int32
    tensor already there is used as it is. The kernels read vertices
    through it, so every index must lie in [0, n_vertices)."""
    if not isinstance(indices, torch.Tensor):
        indices = np.asarray(indices).reshape(-1, 3).astype(np.int32)
    idx = _trace.h2d(indices, torch.as_tensor(indices, dtype=torch.int32,
                                              device=device)).reshape(-1, 3)
    if idx.numel():
        lo, hi = (int(_trace.d2h(v)) for v in torch.aminmax(idx))
        if lo < 0 or hi >= n_vertices:
            raise ValueError(f"indices must lie in [0, {n_vertices}), got [{lo}, {hi}]")
    return idx.contiguous()


def use_vtx_route(grid_n, n_vertices: int, n_triangles: int) -> bool:
    """Vertex-stream route eligibility: the caller names the grid
    (``grid_n``, which asserts the ``build_grid_xyuv(grid_n)`` topology, as
    the JAX package's ``_vtx_ok`` takes it) and the vertex and triangle
    counts are that grid's. There is no size crossover: the route sweep of
    chip_smoke.py (phase 4b, PERF.md) measured this route faster than the
    record route at every grid from 8 to 1024 at 800x600, one frame and
    four, on an H100. (The JAX package's crossover, about 40K triangles,
    pipeline.py:616-634, is sized to TPU VMEM.)"""
    if grid_n is None or int(grid_n) < 2:
        return False
    n = int(grid_n)
    return n_vertices == n * n and n_triangles == vtx.n_triangles(n)


def use_indexed_route(grid_n, fs_mode: str) -> bool:
    """Indexed-mesh route eligibility: a mesh that does not take the
    vertex-stream route, drawn with the extended shader (every
    ``Renderer.render_rgba`` frame). There is no size crossover: the route
    sweep of chip_smoke.py (phase 4c, PERF.md) measured it faster than the
    record route at every DEM size from 32^2 to 2048^2 at 800x600 on an
    H100. (The JAX package's threshold, 20,000 triangles, pipeline.py:66,
    is sized to TPU VMEM.) The shipped shader keeps the record route, whose
    kernel fuses it."""
    return fs_mode == "extended" and grid_n is None


def use_segment_route(n_triangles: int, height: int, fill_rule: str) -> bool:
    """Segment-walk route eligibility of a single frame, as
    ``vulkan_forge``'s ``render_terrain_u8`` routes it (pipeline.py:705):
    the inclusive rule, more than ``SEGMENT_THRESHOLD`` triangles, and a
    height of at least ``STRIP_LIMIT_H`` in whole 8-row tiles (H >= 4089).
    Batched frames never take it (the reference's batched entries do not,
    pipeline.py:805 has no caller), and it is not re-routed by speed here:
    PERF.md has its times against the routes these frames took before."""
    h8 = -(-height // segments.TILE_H) * segments.TILE_H
    return fill_rule == "inclusive" and n_triangles > SEGMENT_THRESHOLD \
        and h8 >= STRIP_LIMIT_H


def _gbuffer_kernel(hw: bool):
    """The record route's g-buffer kernel for records set up under the hw
    rule or not."""
    return kernels.raster_gbuffer_hw if hw else kernels.raster_gbuffer


def terrain_records(xyuv, indices, heights, views, projs, spacing,
                    exaggeration, width: int, height: int,
                    fs_mode: str = "shipped", fill_rule: str = "inclusive"):
    """Vertex stage + setup + binning for B cameras of one terrain, the
    setup and binning in the span ``vf.rec.setup``.

    All tensors on one device; views/projs (B, 4, 4). Returns
    (records (B*(T+1), REC_WIDTH), binning), the records set up under
    ``fill_rule``.
    """
    vs = transform.terrain_vs if fs_mode == "shipped" else transform.terrain_vs_extended
    clip, varyings = vs(xyuv, heights, views, projs, spacing, exaggeration)
    x, y, z, w = clip_to_fb(clip, width, height)
    with _trace.span("vf.rec.setup", x.device):
        records, bbox = triangle_setup(x, y, z, w, varyings, indices, width, height,
                                       fill_rule)
        binning = bin_tiles(bbox, width, height)
        if _trace.on():
            _record_counters(bbox, binning, views.shape[0] * width * height)
    return records.reshape(-1, REC_WIDTH), binning


def _record_counters(bbox, binning, pixels: int) -> None:
    """Tally a traced frame batch's record-route counters: the binned
    records, kept on the device, and the pairs, the offsets and the
    frames' ``pixels``, known on the host."""
    _trace.device_sum("rec_binned", (bbox[..., 1] >= bbox[..., 0]).sum())
    _trace.count("rec_pairs", binning.rows.numel())
    _trace.count("rec_offsets", binning.offsets.numel())
    _trace.count("rec_pixels", pixels)


def _frame_inputs(fs_mode, fill_rule, device, xyuv, heights, views, projs, *scalars):
    """Check the render settings and put the inputs on the device: (device,
    hw, [xyuv, heights, views, projs] + scalars as float32 tensors)."""
    _check_render_env()
    if fs_mode not in FS_MODES:
        raise ValueError(f"fs_mode must be one of {FS_MODES}, got {fs_mode!r}")
    hw = check_fill_rule(fill_rule) == "hw"
    dev = resolve_device(device)
    views, projs = _f32(views, dev), _f32(projs, dev)
    if views.dim() != 3 or views.shape[1:] != (4, 4) or projs.shape != views.shape:
        raise ValueError("views and projs must both be (B, 4, 4)")
    return dev, hw, [_f32(xyuv, dev), _f32(heights, dev), views, projs,
                     *(_f32(a, dev) for a in scalars)]


def render_terrain_batch_u32(xyuv, indices, heights, views, projs, *,
                             spacing, exaggeration, h_min, h_max, exposure,
                             sun_dir, lut, width: int, height: int,
                             fs_mode: str = "shipped", normal_spacing=None,
                             grid_n=None, fill_rule: str = "inclusive",
                             device=None) -> torch.Tensor:
    """Render B frames of one terrain, one camera each.

    xyuv (N, 4), indices (T, 3) or (3T,), heights (Ht, Wt), views/projs
    (B, 4, 4), lut (256, 4): numpy arrays or tensors. ``grid_n`` names the
    ``build_grid_xyuv`` grid the mesh is, which lets dense grids take the
    vertex-stream route (``use_vtx_route``); its indices are then not read.
    fs_mode "shipped" is src/shaders/terrain.wgsl; "extended" the
    documented fwd-diff + Reinhard pipeline (no analytic relief), with
    normals over ``normal_spacing`` (default ``spacing``). fill_rule "hw"
    (8.8 snap + top-left rule) takes every mesh through the record route,
    whose records carry the edge thresholds, as ``vulkan_forge`` sends
    every hw frame to its record kernels (pipeline.py:612-613); this entry
    does not read ``VF_FILL_RULE`` (the reference's batched entries take no
    fill rule). Returns (B, H, W) uint32 RGBA words on ``device``.
    """
    with _trace.span("vf.inputs", device):
        dev, hw, (xyuv, heights, views, projs, spacing, exaggeration, lut, exposure,
                  sun_dir, h_min, h_max) = _frame_inputs(
            fs_mode, fill_rule, device, xyuv, heights, views, projs, spacing, exaggeration,
            lut, exposure, sun_dir, h_min, h_max)
        n_frames = views.shape[0]
        n_tris = int(np.prod(np.shape(indices))) // 3

    # The vtx and indexed routes set up in registers without the hw rule's
    # snap and edge thresholds.
    if not hw and use_vtx_route(grid_n, xyuv.shape[0], n_tris):
        with _trace.span("vf.vertex", dev):
            fields = vtx.vs_fields(xyuv, heights, views, projs, spacing, exaggeration,
                                   width, height, fs_mode)
        with _trace.span("vf.raster", dev):
            if fs_mode == "shipped":
                return vtx.render_image_vtx_batch(fields, lut, h_max - h_min, exposure,
                                                  sun_dir, int(grid_n), width, height)
            gbuf = vtx.render_gbuffer_vtx_batch(fields, int(grid_n), width, height)
    elif not hw and use_indexed_route(grid_n, fs_mode):
        with _trace.span("vf.vertex", dev):
            fields = vtx.vs_fields(xyuv, heights, views, projs, spacing, exaggeration,
                                   width, height, fs_mode)
        with _trace.span("vf.raster", dev):
            gbuf = packed.render_gbuffer_packed_batch(
                fields, _tri_indices_i32(indices, xyuv.shape[0], dev), width, height)
    else:
        with _trace.span("vf.vertex", dev):
            records, binning = terrain_records(
                xyuv, _tri_indices(indices, dev), heights, views, projs, spacing,
                exaggeration, width, height, fs_mode, fill_rule)
        with _trace.span("vf.raster", dev):
            if fs_mode == "shipped":
                shade = (kernels.raster_shade_shipped_hw if hw
                         else kernels.raster_shade_shipped)
                return shade(records, binning, n_frames, width, height, lut,
                             h_max - h_min, exposure, sun_dir)
            ntx, nty = tile_grid(width, height)
            evaluated = _trace.device_count("rec_items", (n_frames, nty * ntx), dev)
            gbuf = _gbuffer_kernel(hw)(records, binning, n_frames, width, height, evaluated)
            if evaluated is not None:
                _trace.device_sum("rec_covered", gbuf[3].sum())
    with _trace.span("vf.shade", dev):
        nsp = spacing if normal_spacing is None else normal_spacing
        return fragment.terrain_fs_extended(*gbuf, lut, heights, h_min, h_max, exposure,
                                            sun_dir, nsp, exaggeration)


def render_terrain_u8(xyuv, indices, heights, view, proj, *, spacing,
                      exaggeration, h_min, h_max, exposure, sun_dir, lut,
                      width: int, height: int, fs_mode: str = "shipped",
                      normal_spacing=None, row_size=None, grid_n=None,
                      device=None, as_device: bool = False):
    """Render one terrain frame to an (H, W, 4) uint8 numpy array, under
    the fill rule of ``VF_FILL_RULE``, or with ``as_device`` its (H, W)
    uint32 words on the device, as the JAX entry returns them.

    A tall frame takes the segment-walk route (``use_segment_route``); any
    other frame is ``render_terrain_batch_u32`` with one camera.
    ``row_size`` is the id stride of one mesh row (pipeline.py:574), which
    the segment walk reads: by default ``2 * (grid_n - 1)`` when ``grid_n``
    is given, else the triangle count (one row: plain interval binning,
    pipeline.py:709). No other route reads it.
    """
    with _trace.span("vf.inputs", device):
        rule = fill_rule_from_env()
        n_tris = int(np.prod(np.shape(indices))) // 3
        args = dict(spacing=spacing, exaggeration=exaggeration, h_min=h_min, h_max=h_max,
                    exposure=exposure, sun_dir=sun_dir, lut=lut, width=width,
                    height=height, fs_mode=fs_mode, normal_spacing=normal_spacing,
                    grid_n=grid_n, device=device)
        segment = use_segment_route(n_tris, height, rule)
        if not segment:
            views, projs = _f32(view, None)[None], _f32(proj, None)[None]
    if segment:
        img = render_terrain_segments_u32(xyuv, indices, heights, view, proj,
                                          row_size=row_size, **args)
    else:
        img = render_terrain_batch_u32(xyuv, indices, heights, views, projs,
                                       fill_rule=rule, **args)[0]
    if as_device:
        return img
    with _trace.span("vf.readback", device):
        return _trace.d2h(_formats.u32_image_to_rgba_u8(img)).cpu().numpy()


def segment_frame(fields, indices, grid_n, width: int, height: int, row_size=None):
    """One frame's segment-walk inputs from its post-VS fields (1, 7, N)
    (``kernels.seg_setup``): inclusive records, built from grid corners
    when ``grid_n`` names the mesh (its indices are not read) and through
    the index buffer otherwise; the walk order (``segments.walk_order``,
    with ``row_size`` as ``render_terrain_u8`` defaults it); the compacted
    stream. Returns (records, ids, bbox, binning) for
    ``segments.stack_frames``."""
    n_tris = int(np.prod(np.shape(indices))) // 3
    if use_vtx_route(grid_n, fields.shape[2], n_tris):
        idx, grid = None, int(grid_n)
    else:
        idx, grid = _tri_indices_i32(indices, fields.shape[2], fields.device), None
    if not row_size:
        row_size = 2 * (int(grid_n) - 1) if grid_n else n_tris
    return kernels.seg_setup(fields, idx, grid, width, height, int(row_size))[:4]


def _walk_counters(frame, width: int, height: int, device):
    """Tally a traced frame's segment-walk counters (``frame`` from
    ``segments.stack_frames``) and return the kernel's ``evaluated``
    output, whose sum tallies as ``seg_pairs``."""
    _trace.count("seg_records", frame[0].shape[0])
    _trace.count("seg_table_bytes", segments.table_bytes(frame[3]))
    _trace.count("seg_pixels", width * height)
    ntx, nty = segments.seg_grid(width, height)
    return _trace.device_count("seg_pairs", (1, ntx * nty), device)


def render_terrain_segments_u32(xyuv, indices, heights, view, proj, *, spacing,
                                exaggeration, h_min, h_max, exposure, sun_dir, lut,
                                width: int, height: int, fs_mode: str = "shipped",
                                normal_spacing=None, row_size=None, grid_n=None,
                                device=None) -> torch.Tensor:
    """One terrain frame through the segment-walk route (inclusive rule):
    vertex stage, ``segment_frame``, then ``vf_seg_shade_shipped`` for the
    shipped shader or ``vf_seg_gbuffer`` and the extended shader. The
    arguments are ``render_terrain_u8``'s. Returns (H, W) uint32 RGBA on
    ``device``."""
    with _trace.span("vf.inputs", device):
        dev, _, (xyuv, heights, views, projs, spacing, exaggeration, lut, exposure,
                 sun_dir, h_min, h_max) = _frame_inputs(
            fs_mode, "inclusive", device, xyuv, heights, _f32(view, None)[None],
            _f32(proj, None)[None], spacing, exaggeration, lut, exposure, sun_dir, h_min,
            h_max)
    with _trace.span("vf.vertex", dev):
        fields = vtx.vs_fields(xyuv, heights, views, projs, spacing, exaggeration, width,
                               height, fs_mode)
    evaluated = None
    with _trace.span("vf.raster", dev):
        with _trace.span("vf.seg.bin", dev):
            frame = segments.stack_frames([segment_frame(fields, indices, grid_n, width,
                                                         height, row_size)])
            if _trace.on():
                evaluated = _walk_counters(frame, width, height, dev)
        del fields
        if fs_mode == "shipped":
            return segments.render_image_segments_batch(*frame, 1, width, height, lut,
                                                        h_max - h_min, exposure, sun_dir,
                                                        evaluated)[0]
        gbuf = segments.render_gbuffer_segments_batch(*frame, 1, width, height, evaluated)
        del frame                    # free the records before the shader allocates
    with _trace.span("vf.shade", dev):
        nsp = spacing if normal_spacing is None else normal_spacing
        return fragment.terrain_fs_extended(*gbuf, lut, heights, h_min, h_max, exposure,
                                            sun_dir, nsp, exaggeration)[0]


def triangle_records(width: int, height: int, device, fill_rule: str = "inclusive"):
    """The gradient triangle's (records (2, REC_WIDTH), binning) on
    ``device``, set up under ``fill_rule``."""
    clip, colors = transform.triangle_vs(_f32(_TRI_POS, device), _f32(_TRI_COLOR, device))
    x, y, z, w = clip_to_fb(clip, width, height)
    indices = _trace.h2d(None, torch.tensor([[0, 1, 2]], dtype=torch.long, device=device))
    records, bbox = triangle_setup(x, y, z, w, colors, indices, width, height, fill_rule)
    return records.reshape(-1, REC_WIDTH), bin_tiles(bbox, width, height)


def render_triangle_u8(width: int, height: int, device=None, as_device: bool = False):
    """Deterministic gradient triangle under the fill rule of
    ``VF_FILL_RULE`` -> (H, W, 4) uint8 numpy array, or with ``as_device``
    its (H, W) uint32 words on the device."""
    with _trace.span("vf.inputs", device):
        _check_render_env()
        rule = fill_rule_from_env()
        dev = resolve_device(device)
    with _trace.span("vf.vertex", dev):
        records, binning = triangle_records(width, height, dev, rule)
    with _trace.span("vf.raster", dev):
        v0, v1, v2, mask = _gbuffer_kernel(rule == "hw")(records, binning, 1, width, height)
    with _trace.span("vf.shade", dev):
        img = fragment.triangle_fs(v0[0], v1[0], v2[0], mask[0])
    if as_device:
        return img
    with _trace.span("vf.readback", dev):
        return _trace.d2h(_formats.u32_image_to_rgba_u8(img)).cpu().numpy()
