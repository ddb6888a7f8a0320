"""End-to-end render pipelines of the port.

Port of the main path of ``vulkan_forge/_raster/pipeline.py``:

  - ``render_terrain_batch_u32``: B frames of one scene, one camera each
    (mirrors ``_terrain_render_batch_resident``, pipeline.py:374-399, and
    ``_terrain_render_batch_vtx``, pipeline.py:452-514).
  - ``render_terrain_u8``: one frame, shipped or extended fragment shader.
  - ``render_triangle_u8``: the gradient triangle.

Two routes for terrain, picked by ``use_vtx_route``:

  - record route (any mesh): vertex shader (transform.py) -> clip_to_fb +
    triangle setup + binning (setup.py) -> the raster kernels of
    ``csrc/raster.cu``;
  - vertex-stream route (``grid_n`` given and the mesh is
    ``build_grid_xyuv(grid_n)``'s, at any size): vertex shader +
    clip_to_fb into per-vertex fields (vtx.py) -> the kernels of
    ``csrc/vtx.cu``, which build each triangle's record in registers.
    Passing ``grid_n=None`` takes a grid mesh through the record route.

The shipped shader runs inside the last kernel of either route; the
extended shader (``fragment.terrain_fs_extended``) runs in torch after the
route's g-buffer kernel. On the CPU every kernel is its plain version
(kernels.py). The TPU routing thresholds (VMEM sizing) and experiment
knobs of the JAX pipeline are not carried over.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import _formats
from .._device import resolve_device
from . import fragment, kernels, transform, vtx
from .setup import REC_WIDTH, bin_tiles, clip_to_fb, triangle_setup

# Fixed geometry (src/lib.rs:73-78): CCW, u16 indices [0,1,2].
_TRI_POS = np.array([[-0.8, -0.8], [0.8, -0.8], [0.0, 0.8]], dtype=np.float32)
_TRI_COLOR = np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0]],
                      dtype=np.float32)

FS_MODES = ("shipped", "extended")


def _check_render_env() -> None:
    """Refuse settings the port does not render faithfully."""
    if os.environ.get("VF_FILL_RULE", "inclusive") == "hw":
        raise NotImplementedError(
            "VF_FILL_RULE=hw (8.8 snap + top-left rule) is not ported to "
            "vulkan_forge_torch yet; unset it to render the inclusive rule")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on; the renderer's "
            "parity contract is full float32")


def _f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, dtype=np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _tri_indices(indices, device) -> torch.Tensor:
    if not isinstance(indices, torch.Tensor):
        indices = np.asarray(indices, dtype=np.int64)
    return torch.as_tensor(indices, dtype=torch.long, device=device).reshape(-1, 3)


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


def terrain_records(xyuv, indices, heights, views, projs, spacing,
                    exaggeration, width: int, height: int,
                    fs_mode: str = "shipped"):
    """Vertex stage + setup + binning for B cameras of one terrain.

    All tensors on one device; views/projs (B, 4, 4). Returns
    (records (B*(T+1), REC_WIDTH), binning).
    """
    vs = transform.terrain_vs if fs_mode == "shipped" else transform.terrain_vs_extended
    clip, varyings = vs(xyuv, heights, views, projs, spacing, exaggeration)
    x, y, z, w = clip_to_fb(clip, width, height)
    records, bbox = triangle_setup(x, y, z, w, varyings, indices, width, height)
    return records.reshape(-1, REC_WIDTH), bin_tiles(bbox, width, height)


def render_terrain_batch_u32(xyuv, indices, heights, views, projs, *,
                             spacing, exaggeration, h_min, h_max, exposure,
                             sun_dir, lut, width: int, height: int,
                             fs_mode: str = "shipped", normal_spacing=None,
                             grid_n=None, device=None) -> torch.Tensor:
    """Render B frames of one terrain, one camera each.

    xyuv (N, 4), indices (T, 3) or (3T,), heights (Ht, Wt), views/projs
    (B, 4, 4), lut (256, 4): numpy arrays or tensors. ``grid_n`` names the
    ``build_grid_xyuv`` grid the mesh is, which lets dense grids take the
    vertex-stream route (``use_vtx_route``); its indices are then not read.
    fs_mode "shipped" is src/shaders/terrain.wgsl; "extended" the
    documented fwd-diff + Reinhard pipeline (no analytic relief), with
    normals over ``normal_spacing`` (default ``spacing``). Returns
    (B, H, W) uint32 RGBA words on ``device``.
    """
    _check_render_env()
    if fs_mode not in FS_MODES:
        raise ValueError(f"fs_mode must be one of {FS_MODES}, got {fs_mode!r}")
    dev = resolve_device(device)
    xyuv = _f32(xyuv, dev)
    heights = _f32(heights, dev)
    views = _f32(views, dev)
    projs = _f32(projs, dev)
    if views.dim() != 3 or views.shape[1:] != (4, 4) or projs.shape != views.shape:
        raise ValueError("views and projs must both be (B, 4, 4)")
    spacing = _f32(spacing, dev)
    exaggeration = _f32(exaggeration, dev)
    lut = _f32(lut, dev)
    exposure = _f32(exposure, dev)
    sun_dir = _f32(sun_dir, dev)
    h_min, h_max = _f32(h_min, dev), _f32(h_max, dev)
    n_frames = views.shape[0]
    n_tris = int(np.prod(np.shape(indices))) // 3

    if use_vtx_route(grid_n, xyuv.shape[0], n_tris):
        fields = vtx.vs_fields(xyuv, heights, views, projs, spacing, exaggeration,
                               width, height, fs_mode)
        if fs_mode == "shipped":
            return vtx.render_image_vtx_batch(fields, lut, h_max - h_min, exposure,
                                              sun_dir, int(grid_n), width, height)
        gbuf = vtx.render_gbuffer_vtx_batch(fields, int(grid_n), width, height)
    else:
        records, binning = terrain_records(
            xyuv, _tri_indices(indices, dev), heights, views, projs, spacing,
            exaggeration, width, height, fs_mode)
        if fs_mode == "shipped":
            return kernels.raster_shade_shipped(
                records, binning, n_frames, width, height, lut, h_max - h_min,
                exposure, sun_dir)
        gbuf = kernels.raster_gbuffer(records, binning, n_frames, width, height)
    nsp = spacing if normal_spacing is None else _f32(normal_spacing, dev)
    return fragment.terrain_fs_extended(*gbuf, lut, heights, h_min, h_max, exposure,
                                        sun_dir, nsp, exaggeration)


def render_terrain_u8(xyuv, indices, heights, view, proj, *, spacing,
                      exaggeration, h_min, h_max, exposure, sun_dir, lut,
                      width: int, height: int, fs_mode: str = "shipped",
                      normal_spacing=None, grid_n=None, device=None) -> np.ndarray:
    """Render one terrain frame to an (H, W, 4) uint8 numpy array
    (``render_terrain_batch_u32`` with one camera)."""
    img = render_terrain_batch_u32(
        xyuv, indices, heights, _f32(view, None)[None], _f32(proj, None)[None],
        spacing=spacing, exaggeration=exaggeration, h_min=h_min, h_max=h_max,
        exposure=exposure, sun_dir=sun_dir, lut=lut, width=width,
        height=height, fs_mode=fs_mode, normal_spacing=normal_spacing,
        grid_n=grid_n, device=device)[0]
    return _formats.u32_image_to_rgba_u8(img).cpu().numpy()


def triangle_records(width: int, height: int, device):
    """The gradient triangle's (records (2, REC_WIDTH), binning) on ``device``."""
    clip, colors = transform.triangle_vs(_f32(_TRI_POS, device), _f32(_TRI_COLOR, device))
    x, y, z, w = clip_to_fb(clip, width, height)
    indices = torch.tensor([[0, 1, 2]], dtype=torch.long, device=device)
    records, bbox = triangle_setup(x, y, z, w, colors, indices, width, height)
    return records.reshape(-1, REC_WIDTH), bin_tiles(bbox, width, height)


def render_triangle_u8(width: int, height: int, device=None) -> np.ndarray:
    """Deterministic gradient triangle -> (H, W, 4) uint8 numpy array."""
    _check_render_env()
    records, binning = triangle_records(width, height, resolve_device(device))
    v0, v1, v2, mask = kernels.raster_gbuffer(records, binning, 1, width, height)
    img = fragment.triangle_fs(v0[0], v1[0], v2[0], mask[0])
    return _formats.u32_image_to_rgba_u8(img).cpu().numpy()
