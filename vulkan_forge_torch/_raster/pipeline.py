"""End-to-end render pipelines of the port.

Port of the main path of ``vulkan_forge/_raster/pipeline.py``:

  - ``render_terrain_batch_u32``: B frames of one scene, one camera each
    (mirrors ``_terrain_render_batch_resident``, pipeline.py:374-399).
  - ``render_terrain_u8``: one frame, shipped fragment shader.
  - ``render_triangle_u8``: the gradient triangle.

Stages: vertex shader (transform.py) -> clip_to_fb + triangle setup +
binning (setup.py) -> raster. On a CUDA device shipped terrain goes through
the fused raster+shade kernel and the triangle through the g-buffer kernel
followed by ``fragment.triangle_fs``; on the CPU both run the plain
versions (kernels.py). The TPU routing thresholds (VMEM sizing) and
experiment knobs of the JAX pipeline are not carried over.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import _formats
from .._device import resolve_device
from . import fragment, kernels, transform
from .setup import REC_WIDTH, bin_tiles, clip_to_fb, triangle_setup

# Fixed geometry (src/lib.rs:73-78): CCW, u16 indices [0,1,2].
_TRI_POS = np.array([[-0.8, -0.8], [0.8, -0.8], [0.0, 0.8]], dtype=np.float32)
_TRI_COLOR = np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0]],
                      dtype=np.float32)


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


def terrain_records(xyuv, indices, heights, views, projs, spacing,
                    exaggeration, width: int, height: int):
    """Vertex stage + setup + binning for B cameras of one terrain.

    All tensors on one device; views/projs (B, 4, 4). Returns
    (records (B*(T+1), REC_WIDTH), binning).
    """
    clip, varyings = transform.terrain_vs(xyuv, heights, views, projs,
                                          spacing, exaggeration)
    x, y, z, w = clip_to_fb(clip, width, height)
    records, bbox = triangle_setup(x, y, z, w, varyings, indices, width, height)
    return records.reshape(-1, REC_WIDTH), bin_tiles(bbox, width, height)


def render_terrain_batch_u32(xyuv, indices, heights, views, projs, *,
                             spacing, exaggeration, h_min, h_max, exposure,
                             sun_dir, lut, width: int, height: int,
                             device=None) -> torch.Tensor:
    """Render B frames of one terrain, one camera each, shipped shader.

    xyuv (N, 4), indices (T, 3) or (3T,), heights (Ht, Wt), views/projs
    (B, 4, 4), lut (256, 4): numpy arrays or tensors. Returns (B, H, W)
    uint32 RGBA words on ``device``.
    """
    _check_render_env()
    dev = resolve_device(device)
    xyuv = _f32(xyuv, dev)
    indices = _tri_indices(indices, dev)
    views = _f32(views, dev)
    projs = _f32(projs, dev)
    if views.dim() != 3 or views.shape[1:] != (4, 4) or projs.shape != views.shape:
        raise ValueError("views and projs must both be (B, 4, 4)")
    records, binning = terrain_records(
        xyuv, indices, _f32(heights, dev), views, projs, _f32(spacing, dev),
        _f32(exaggeration, dev), width, height)
    h_range = _f32(h_max, dev) - _f32(h_min, dev)
    return kernels.raster_shade_shipped(
        records, binning, views.shape[0], width, height, _f32(lut, dev),
        h_range, _f32(exposure, dev), _f32(sun_dir, dev))


def render_terrain_u8(xyuv, indices, heights, view, proj, *, spacing,
                      exaggeration, h_min, h_max, exposure, sun_dir, lut,
                      width: int, height: int, fs_mode: str = "shipped",
                      device=None) -> np.ndarray:
    """Render one terrain frame to an (H, W, 4) uint8 numpy array."""
    if fs_mode != "shipped":
        raise NotImplementedError(
            f"fs_mode={fs_mode!r} is not ported to vulkan_forge_torch yet")
    img = render_terrain_batch_u32(
        xyuv, indices, heights, _f32(view, None)[None], _f32(proj, None)[None],
        spacing=spacing, exaggeration=exaggeration, h_min=h_min, h_max=h_max,
        exposure=exposure, sun_dir=sun_dir, lut=lut, width=width,
        height=height, device=device)[0]
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
