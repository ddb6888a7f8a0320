"""Many-camera rendering over several devices: data parallelism over frames.

Port of ``vulkan_forge/_parallel.py:17-121``. The reference shards a camera
batch over a 1-D JAX mesh with ``shard_map``; here each torch device takes a
contiguous share of the frames and renders it in one batched call on the
vertex-stream route (``csrc/vtx.cu`` on a card, its plain version on the
CPU). The mesh layout and the strips routing of the reference are TPU
sizing and do not carry over.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from . import _colormap, _formats, _mesh, _trace
from ._camera import look_at_rh, perspective_wgpu
from ._device import resolve_device
from ._raster import pipeline
from ._uniforms import Globals, _normalize
from ._validate import grid as vgrid, size_wh


def _devices(devices):
    """``devices`` as torch devices; None means every visible CUDA device,
    and raises through ``resolve_device`` when there is none."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("need at least one device")
    return devs


def render_spike_frames(width: int, height: int, grid: int,
                        eyes: Sequence, *, colormap: str = "viridis",
                        fovy_deg: float = 45.0, znear: float = 0.1,
                        zfar: float = 100.0,
                        devices: Optional[Sequence] = None) -> np.ndarray:
    """Render B spike-terrain frames (one camera per frame) spread over
    devices. Returns (B, H, W, 4) uint8.

    ``eyes``: sequence of (x, y, z) camera positions (target=origin, up=Y).
    ``devices``: torch devices or strings (default: every visible CUDA
    device). Any frame count works on any device list: the camera batch is
    padded to a multiple of the device count (repeating the last camera)
    and the pad frames are dropped from the result.
    """
    with _trace.call("vf.render_spike_frames"):
        width, height = size_wh(width, height)
        grid = vgrid(grid)
        if colormap not in _colormap.SUPPORTED:
            raise _colormap.unknown_colormap_error(colormap)
        B = len(eyes)
        if B == 0:
            raise ValueError("need at least one camera")
        devs = _devices(devices)
        with _trace.span("vf.inputs", devs):
            n = len(devs)
            with _trace.setup("vf.mesh"):
                xyuv, idx = _mesh.build_grid_xyuv(grid)
            heights = np.zeros((1, 1), np.float32)
            lut = _colormap.build_lut(colormap)[0]
            g = Globals()
            sun = _normalize(np.array([0.5, 1.0, 0.3], np.float32))
            aspect = np.float32(width) / np.float32(height)
            proj = perspective_wgpu(np.float32(math.radians(float(fovy_deg))), aspect,
                                    np.float32(znear), np.float32(zfar))
            views = np.stack([look_at_rh(e, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
                              for e in eyes])
            pad = (-B) % n
            if pad:
                views = np.concatenate([views, np.repeat(views[-1:], pad, axis=0)])
            projs = np.broadcast_to(proj, views.shape).copy()
            share = (B + pad) // n

        frames = []
        for k, dev in enumerate(devs):              # every share launched ...
            s = slice(k * share, (k + 1) * share)
            img = pipeline.render_terrain_batch_u32(
                xyuv, idx, heights, views[s], projs[s], spacing=g.spacing,
                exaggeration=g.exaggeration, h_min=g.h_min, h_max=g.h_max,
                exposure=g.exposure, sun_dir=sun, lut=lut, width=width, height=height,
                fs_mode="shipped", grid_n=grid, device=dev)
            frames.append(_formats.u32_image_to_rgba_u8(img))
        # ... before any is read back.
        out = []
        for f in frames:
            with _trace.span("vf.readback", f.device):
                out.append(_trace.d2h(f).cpu().numpy())
        return np.concatenate(out)[:B]
