"""The ``Renderer`` API object on torch.

Port of ``vulkan_forge/_renderer.py``: the same methods, defaults and error
strings, with an explicit ``device=`` ("cuda", "cpu", or None, which means
"cuda" and raises without a card). Differences by design:

  - The height texture is a float32 tensor on ``self.device``
    (``upload_height_r32f``); ``debug_read_height_patch`` copies it back.
  - The terrain's grid mesh is built on the device from the DEM's size and
    spacing (``grid_mesh``, the vertices and flipped triangles of
    ``_mesh.make_grid``) once per ``add_terrain`` and kept between renders;
    the JAX object rebuilds it in numpy every call. The pixels are the same
    either way.
  - ``render_rgba`` draws through ``_raster.pipeline`` with the extended
    shader and no ``grid_n``, so its frames take the indexed-mesh route
    (``csrc/packed.cu``, the counterpart of K5/K6). ``render_metrics``'
    ``render_ms`` runs to a ``torch.cuda.synchronize()`` on a card;
    ``readback_ms`` is the copy of the finished bytes to the host.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import _colormap, _dem, _formats, _mesh, _trace
from ._camera import look_at_rh, perspective_wgpu
from ._device import resolve_device
from ._io import save_png_rgba
from ._raster import pipeline as _pipeline
from ._uniforms import Globals, sun_dir_spherical

TEXTURE_FORMAT = "Rgba8UnormSrgb"


@dataclass
class TerrainData:
    """Parity: the TerrainData struct (src/lib.rs:870-879)."""
    width: int
    height: int
    spacing: Tuple[float, float]
    exaggeration: float
    colormap: str
    heights: np.ndarray  # row-major (height, width) f32, already * exaggeration


def grid_mesh(width: int, height: int, dx: float, dy: float, device):
    """The Renderer's DEM mesh on ``device``: ``_mesh.make_grid(width,
    height, dx, dy)``'s vertices as (N, 4) f32 [x, y, u, v] and its
    triangles with the [0, 2, 1] winding flip of
    ``vulkan_forge/_renderer.py:279`` as (T, 3) int32.

    The per-axis coordinates come from ``_mesh.grid_axes`` (numpy, the
    same f32 ops); the device only copies them into place and does integer
    index arithmetic, so the values are ``make_grid``'s bit for bit.
    """
    xs, ys, us, vs = (_trace.h2d(a, torch.from_numpy(a).to(device))
                      for a in _mesh.grid_axes(width, height, dx, dy))
    shape = (height, width)
    xyuv = torch.stack([xs[None, :].expand(shape), ys[:, None].expand(shape),
                        us[None, :].expand(shape), vs[:, None].expand(shape)], dim=-1)
    i0 = (torch.arange(height - 1, dtype=torch.int32, device=device)[:, None] * width
          + torch.arange(width - 1, dtype=torch.int32, device=device)[None, :])
    # make_grid's cell is [i0, i1, i2, i2, i1, i3] with i1 = i0 + 1,
    # i2 = i0 + w, i3 = i0 + w + 1; flipped: [i0, i2, i1], [i2, i3, i1].
    tris = torch.stack([i0, i0 + width, i0 + 1, i0 + width, i0 + width + 1, i0 + 1], dim=-1)
    return xyuv.reshape(-1, 4), tris.reshape(-1, 3)


class Renderer:
    """Headless deterministic renderer (parity: src/lib.rs:220-722)."""

    def __init__(self, width: int, height: int, device=None):
        self.device = resolve_device(device)
        self.width = int(width)
        self.height = int(height)
        self._terrain: Optional[TerrainData] = None
        self._terrain_meta = _dem.TerrainMeta()
        self._height_tex: Optional[torch.Tensor] = None  # (H, W) f32 on self.device
        self._mesh = None       # grid_mesh of the terrain, built at its first render
        self._globals = Globals()
        self._globals_dirty = True
        self._last_metrics: Optional[dict] = None

    def render_metrics(self) -> dict:
        """Timing/size metrics of the last render.

        Keys: render_ms (device compute incl. dispatch, to a synchronize),
        readback_ms (device->host copy), total_ms, bytes (framebuffer
        readback size), width, height. None values if nothing rendered yet.
        """
        if self._last_metrics is None:
            return {"render_ms": None, "readback_ms": None, "total_ms": None,
                    "bytes": 0, "width": self.width, "height": self.height}
        return dict(self._last_metrics)

    def _record_metrics(self, render_ms: float, readback_ms: float) -> None:
        self._last_metrics = {
            "render_ms": render_ms,
            "readback_ms": readback_ms,
            "total_ms": render_ms + readback_ms,
            "bytes": self.width * self.height * 4,
            "width": self.width,
            "height": self.height,
        }
        # VF_TRACE=1 streams per-render stage metrics to stderr; any other
        # value is treated as a path to append JSON lines to.
        trace = os.environ.get("VF_TRACE")
        if trace:
            line = json.dumps(self._last_metrics)
            if trace == "1":
                print(f"[vf-trace] {line}", file=sys.stderr)
            else:
                with open(trace, "a") as f:
                    f.write(line + "\n")

    def _timed(self, render) -> np.ndarray:
        """Run render() (a (H, W) uint32 device image), wait for the device,
        read the bytes back and record both times."""
        t0 = time.perf_counter()
        img = render()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            _trace.count("syncs")
        t1 = time.perf_counter()
        with _trace.span("vf.readback", self.device):
            out = _trace.d2h(_formats.u32_image_to_rgba_u8(img)).cpu().numpy()
        t2 = time.perf_counter()
        self._record_metrics((t1 - t0) * 1e3, (t2 - t1) * 1e3)
        return out

    # ---------------- triangle path ----------------

    def info(self) -> str:
        return f"Renderer {self.width}x{self.height}, format={TEXTURE_FORMAT}"

    def render_triangle_rgba(self) -> np.ndarray:
        """Render the fixed gradient triangle -> (H, W, 4) uint8."""
        with _trace.call("vf.Renderer.render_triangle_rgba"):
            return self._timed(lambda: _pipeline.render_triangle_u8(
                self.width, self.height, device=self.device, as_device=True))

    def render_triangle_png(self, path: str) -> None:
        save_png_rgba(str(path), self.render_triangle_rgba())

    # ---------------- terrain state ----------------

    @_trace.setup("vf.Renderer.add_terrain")
    def add_terrain(self, heightmap, spacing, exaggeration=1.0,
                    colormap="viridis") -> None:
        """Store a DEM (heights are multiplied by exaggeration at ingest,
        src/lib.rs:361-385); computes the percentile-clamped height range."""
        sx, sy = float(spacing[0]), float(spacing[1])
        if sx <= 0.0 or sy <= 0.0:
            raise RuntimeError("spacing components must be > 0")
        exaggeration = float(exaggeration)
        if exaggeration <= 0.0:
            raise RuntimeError("exaggeration must be > 0")

        a = heightmap
        if not (isinstance(a, np.ndarray) and a.ndim == 2
                and a.dtype in (np.float32, np.float64)):
            raise RuntimeError(
                "heightmap must be a 2-D NumPy array of dtype float32 or float64")
        if not a.flags["C_CONTIGUOUS"]:
            raise RuntimeError("heightmap must be C-contiguous (row-major)")
        h, w = a.shape
        if w == 0 or h == 0:
            raise RuntimeError("heightmap cannot be empty")

        heights = (a.astype(np.float32) * np.float32(exaggeration))

        self._terrain_meta.compute_and_store_h_range(heights.reshape(-1))

        if colormap not in _colormap.SUPPORTED:
            raise _colormap.unknown_colormap_error(colormap)

        self._terrain = TerrainData(
            width=w, height=h, spacing=(sx, sy), exaggeration=exaggeration,
            colormap=str(colormap), heights=heights)
        self._mesh = None

    def _require_terrain(self) -> TerrainData:
        if self._terrain is None:
            raise RuntimeError("no terrain uploaded; call add_terrain() first")
        return self._terrain

    def terrain_stats(self):
        """(min, max, mean, std) of stored (exaggerated) heights."""
        terr = self._require_terrain()
        return _dem.dem_stats_from_slice(terr.heights)

    def set_height_range(self, min: float, max: float) -> None:
        self._terrain_meta.set_height_range(min, max)

    def set_sun(self, elevation_deg: float, azimuth_deg: float) -> None:
        """Sun by spherical degrees (parity: src/lib.rs:455-463)."""
        if not (math.isfinite(float(elevation_deg)) and math.isfinite(float(azimuth_deg))):
            raise ValueError("angles must be finite")
        self._globals.sun_dir = sun_dir_spherical(elevation_deg, azimuth_deg)
        self._globals_dirty = True

    def set_exposure(self, exposure: float) -> None:
        e = float(exposure)
        if not math.isfinite(e) or e <= 0.0:
            raise ValueError("exposure must be > 0")
        self._globals.exposure = e
        self._globals_dirty = True

    def normalize_terrain(self, mode: str, range=None, eps=None) -> None:
        terr = self._require_terrain()
        mode_l = str(mode).lower()
        if mode_l not in ("minmax", "zscore"):
            raise RuntimeError("mode must be 'minmax' or 'zscore'")
        eps = 1e-8 if eps is None else float(eps)
        range = (0.0, 1.0) if range is None else (float(range[0]), float(range[1]))
        stats = _dem.dem_stats_from_slice(terr.heights)
        terr.heights = _dem.normalize_in_place(terr.heights, mode_l, eps, range, stats)

    # ---------------- height texture path ----------------

    @_trace.setup("vf.Renderer.upload_height_r32f")
    def upload_height_r32f(self) -> None:
        """Upload the stored heights as the device height texture: an
        (H, W) float32 tensor on ``self.device`` (the R32Float texture of
        src/lib.rs:495-571 without its 256-byte row padding); the roundtrip
        is exact."""
        terr = self._require_terrain()
        if terr.width == 0 or terr.height == 0:
            raise RuntimeError("terrain dimensions are zero")
        host = np.ascontiguousarray(terr.heights.reshape(terr.height, terr.width))
        self._height_tex = _trace.h2d(host, torch.as_tensor(host, device=self.device))

    def debug_read_height_patch(self, x: int, y: int, w: int, h: int) -> np.ndarray:
        """Read back an (h, w) float32 patch (parity: src/lib.rs:573-666)."""
        x, y, w, h = int(x), int(y), int(w), int(h)
        if w == 0 or h == 0:
            raise RuntimeError("patch dimensions must be > 0")
        if self._height_tex is None:
            return np.zeros((h, w), dtype=np.float32)
        th, tw = self._height_tex.shape
        if x + w > tw:
            raise RuntimeError(
                f"requested patch exceeds texture bounds in x: x+w ({x + w}) > width ({tw})")
        if y + h > th:
            raise RuntimeError(
                f"requested patch exceeds texture bounds in y: y+h ({y + h}) > height ({th})")
        return np.asarray(self._height_tex[y:y + h, x:x + w].cpu().numpy(),
                          dtype=np.float32)

    def read_full_height_texture(self) -> np.ndarray:
        terr = self._require_terrain()
        if self._height_tex is None:
            raise RuntimeError(
                "no height texture uploaded; call upload_height_r32f() first")
        return self.debug_read_height_patch(0, 0, terr.width, terr.height)

    # ---------------- terrain draw (documented T3.2/T4.x pipeline) ----------------

    def _default_terrain_camera(self, terr: TerrainData):
        """Symmetric framing camera for render_rgba()
        (``vulkan_forge/_renderer.py:230-261``): the centred grid seen from
        the -X side at 45 degrees elevation, panned by half a pixel so that
        the terrain centre projects to the centre of pixel (W//2, H//2)."""
        extent_x = (terr.width - 1) * terr.spacing[0]
        extent_z = (terr.height - 1) * terr.spacing[1]
        extent = max(extent_x, extent_z, 1e-3)
        eye = (-0.9 * extent, 0.9 * extent, 0.0)
        view = look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
        aspect = np.float32(self.width) / np.float32(self.height)
        dist = math.sqrt(2.0) * 0.9 * extent
        proj = perspective_wgpu(np.float32(math.radians(45.0)), aspect,
                                np.float32(max(dist * 1e-3, 1e-3)),
                                np.float32(dist * 10.0 + 10.0))
        shift = np.eye(4, dtype=np.float32)
        shift[0, 3] = 1.0 / np.float32(self.width)
        shift[1, 3] = -1.0 / np.float32(self.height)
        proj = (shift @ proj).astype(np.float32)
        return view, proj

    def render_rgba(self) -> np.ndarray:
        """Draw the uploaded terrain -> (H, W, 4) uint8.

        The documented pipeline: grid mesh from the DEM, forward-difference
        normals, Lambert + ambient floor, Reinhard tonemap in linear, sRGB
        encode.
        """
        with _trace.call("vf.Renderer.render_rgba"):
            with _trace.span("vf.inputs", self.device):
                terr = self._require_terrain()
                if self._mesh is None:
                    with _trace.setup("vf.mesh"):
                        self._mesh = grid_mesh(terr.width, terr.height, terr.spacing[0],
                                               terr.spacing[1], self.device)
                xyuv, tris = self._mesh
                view, proj = self._default_terrain_camera(terr)
                lut, _fmt = _colormap.build_lut(terr.colormap)
                heights = (self._height_tex if self._height_tex is not None
                           else terr.heights.reshape(terr.height, terr.width))
            # Heights were pre-multiplied by exaggeration at ingest and the
            # mesh is already in world units, so spacing/exaggeration enter
            # the vertex stage as 1; the true DEM spacing only scales the
            # normals' slope.
            return self._timed(lambda: _pipeline.render_terrain_u8(
                xyuv, tris, heights, view, proj,
                spacing=1.0, exaggeration=1.0,
                normal_spacing=float(terr.spacing[0]),
                h_min=self._terrain_meta.h_min, h_max=self._terrain_meta.h_max,
                exposure=self._globals.exposure, sun_dir=self._globals.sun_dir,
                lut=lut, width=self.width, height=self.height,
                fs_mode="extended", row_size=2 * (terr.width - 1), device=self.device,
                as_device=True))

    def render_png(self, path: str) -> None:
        save_png_rgba(str(path), self.render_rgba())
