"""Build, binding and wrappers of the hand-written CUDA raster kernels.

``csrc/raster.cu`` holds four kernels over one raster body of triangle
records (see the note at the top of that file for what each replaces and
what bounds it):

  - ``raster_gbuffer`` -> ``vf_raster_gbuffer``: replaces
    ``pallas_backend._kernel`` (K1, pallas_backend.py:33) and the inclusive
    rule of ``strips._strip_kernel`` (K7, strips.py:155).
  - ``raster_shade_shipped`` -> ``vf_raster_shade_shipped``: replaces
    ``packed._packed_kernel_resident_fused`` (K4, packed.py:755) with the
    shipped fragment shader ``fragment.terrain_fs_tile`` (K2,
    fragment.py:81) in its epilogue.
  - ``raster_gbuffer_hw`` -> ``vf_raster_gbuffer_hw`` and
    ``raster_shade_shipped_hw`` -> ``vf_raster_shade_shipped_hw``: the
    hardware fill rule (``VF_FILL_RULE=hw``) of K1 and K7 over records set
    up with ``fill_rule="hw"``; their plain versions are the same as the
    inclusive kernels', which read each edge's threshold from the records.

``csrc/vtx.cu`` holds the vertex-stream route's four kernels, one wrapper
each, which together replace ``vtx._vtx_kernel`` (K3a, vtx.py:590) and
``vtx._vtx_kernel_fused`` (K3b, vtx.py:616):

  - ``vtx_cover`` -> ``vf_vtx_cover`` and ``vtx_cover_big`` ->
    ``vf_vtx_cover_big``: the per-pixel winning triangle id;
  - ``vtx_resolve_gbuffer`` -> ``vf_vtx_resolve_gbuffer`` (K3a's output)
    and ``vtx_resolve_shade_shipped`` -> ``vf_vtx_resolve_shade_shipped``
    (K3b's).

``vtx.render_gbuffer_vtx_batch`` and ``vtx.render_image_vtx_batch`` chain
them. It also holds the vertex stage of the vtx, indexed and segment
routes, ``vs_fields`` -> ``vf_vs_fields``: the post-VS fields that every
one of their kernels reads (``vtx.vs_fields`` dispatches to it).

``csrc/packed.cu`` holds the indexed-mesh route's three kernels, which
together replace ``packed._packed_kernel`` (K5, packed.py:222) and
``packed._packed_id_kernel`` with ``_varyings_from_ids`` (K6, packed.py:580,
:704), merged:

  - ``packed_cover`` -> ``vf_packed_cover`` and ``packed_cover_big`` ->
    ``vf_packed_cover_big``: the per-pixel winning triangle id;
  - ``packed_resolve_gbuffer`` -> ``vf_packed_resolve_gbuffer``: the
    g-buffer.

``packed.render_gbuffer_packed_batch`` chains them.

``csrc/segments.cu`` holds the tall-frame route's two kernels, one body,
which replace ``segments._seg_kernel`` (K8, segments.py:159):

  - ``seg_gbuffer`` -> ``vf_seg_gbuffer``: the segment walk's g-buffer;
  - ``seg_shade_shipped`` -> ``vf_seg_shade_shipped``: the same with the
    shipped fragment shader fused;

and the chain that builds what they read from a frame's post-VS fields,
``seg_setup`` -> ``vf_seg_setup_*`` (eight kernels: bbox, then per walk
axis the tables' init, count, scan, binning, tables and prefix, then the
compaction), which replaces the route's torch set-up
(``segments.setup_frame_plain``; no pallas_call: the JAX package's set-up
is host and XLA work). ``pipeline.segment_frame`` calls it.

``csrc/records.cu`` holds the record route's set-up and binning,
``rec_setup`` -> ``vf_rec_setup_*`` and ``vf_rec_sort_*`` (the corners'
bbox test and counts, their scan, the binned triangles' records and
pairs, a radix sort of the pairs by tile, the tiles' offsets), which
replaces the route's torch set-up (``setup.rec_setup_plain``:
``triangle_setup`` and ``bin_tiles``; no pallas_call: the JAX package's
set-up is XLA work). ``pipeline.terrain_records`` and
``pipeline.triangle_records`` call it.

``csrc/fragment.cu`` holds the extended fragment shader over a g-buffer,
``terrain_fs_extended`` -> ``vf_terrain_fs_extended`` (no pallas_call: the
JAX package's shader is XLA code); ``fragment.terrain_fs_extended``
dispatches to it on every route that shades a g-buffer.

The sources (and the header they share, ``csrc/raster_common.cuh``) are
compiled on first use with ``nvcc``, one process per source started
together, and linked into one shared library with a plain C interface,
``libvf_raster_<hash>.so``, which ``_build.py`` builds, loads and binds
(see there). Kernels launch on torch's current stream through
``_build.launch`` and never synchronise.

Each wrapper takes a CPU tensor to its plain PyTorch version (tiles.py,
fragment.py, vtx.py, packed.py, segments.py, setup.py) and launches the kernel for a
CUDA tensor, or raises; it counts its kernel launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build, _trace
from . import fragment, packed, segments, setup, tiles, vtx
from .setup import REC_WIDTH, TILE, Binning, tile_grid

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC = _PKG_DIR / "csrc"
_SOURCES = (_CSRC / "raster.cu", _CSRC / "vtx.cu", _CSRC / "packed.cu",
            _CSRC / "segments.cu", _CSRC / "fragment.cu", _CSRC / "records.cu")
_HEADERS = (_CSRC / "raster_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "vf_raster_gbuffer": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "vf_raster_gbuffer_hw": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                             _P],
    "vf_raster_shade_shipped": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                _P],
    "vf_raster_shade_shipped_hw": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                   _P],
    "vf_tile": [],
    "vf_vtx_cover": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vf_vtx_cover_patches": [_I],
    "vf_vtx_cover_big": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    "vf_vtx_resolve_gbuffer": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "vf_vtx_resolve_shade_shipped": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vf_vtx_big_pixels": [],
    "vf_vs_fields": [_P, _I, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P],
    "vf_big_tile": [],
    "vf_resolve_tile_w": [],
    "vf_resolve_warp_w": [],
    "vf_packed_cover": [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "vf_packed_cover_blocks": [_I],
    "vf_packed_cover_big": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "vf_packed_resolve_gbuffer": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    "vf_packed_big_pixels": [],
    "vf_seg_gbuffer": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P],
    "vf_seg_shade_shipped": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P],
    "vf_seg_tile_h": [],
    "vf_seg_tile_w": [],
    "vf_seg_scan_block": [],
    "vf_seg_rec_width": [],
    "vf_seg_setup_bbox": [_P, _I, _P, _I, _I, _I, _I, _P, _P],
    "vf_seg_setup_init": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "vf_seg_setup_count": [_P, _I, _I, _I, _I, _I, _P, _P],
    "vf_seg_setup_scan": [_P, _I, _P, _P, _P],
    "vf_seg_setup_bin": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "vf_seg_setup_tables": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "vf_seg_setup_prefix": [_I, _I, _P, _P, _P, _P, _P],
    "vf_seg_setup_compact": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                             _P],
    "vf_rec_block": [],
    "vf_rec_sort_block": [],
    "vf_rec_digit_bits": [],
    "vf_rec_tile": [],
    "vf_rec_width": [],
    "vf_rec_setup_count": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vf_rec_setup_totals": [_P, _P, _P, _I, _P, _P, _P, _P],
    "vf_rec_setup_emit": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                          _P],
    "vf_rec_sort_count": [_P, _I, _I, _P, _P],
    "vf_rec_sort_scan": [_P, _I, _P, _P, _P],
    "vf_rec_sort_scatter": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    "vf_rec_setup_offsets": [_P, _I, _I, _P, _P],
    "vf_terrain_fs_extended": [_P, _P, _P, _P, _L, _P, _P, _I, _I, _P, _P, _P, _P, _P, _F, _P,
                               _I, _P, _P],
}

# Stream positions of one block of the set-up's scan: kScanBlock in
# csrc/segments.cu.
SEG_SCAN_BLOCK = 1024
# The record set-up's blocks (csrc/records.cu): triangles of one frame a
# block of its counts (kBlock), pairs a block of its sort (kSortBlock), and
# the key bits a sort pass orders (kDigitBits).
REC_BLOCK, REC_SORT_BLOCK, REC_DIGIT_BITS = 1024, 2048, 8


def _contract():
    """What load() holds the built library to: (C getter, its source under
    csrc/, the Python constant it must equal, that constant's value)."""
    return (("vf_tile", "raster.cu", "setup.TILE", TILE),
            ("vf_vtx_big_pixels", "vtx.cu", "vtx.BIG_PIXELS", vtx.BIG_PIXELS),
            ("vf_packed_big_pixels", "packed.cu", "vtx.BIG_PIXELS", vtx.BIG_PIXELS),
            ("vf_big_tile", "raster_common.cuh", "vtx.BIG_TILE", vtx.BIG_TILE),
            ("vf_resolve_tile_w", "raster_common.cuh", "vtx.RESOLVE_TILE_W", vtx.RESOLVE_TILE_W),
            ("vf_resolve_warp_w", "raster_common.cuh", "vtx.RESOLVE_WARP_W", vtx.RESOLVE_WARP_W),
            ("vf_seg_tile_h", "segments.cu", "segments.TILE_H", segments.TILE_H),
            ("vf_seg_tile_w", "segments.cu", "segments.TILE_W", segments.TILE_W),
            ("vf_seg_scan_block", "segments.cu", "kernels.SEG_SCAN_BLOCK", SEG_SCAN_BLOCK),
            ("vf_seg_rec_width", "segments.cu", "setup.REC_WIDTH", REC_WIDTH),
            ("vf_rec_block", "records.cu", "kernels.REC_BLOCK", REC_BLOCK),
            ("vf_rec_sort_block", "records.cu", "kernels.REC_SORT_BLOCK", REC_SORT_BLOCK),
            ("vf_rec_digit_bits", "records.cu", "kernels.REC_DIGIT_BITS", REC_DIGIT_BITS),
            ("vf_rec_tile", "records.cu", "setup.TILE", TILE),
            ("vf_rec_width", "records.cu", "setup.REC_WIDTH", REC_WIDTH))


_lib = None


def library_path() -> Path:
    return _build.library_path("raster", _SOURCES + _HEADERS, NVCC_FLAGS)


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built;
    the ``-Xptxas -v`` report is kept as ``<library>.log``."""
    return _build.build(library_path(), _SOURCES, NVCC_FLAGS)


def load():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib
    if _lib is None:
        with _trace.setup("vf.setup.load"):
            _lib = _build.load(build(), _SIGNATURES, "the raster kernels", _contract())
    return _lib


def _check_inputs(records: torch.Tensor, binning: Binning, n_frames: int,
                  width: int, height: int, evaluated=None) -> None:
    if records.dtype != torch.float32 or records.dim() != 2 \
            or records.shape[1] != REC_WIDTH or not records.is_contiguous():
        raise ValueError(f"records must be contiguous float32 (R, {REC_WIDTH}), "
                         f"got {records.dtype} {tuple(records.shape)}")
    if records.shape[0] >= 2**31:
        raise ValueError("records must stay below 2**31 rows (the kernels keep row + 1 "
                         "in an int32)")
    ntx, nty = tile_grid(width, height)
    for name, t in (("rows", binning.rows), ("offsets", binning.offsets),
                    ("boxes", binning.boxes)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"binning.{name} must be contiguous 1-D int32")
        if t.device != records.device:
            raise ValueError(f"binning.{name} is on {t.device}, records on {records.device}")
    if binning.offsets.numel() != n_frames * ntx * nty + 1:
        raise ValueError("binning.offsets does not match the frame and tile counts")
    if binning.boxes.numel() != binning.rows.numel():
        raise ValueError("binning.boxes must hold one box per row")
    if evaluated is not None:
        shape = (n_frames, nty * ntx)
        if evaluated.dtype != torch.int32 or tuple(evaluated.shape) != shape \
                or not evaluated.is_contiguous():
            raise ValueError(f"evaluated must be contiguous int32 {shape}, got "
                             f"{evaluated.dtype} {tuple(evaluated.shape)}")
        if evaluated.device != records.device:
            raise ValueError(f"evaluated is on {evaluated.device}, records on "
                             f"{records.device}")
    if records.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {records.device}")
    # The kernels read records 16 bytes at a time.
    if records.data_ptr() % 16:
        raise ValueError("records must start on a 16-byte boundary")


def _launch_args(records, binning, n_frames, width, height):
    ntx, nty = tile_grid(width, height)
    return [records.data_ptr(), REC_WIDTH, binning.rows.data_ptr(),
            binning.boxes.data_ptr(), binning.offsets.data_ptr(), n_frames * ntx * nty,
            ntx, nty, width, height]


def _plain_work(evaluated, binning) -> None:
    """Fill ``evaluated`` (if given) with each tile's (pair, pixel) items
    from the torch mirror, ``tiles.tile_work``."""
    if evaluated is not None:
        evaluated.copy_(tiles.tile_work(binning).view(evaluated.shape))


def _gbuffer(wrapper, symbol: str, records, binning, n_frames: int, width: int,
             height: int, evaluated):
    """The g-buffer kernel ``symbol`` (or its plain version for CPU
    tensors), counted on ``wrapper.launches``."""
    _check_inputs(records, binning, n_frames, width, height, evaluated)
    if records.device.type == "cpu":
        _plain_work(evaluated, binning)
        return tiles.render_gbuffer(records, binning, n_frames, width, height)
    shape = (n_frames, height, width)
    opts = dict(dtype=torch.float32, device=records.device)
    v0, v1, v2 = (torch.empty(shape, **opts) for _ in range(3))
    mask = torch.empty(shape, dtype=torch.bool, device=records.device)
    _build.launch(wrapper, getattr(load(), symbol), records,
                  *_launch_args(records, binning, n_frames, width, height),
                  v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), mask.data_ptr(),
                  None if evaluated is None else evaluated.data_ptr())
    return v0, v1, v2, mask


def raster_gbuffer(records: torch.Tensor, binning: Binning, n_frames: int,
                   width: int, height: int, evaluated=None):
    """Binned records -> g-buffer (v0, v1, v2, mask), each (B, H, W).
    ``evaluated``, a (B, NTY*NTX) int32 tensor or None, receives the (pair,
    pixel) items each tile walked (a check; the route passes None).

    CPU tensors: tiles.render_gbuffer (``evaluated`` from tiles.tile_work).
    CUDA tensors: ``vf_raster_gbuffer``.
    """
    return _gbuffer(raster_gbuffer, "vf_raster_gbuffer", records, binning, n_frames,
                    width, height, evaluated)


def raster_gbuffer_hw(records: torch.Tensor, binning: Binning, n_frames: int,
                      width: int, height: int, evaluated=None):
    """``raster_gbuffer`` under the hardware fill rule, over records set up
    with ``fill_rule="hw"``.

    CPU tensors: tiles.render_gbuffer. CUDA tensors: ``vf_raster_gbuffer_hw``.
    """
    return _gbuffer(raster_gbuffer_hw, "vf_raster_gbuffer_hw", records, binning,
                    n_frames, width, height, evaluated)


raster_gbuffer.launches = 0
raster_gbuffer_hw.launches = 0


def _shade(wrapper, symbol: str, records, binning, n_frames: int, width: int,
           height: int, lut, h_range, exposure, sun_dir, evaluated):
    """The shading kernel ``symbol`` (or its plain version for CPU
    tensors), counted on ``wrapper.launches``."""
    _check_inputs(records, binning, n_frames, width, height, evaluated)
    _check_shading(lut, h_range, exposure, sun_dir, records.device)
    if records.device.type == "cpu":
        _plain_work(evaluated, binning)
        v0, v1, v2, mask = tiles.render_gbuffer(records, binning, n_frames, width, height)
        return fragment.terrain_fs(v0, v1, v2, mask, lut, h_range, exposure,
                                   sun_dir)
    par, lut_rgb = shading_params(h_range, exposure, sun_dir), lut[:, :3].contiguous()
    image = torch.empty((n_frames, height, width), dtype=torch.int32,
                        device=records.device)
    _build.launch(wrapper, getattr(load(), symbol), records,
                  *_launch_args(records, binning, n_frames, width, height),
                  lut_rgb.data_ptr(), par.data_ptr(), image.data_ptr(),
                  None if evaluated is None else evaluated.data_ptr())
    return image.view(torch.uint32)


def raster_shade_shipped(records: torch.Tensor, binning: Binning,
                         n_frames: int, width: int, height: int,
                         lut: torch.Tensor, h_range: torch.Tensor,
                         exposure: torch.Tensor, sun_dir: torch.Tensor, evaluated=None):
    """Binned records -> (B, H, W) uint32 RGBA through the shipped shader;
    ``evaluated`` as in ``raster_gbuffer``.

    CPU tensors: tiles.render_gbuffer then fragment.terrain_fs. CUDA
    tensors: ``vf_raster_shade_shipped``, with hr2, exposure and the
    normalized sun computed here by ``fragment.fs_scalars``.
    """
    return _shade(raster_shade_shipped, "vf_raster_shade_shipped", records, binning,
                  n_frames, width, height, lut, h_range, exposure, sun_dir, evaluated)


def raster_shade_shipped_hw(records: torch.Tensor, binning: Binning,
                            n_frames: int, width: int, height: int,
                            lut: torch.Tensor, h_range: torch.Tensor,
                            exposure: torch.Tensor, sun_dir: torch.Tensor,
                            evaluated=None):
    """``raster_shade_shipped`` under the hardware fill rule, over records
    set up with ``fill_rule="hw"``.

    CPU tensors: tiles.render_gbuffer then fragment.terrain_fs. CUDA
    tensors: ``vf_raster_shade_shipped_hw``.
    """
    return _shade(raster_shade_shipped_hw, "vf_raster_shade_shipped_hw", records, binning,
                  n_frames, width, height, lut, h_range, exposure, sun_dir, evaluated)


raster_shade_shipped.launches = 0
raster_shade_shipped_hw.launches = 0


# ---------------- vertex stage (csrc/vtx.cu) ----------------

def _check_vs_inputs(xyuv, heights, views, projs, spacing, exaggeration,
                     fs_mode: str) -> None:
    if fs_mode not in ("shipped", "extended"):
        raise ValueError(f"fs_mode must be 'shipped' or 'extended', got {fs_mode!r}")
    tensors = (("xyuv", xyuv), ("heights", heights), ("views", views), ("projs", projs),
               ("spacing", spacing), ("exaggeration", exaggeration))
    for name, t in tensors:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 tensor, got "
                             f"{getattr(t, 'dtype', type(t).__name__)}")
        if t.device != xyuv.device:
            raise ValueError(f"{name} is on {t.device}, xyuv on {xyuv.device}")
    if xyuv.dim() != 2 or xyuv.shape[1] != 4:
        raise ValueError(f"xyuv must be (N, 4), got {tuple(xyuv.shape)}")
    if xyuv.shape[0] >= 2**31:
        raise ValueError("xyuv must stay below 2**31 vertices")
    if heights.dim() != 2 or heights.numel() == 0:
        raise ValueError(f"heights must be a non-empty (Ht, Wt), got {tuple(heights.shape)}")
    if views.dim() != 3 or views.shape[1:] != (4, 4) or projs.shape != views.shape:
        raise ValueError(f"views and projs must both be (B, 4, 4), got "
                         f"{tuple(views.shape)} and {tuple(projs.shape)}")
    if spacing.numel() != 1 or exaggeration.numel() != 1:
        raise ValueError("spacing and exaggeration must hold one value each")
    if xyuv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xyuv.device}")


def vs_fields(xyuv: torch.Tensor, heights: torch.Tensor, views: torch.Tensor,
              projs: torch.Tensor, spacing: torch.Tensor, exaggeration: torch.Tensor,
              width: int, height: int, fs_mode: str = "shipped") -> torch.Tensor:
    """The vertex stage: post-VS fields (B, 7, N) float32 of B cameras
    (arguments as ``vtx.vs_fields``).

    CPU tensors: vtx.vs_fields_plain. CUDA tensors: ``vf_vs_fields``, which
    reads spacing and exaggeration on the device. No vertex or no camera:
    the empty fields, on either device, with nothing launched or counted.
    """
    _check_vs_inputs(xyuv, heights, views, projs, spacing, exaggeration, fs_mode)
    B, N = views.shape[0], xyuv.shape[0]
    if B * N == 0:
        return torch.empty((B, vtx.FIELDS, N), dtype=torch.float32, device=xyuv.device)
    if xyuv.device.type == "cpu":
        return vtx.vs_fields_plain(xyuv, heights, views, projs, spacing, exaggeration,
                                   width, height, fs_mode)
    for name, t in (("xyuv", xyuv), ("heights", heights), ("views", views),
                    ("projs", projs)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # The kernel reads each vertex's [x, z, u, v] as one 16-byte load.
    if xyuv.data_ptr() % 16:
        raise ValueError("xyuv must start on a 16-byte boundary")
    fields = torch.empty((B, vtx.FIELDS, N), dtype=torch.float32, device=xyuv.device)
    _build.launch(vs_fields, load().vf_vs_fields, xyuv, xyuv.data_ptr(), N,
                  heights.data_ptr(), heights.shape[0], heights.shape[1], views.data_ptr(),
                  projs.data_ptr(), B, spacing.data_ptr(), exaggeration.data_ptr(), width,
                  height, int(fs_mode == "shipped"), fields.data_ptr())
    return fields


vs_fields.launches = 0


# ---------------- vertex-stream route (csrc/vtx.cu) ----------------

def _check_fields(fields: torch.Tensor, n: int) -> None:
    if fields.dtype != torch.float32 or fields.dim() != 3 \
            or fields.shape[1] != vtx.FIELDS or fields.shape[2] != n * n \
            or not fields.is_contiguous():
        raise ValueError(f"fields must be contiguous float32 (B, {vtx.FIELDS}, "
                         f"{n}*{n}), got {fields.dtype} {tuple(fields.shape)}")
    if n < 2:
        raise ValueError(f"grid_n must be >= 2, got {n}")
    if fields.shape[0] * vtx.n_triangles(n) >= 2**31:
        raise ValueError("frames * triangles must stay below 2**31 (int32 ids)")
    if fields.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {fields.device}")


def _check_winner(winner: torch.Tensor, fields: torch.Tensor) -> None:
    if winner.dtype != torch.int32 or winner.dim() != 3 \
            or winner.shape[0] != fields.shape[0] or not winner.is_contiguous():
        raise ValueError(f"winner must be contiguous int32 (B, H, W), got "
                         f"{winner.dtype} {tuple(winner.shape)}")
    if winner.device != fields.device:
        raise ValueError(f"winner is on {winner.device}, fields on {fields.device}")


def _check_frame(width: int, height: int) -> None:
    # The cover kernels keep a survivor's pixel bbox in 26 + 6 bits a side.
    if not (0 < width < 2**26 and 0 < height < 2**26):
        raise ValueError(f"width and height must be in [1, 2**26), got {width}x{height}")


def _check_survivors(survivors, fields: torch.Tensor) -> None:
    if survivors is None:
        return
    B = fields.shape[0]
    if survivors.dtype != torch.int32 or tuple(survivors.shape) != (B,) \
            or not survivors.is_contiguous():
        raise ValueError(f"survivors must be contiguous int32 ({B},), got "
                         f"{survivors.dtype} {tuple(survivors.shape)}")
    if survivors.device != fields.device:
        raise ValueError(f"survivors is on {survivors.device}, fields on {fields.device}")


def _block_counts(survivors, blocks: int, device):
    """Where a cover kernel writes its survivors, one count per block (the
    wrapper sums them per frame), or None when ``survivors`` is None."""
    return None if survivors is None else torch.empty(blocks, dtype=torch.int32, device=device)


def vtx_cover(fields: torch.Tensor, grid_n: int, width: int, height: int, survivors=None):
    """Cover pass: (winner (B, H, W) int32 = max id+1 of the triangles of at
    most ``vtx.BIG_PIXELS`` bbox pixels, big (B*T,) int32 list of the
    others as frame*T + id, count (1,) int32). ``survivors``, an int32 (B,)
    tensor or None, receives per frame the triangles the pass walks (valid,
    at most BIG_PIXELS bbox pixels: those that passed the kernel's bbox
    test; a check, the route passes None).

    CPU tensors: vtx.cover_plain. CUDA tensors: ``vf_vtx_cover``.
    """
    _check_fields(fields, grid_n)
    _check_frame(width, height)
    _check_survivors(survivors, fields)
    if fields.device.type == "cpu":
        stats = {}
        out = vtx.cover_plain(fields, grid_n, width, height, stats)
        if survivors is not None:
            survivors.copy_(stats["survivors"])
        return out
    B = fields.shape[0]
    winner = torch.zeros((B, height, width), dtype=torch.int32, device=fields.device)
    big = torch.empty(B * vtx.n_triangles(grid_n), dtype=torch.int32, device=fields.device)
    count = torch.zeros(1, dtype=torch.int32, device=fields.device)
    lib = load()
    per = _block_counts(survivors, B * lib.vf_vtx_cover_patches(grid_n), fields.device)
    _build.launch(vtx_cover, lib.vf_vtx_cover, fields, fields.data_ptr(), B, grid_n, width,
                  height, winner.data_ptr(), big.data_ptr(), count.data_ptr(),
                  None if per is None else per.data_ptr())
    if per is not None:
        survivors.copy_(per.view(B, -1).sum(dim=1))
    return winner, big, count


vtx_cover.launches = 0


def _check_big_list(fields: torch.Tensor, big: torch.Tensor, count: torch.Tensor,
                    walked, entries: int) -> None:
    for name, t in (("big", big), ("count", count), ("walked", walked)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous 1-D int32")
        if t.device != fields.device:
            raise ValueError(f"{name} is on {t.device}, fields on {fields.device}")
    if big.numel() != entries or count.numel() != 1:
        raise ValueError("big must hold frames * triangles entries and count one")
    if walked is not None and walked.numel() != entries:
        raise ValueError("walked must hold frames * triangles entries, as big")


def vtx_cover_big(fields: torch.Tensor, grid_n: int, winner: torch.Tensor,
                  big: torch.Tensor, count: torch.Tensor, walked=None) -> torch.Tensor:
    """Big-triangle pass: deposits the listed triangles into ``winner`` in
    place and returns it. ``walked``, an int32 tensor shaped as ``big`` or
    None, receives the tiles walked for each list entry (``walked[i]`` for
    ``big[i]``, i < count; a check, the route passes None).

    CPU tensors: vtx.cover_big_plain (``walked`` from vtx.big_walk_counts).
    CUDA tensors: ``vf_vtx_cover_big``.
    """
    _check_fields(fields, grid_n)
    _check_winner(winner, fields)
    _check_big_list(fields, big, count, walked, fields.shape[0] * vtx.n_triangles(grid_n))
    _, height, width = winner.shape
    if fields.device.type == "cpu":
        if walked is not None:
            walked[:int(count[0])] = vtx.big_walk_counts(fields, grid_n, big, count,
                                                         width, height)
        return vtx.cover_big_plain(fields, grid_n, winner, big, count)
    _build.launch(vtx_cover_big, load().vf_vtx_cover_big, fields, fields.data_ptr(), grid_n,
                  width, height, big.data_ptr(), count.data_ptr(), winner.data_ptr(),
                  None if walked is None else walked.data_ptr())
    return winner


vtx_cover_big.launches = 0


def vtx_resolve_gbuffer(fields: torch.Tensor, grid_n: int, winner: torch.Tensor):
    """Resolve to the g-buffer (v0, v1, v2, mask), each (B, H, W).

    CPU tensors: vtx.resolve_gbuffer_plain. CUDA tensors:
    ``vf_vtx_resolve_gbuffer``.
    """
    _check_fields(fields, grid_n)
    _check_winner(winner, fields)
    if fields.device.type == "cpu":
        return vtx.resolve_gbuffer_plain(fields, grid_n, winner)
    B, height, width = winner.shape
    v0, v1, v2 = (torch.empty_like(winner, dtype=torch.float32) for _ in range(3))
    mask = torch.empty_like(winner, dtype=torch.bool)
    _build.launch(vtx_resolve_gbuffer, load().vf_vtx_resolve_gbuffer, fields,
                  fields.data_ptr(), B, grid_n, width, height, winner.data_ptr(),
                  v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), mask.data_ptr())
    return v0, v1, v2, mask


vtx_resolve_gbuffer.launches = 0


def _check_shading(lut, h_range, exposure, sun_dir, device) -> None:
    if lut.shape != (256, 4) or lut.dtype != torch.float32:
        raise ValueError(f"lut must be float32 (256, 4), got {lut.dtype} {tuple(lut.shape)}")
    for name, t in (("lut", lut), ("h_range", h_range), ("exposure", exposure),
                    ("sun_dir", sun_dir)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the frame on {device}")


def shading_params(h_range: torch.Tensor, exposure: torch.Tensor, sun_dir: torch.Tensor):
    """par = [hr2, exposure, l0, l1, l2] (5,) float32 with
    ``fragment.fs_scalars``'s ops, on the tensors' device: what the fused
    shading kernels and the lab's ``fs_chain`` read."""
    hr2, expo, l = fragment.fs_scalars(h_range, exposure, sun_dir)
    return torch.stack([hr2, expo, l[0], l[1], l[2]]).to(torch.float32).contiguous()


def vtx_resolve_shade_shipped(fields: torch.Tensor, grid_n: int,
                              winner: torch.Tensor, lut: torch.Tensor,
                              h_range: torch.Tensor, exposure: torch.Tensor,
                              sun_dir: torch.Tensor) -> torch.Tensor:
    """Resolve through the shipped shader: (B, H, W) uint32 RGBA.

    CPU tensors: vtx.resolve_shade_shipped_plain. CUDA tensors:
    ``vf_vtx_resolve_shade_shipped``.
    """
    _check_fields(fields, grid_n)
    _check_winner(winner, fields)
    _check_shading(lut, h_range, exposure, sun_dir, fields.device)
    if fields.device.type == "cpu":
        return vtx.resolve_shade_shipped_plain(fields, grid_n, winner, lut, h_range,
                                               exposure, sun_dir)
    B, height, width = winner.shape
    par, lut_rgb = shading_params(h_range, exposure, sun_dir), lut[:, :3].contiguous()
    image = torch.empty_like(winner)
    _build.launch(vtx_resolve_shade_shipped, load().vf_vtx_resolve_shade_shipped, fields,
                  fields.data_ptr(), B, grid_n, width, height, winner.data_ptr(),
                  lut_rgb.data_ptr(), par.data_ptr(), image.data_ptr())
    return image.view(torch.uint32)


vtx_resolve_shade_shipped.launches = 0


# ---------------- indexed-mesh route (csrc/packed.cu) ----------------

def _check_indexed(fields: torch.Tensor, indices: torch.Tensor) -> None:
    if fields.dtype != torch.float32 or fields.dim() != 3 \
            or fields.shape[1] != vtx.FIELDS or not fields.is_contiguous():
        raise ValueError(f"fields must be contiguous float32 (B, {vtx.FIELDS}, N), "
                         f"got {fields.dtype} {tuple(fields.shape)}")
    if indices.dtype != torch.int32 or indices.dim() != 2 or indices.shape[1] != 3 \
            or not indices.is_contiguous():
        raise ValueError(f"indices must be contiguous int32 (T, 3), got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    if indices.device != fields.device:
        raise ValueError(f"indices is on {indices.device}, fields on {fields.device}")
    if fields.shape[0] * indices.shape[0] >= 2**31 or fields.shape[2] >= 2**31:
        raise ValueError("frames * triangles and vertices must stay below 2**31 "
                         "(int32 ids)")
    if fields.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {fields.device}")


def packed_cover(fields: torch.Tensor, indices: torch.Tensor, width: int, height: int,
                 survivors=None):
    """Cover pass of the indexed route: (winner (B, H, W) int32 = max id+1
    of the triangles of at most ``vtx.BIG_PIXELS`` bbox pixels, big (B*T,)
    int32 list of the others as frame*T + id, count (1,) int32);
    ``survivors`` as in ``vtx_cover``.

    CPU tensors: packed.cover_plain. CUDA tensors: ``vf_packed_cover``.
    """
    _check_indexed(fields, indices)
    _check_frame(width, height)
    _check_survivors(survivors, fields)
    if fields.device.type == "cpu":
        stats = {}
        out = packed.cover_plain(fields, indices, width, height, stats)
        if survivors is not None:
            survivors.copy_(stats["survivors"])
        return out
    B, _, nv = fields.shape
    T = indices.shape[0]
    winner = torch.zeros((B, height, width), dtype=torch.int32, device=fields.device)
    big = torch.empty(B * T, dtype=torch.int32, device=fields.device)
    count = torch.zeros(1, dtype=torch.int32, device=fields.device)
    lib = load()
    per = _block_counts(survivors, B * lib.vf_packed_cover_blocks(T), fields.device)
    _build.launch(packed_cover, lib.vf_packed_cover, fields, fields.data_ptr(), B, nv,
                  indices.data_ptr(), T, width, height, winner.data_ptr(), big.data_ptr(),
                  count.data_ptr(), None if per is None else per.data_ptr())
    if per is not None:
        survivors.copy_(per.view(B, -1).sum(dim=1))
    return winner, big, count


packed_cover.launches = 0


def packed_cover_big(fields: torch.Tensor, indices: torch.Tensor, winner: torch.Tensor,
                     big: torch.Tensor, count: torch.Tensor, walked=None) -> torch.Tensor:
    """Big-triangle pass of the indexed route: deposits the listed
    triangles into ``winner`` in place and returns it; ``walked`` as in
    ``vtx_cover_big``.

    CPU tensors: packed.cover_big_plain (``walked`` from
    packed.big_walk_counts). CUDA tensors: ``vf_packed_cover_big``.
    """
    _check_indexed(fields, indices)
    _check_winner(winner, fields)
    _check_big_list(fields, big, count, walked, fields.shape[0] * indices.shape[0])
    _, height, width = winner.shape
    if fields.device.type == "cpu":
        if walked is not None:
            walked[:int(count[0])] = packed.big_walk_counts(fields, indices, big, count,
                                                            width, height)
        return packed.cover_big_plain(fields, indices, winner, big, count)
    _build.launch(packed_cover_big, load().vf_packed_cover_big, fields, fields.data_ptr(),
                  fields.shape[2], indices.data_ptr(), indices.shape[0], width, height,
                  big.data_ptr(), count.data_ptr(), winner.data_ptr(),
                  None if walked is None else walked.data_ptr())
    return winner


packed_cover_big.launches = 0


def packed_resolve_gbuffer(fields: torch.Tensor, indices: torch.Tensor,
                           winner: torch.Tensor):
    """Resolve of the indexed route to the g-buffer (v0, v1, v2, mask),
    each (B, H, W).

    CPU tensors: packed.resolve_gbuffer_plain. CUDA tensors:
    ``vf_packed_resolve_gbuffer``.
    """
    _check_indexed(fields, indices)
    _check_winner(winner, fields)
    if fields.device.type == "cpu":
        return packed.resolve_gbuffer_plain(fields, indices, winner)
    B, height, width = winner.shape
    v0, v1, v2 = (torch.empty_like(winner, dtype=torch.float32) for _ in range(3))
    mask = torch.empty_like(winner, dtype=torch.bool)
    _build.launch(packed_resolve_gbuffer, load().vf_packed_resolve_gbuffer, fields,
                  fields.data_ptr(), B, fields.shape[2], indices.data_ptr(), width, height,
                  winner.data_ptr(), v0.data_ptr(), v1.data_ptr(), v2.data_ptr(),
                  mask.data_ptr())
    return v0, v1, v2, mask


packed_resolve_gbuffer.launches = 0


# ---------------- tall-frame route (csrc/segments.cu) ----------------

def _check_segments(records: torch.Tensor, ids: torch.Tensor, bbox: torch.Tensor, binning,
                    n_frames: int, width: int, height: int, evaluated=None) -> None:
    if records.dtype != torch.float32 or records.dim() != 2 \
            or records.shape[1] != REC_WIDTH or not records.is_contiguous():
        raise ValueError(f"records must be contiguous float32 (N, {REC_WIDTH}), "
                         f"got {records.dtype} {tuple(records.shape)}")
    n = records.shape[0]
    if ids.dtype != torch.int32 or ids.shape != (n,) or not ids.is_contiguous():
        raise ValueError(f"ids must be contiguous int32 ({n},), got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if bbox.dtype != torch.int32 or bbox.shape != (n, 4) or not bbox.is_contiguous():
        raise ValueError(f"bbox must be contiguous int32 ({n}, 4), got "
                         f"{bbox.dtype} {tuple(bbox.shape)}")
    if n >= 2**31:
        raise ValueError("the stacked records must stay below 2**31 rows")
    ntx, nty = segments.seg_grid(width, height)
    rows = binning.seg_lo.shape[-1]
    shapes = {"seg_lo": (n_frames, ntx, rows), "seg_hi": (n_frames, ntx, rows),
              "row_base": (n_frames, rows), "r_bounds": (n_frames, 2, nty),
              "seg_y": (n_frames, ntx, rows, 2), "tile_order": (n_frames, nty * ntx)}
    tensors = {f"binning.{name}": (getattr(binning, name), shape)
               for name, shape in shapes.items()}
    if evaluated is not None:
        tensors["evaluated"] = (evaluated, (n_frames, nty * ntx))
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != records.device:
            raise ValueError(f"{name} is on {t.device}, records on {records.device}")
    for name, t in (("ids", ids), ("bbox", bbox)):
        if t.device != records.device:
            raise ValueError(f"{name} is on {t.device}, records on {records.device}")
    if records.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {records.device}")
    # The kernels copy records and read bboxes 16 bytes at a time.
    if records.data_ptr() % 16 or bbox.data_ptr() % 16:
        raise ValueError("records and bbox must start on a 16-byte boundary")
    if ids.numel() and int(_trace.d2h(ids.min())) < 0:
        raise ValueError("ids must be original triangle ids, >= 0")
    order = binning.tile_order
    if order.numel() and not torch.equal(
            _trace.sync(order.sort(-1).values),
            torch.arange(nty * ntx, device=order.device, dtype=torch.int32).expand_as(order)):
        raise ValueError("binning.tile_order must be a permutation of each frame's tiles")


def _seg_args(records, ids, bbox, binning, n_frames, width, height):
    ntx, nty = segments.seg_grid(width, height)
    return [records.data_ptr(), REC_WIDTH, ids.data_ptr(), bbox.data_ptr(),
            binning.seg_lo.data_ptr(), binning.seg_hi.data_ptr(), binning.seg_y.data_ptr(),
            binning.row_base.data_ptr(), binning.r_bounds.data_ptr(),
            binning.tile_order.data_ptr(), n_frames, binning.seg_lo.shape[-1], ntx, nty,
            width, height]


def _plain_evaluated(evaluated, bbox, binning, n_frames, width, height):
    """Fill ``evaluated`` (if given) with the pairs each tile's kernel would
    evaluate, from the torch mirror of its skip tests."""
    if evaluated is not None:
        offsets = segments.overlap_walk(bbox, binning, n_frames, width, height)[1]
        evaluated.copy_((offsets[1:] - offsets[:-1]).view(evaluated.shape))


def seg_gbuffer(records: torch.Tensor, ids: torch.Tensor, bbox: torch.Tensor, binning,
                n_frames: int, width: int, height: int, evaluated=None):
    """Compacted records -> g-buffer (v0, v1, v2, mask), each (B, H, W),
    through the segment walk (see segments.render_gbuffer_segments_batch).
    ``evaluated``, a (B, NTY*NTX) int32 tensor or None, receives the
    (tile, record) pairs each tile evaluated (a check; the route passes
    None).

    CPU tensors: segments.render_gbuffer_segments_plain (``evaluated`` from
    segments.overlap_walk). CUDA tensors: ``vf_seg_gbuffer``.
    """
    _check_segments(records, ids, bbox, binning, n_frames, width, height, evaluated)
    if records.device.type == "cpu":
        _plain_evaluated(evaluated, bbox, binning, n_frames, width, height)
        return segments.render_gbuffer_segments_plain(records, ids, binning, n_frames,
                                                      width, height)
    shape = (n_frames, height, width)
    v0, v1, v2 = (torch.empty(shape, dtype=torch.float32, device=records.device)
                  for _ in range(3))
    mask = torch.empty(shape, dtype=torch.bool, device=records.device)
    _build.launch(seg_gbuffer, load().vf_seg_gbuffer, records,
                  *_seg_args(records, ids, bbox, binning, n_frames, width, height),
                  v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), mask.data_ptr(),
                  None if evaluated is None else evaluated.data_ptr())
    return v0, v1, v2, mask


seg_gbuffer.launches = 0


def seg_shade_shipped(records: torch.Tensor, ids: torch.Tensor, bbox: torch.Tensor, binning,
                      n_frames: int, width: int, height: int, lut: torch.Tensor,
                      h_range: torch.Tensor, exposure: torch.Tensor, sun_dir: torch.Tensor,
                      evaluated=None) -> torch.Tensor:
    """Compacted records -> (B, H, W) uint32 RGBA through the segment walk
    and the shipped shader; ``evaluated`` as in ``seg_gbuffer``.

    CPU tensors: segments.render_image_segments_plain. CUDA tensors:
    ``vf_seg_shade_shipped``.
    """
    _check_segments(records, ids, bbox, binning, n_frames, width, height, evaluated)
    _check_shading(lut, h_range, exposure, sun_dir, records.device)
    if records.device.type == "cpu":
        _plain_evaluated(evaluated, bbox, binning, n_frames, width, height)
        return segments.render_image_segments_plain(records, ids, binning, n_frames, width,
                                                    height, lut, h_range, exposure, sun_dir)
    par, lut_rgb = shading_params(h_range, exposure, sun_dir), lut[:, :3].contiguous()
    image = torch.empty((n_frames, height, width), dtype=torch.int32, device=records.device)
    _build.launch(seg_shade_shipped, load().vf_seg_shade_shipped, records,
                  *_seg_args(records, ids, bbox, binning, n_frames, width, height),
                  lut_rgb.data_ptr(), par.data_ptr(), image.data_ptr(),
                  None if evaluated is None else evaluated.data_ptr())
    return image.view(torch.uint32)


seg_shade_shipped.launches = 0


# ---------------- the segment walk's set-up (csrc/segments.cu) ----------------

def _check_seg_setup(fields: torch.Tensor, indices, grid_n, width: int, height: int,
                     row_size: int) -> int:
    """Check ``seg_setup``'s inputs as the vtx and indexed kernels' are
    checked; returns the triangle count."""
    if (indices is None) == (grid_n is None):
        raise ValueError("give exactly one of indices and grid_n")
    if indices is None:
        _check_fields(fields, int(grid_n))
        n_tris = vtx.n_triangles(int(grid_n))
    else:
        _check_indexed(fields, indices)
        n_tris = indices.shape[0]
    if fields.shape[0] != 1:
        raise ValueError(f"fields must hold one frame, got {fields.shape[0]}")
    _check_frame(width, height)
    if int(row_size) < 1:
        raise ValueError(f"row_size must be >= 1, got {row_size}")
    return n_tris


def seg_setup(fields: torch.Tensor, indices, grid_n, width: int, height: int,
              row_size: int):
    """One frame's segment-walk inputs from its post-VS fields (1, 7, N):
    the triangles' corners through ``indices`` ((T, 3) int32, every index
    in [0, N)) or, with ``grid_n`` instead, on ``build_grid_xyuv(grid_n)``'s
    grid; mesh rows of ``row_size`` triangles. Returns (records (M,
    REC_WIDTH) f32, ids (M,) int32, bbox (M, 4) int32, SegmentBinning,
    columns), M the valid triangles, in the walk ``walk_order`` picks
    (``columns``: the column-major one).

    CPU tensors: segments.setup_frame_plain. CUDA tensors: the
    ``vf_seg_setup_*`` chain of csrc/segments.cu, up to 14 launches and one
    read of the valid count and the axes' estimates; the same bytes.
    """
    n_tris = _check_seg_setup(fields, indices, grid_n, width, height, row_size)
    row_size = int(row_size)
    if fields.device.type == "cpu":
        return segments.setup_frame_plain(fields, indices, grid_n, width, height, row_size)
    dev = fields.device
    nv = fields.shape[2]
    n = 0 if grid_n is None else int(grid_n)
    idx = None if indices is None else indices.data_ptr()
    ntx, nty = segments.seg_grid(width, height)
    i32 = dict(dtype=torch.int32, device=dev)
    lib = load()
    walks = segments.walk_streams(n_tris, row_size)
    info = torch.zeros(4, dtype=torch.int64, device=dev)   # valid counts, estimates
    bbox = torch.empty((n_tris, 4), **i32)
    if n_tris:
        _build.launch(seg_setup, lib.vf_seg_setup_bbox, fields, fields.data_ptr(), nv, idx, n,
                      n_tris, width, height, bbox.data_ptr())
    tables = []
    for a, walk in enumerate(walks):
        length, rs = walk.length, walk.row_size
        rows = -(-length // rs)
        # seg_lo, seg_hi, row_base, r_bounds, counts_est, seg_y, tile_order
        t = segments.SegmentBinning(*(torch.empty(shape, **i32) for shape in (
            (ntx, rows), (ntx, rows), rows, (2, nty), nty * ntx, (ntx, rows, 2), nty * ntx)))
        row_ty = torch.empty((rows, 2), **i32)
        diffs = torch.empty((2, ntx, nty + 1), **i32)
        n_blocks = -(-length // SEG_SCAN_BLOCK)
        offset = torch.empty(n_blocks + 1, **i32)
        _build.launch(seg_setup, lib.vf_seg_setup_init, fields, ntx, rows, nty,
                      t.seg_lo.data_ptr(), t.seg_hi.data_ptr(), t.seg_y.data_ptr(),
                      row_ty.data_ptr(), t.r_bounds.data_ptr(), diffs.data_ptr())
        if length:
            stream_args = (length, rs, walk.cells_rows, walk.cells_cols, int(walk.columns))
            counts = torch.empty(n_blocks, **i32)
            _build.launch(seg_setup, lib.vf_seg_setup_count, fields, bbox.data_ptr(),
                          *stream_args, counts.data_ptr())
            _build.launch(seg_setup, lib.vf_seg_setup_scan, fields, counts.data_ptr(), n_blocks,
                          offset.data_ptr(), info[a:].data_ptr())
            _build.launch(seg_setup, lib.vf_seg_setup_bin, fields, bbox.data_ptr(), *stream_args,
                          ntx, rows, offset.data_ptr(), t.seg_lo.data_ptr(),
                          t.seg_hi.data_ptr(), t.seg_y.data_ptr(), row_ty.data_ptr(),
                          t.row_base.data_ptr())
            _build.launch(seg_setup, lib.vf_seg_setup_tables, fields, ntx, rows, nty,
                          t.row_base.data_ptr(), row_ty.data_ptr(), t.seg_lo.data_ptr(),
                          t.seg_hi.data_ptr(), t.seg_y.data_ptr(), diffs.data_ptr(),
                          t.r_bounds.data_ptr())
        # The per-tile counts that order the tiles go where tile_order
        # will be; counts_est and the estimate beside them.
        _build.launch(seg_setup, lib.vf_seg_setup_prefix, fields, ntx, nty, diffs.data_ptr(),
                      t.counts_est.data_ptr(), t.tile_order.data_ptr(),
                      info[2 + a:].data_ptr())
        tables.append((t, offset))
    del diffs, row_ty
    # The one read: valid counts and estimates, both axes.
    got = _trace.d2h(info).cpu().tolist()
    a = segments.cheaper_walk(got[2:2 + len(walks)])
    valid, walk = got[a], walks[a]
    t, offset = tables[a]
    records = torch.empty((valid, REC_WIDTH), dtype=torch.float32, device=dev)
    ids = torch.empty(valid, **i32)
    cbbox = torch.empty((valid, 4), **i32)
    if valid:
        _build.launch(seg_setup, lib.vf_seg_setup_compact, fields, fields.data_ptr(), nv, idx, n,
                      bbox.data_ptr(), walk.length, walk.row_size, walk.cells_rows,
                      walk.cells_cols, int(walk.columns), width, height, offset.data_ptr(),
                      records.data_ptr(), ids.data_ptr(), cbbox.data_ptr())
    order = torch.argsort(t.tile_order, descending=True, stable=True).to(torch.int32)
    return records, ids, cbbox, t._replace(tile_order=order), walk.columns


seg_setup.launches = 0


# ---------------- the record route's set-up (csrc/records.cu) ----------------

def _check_rec_setup(fields: torch.Tensor, indices: torch.Tensor, width: int, height: int,
                     fill_rule: str) -> None:
    if fields.dtype != torch.float32 or fields.dim() != 3 \
            or fields.shape[1] != vtx.FIELDS or not fields.is_contiguous():
        raise ValueError(f"fields must be contiguous float32 (B, {vtx.FIELDS}, N), "
                         f"got {fields.dtype} {tuple(fields.shape)}")
    if indices.dtype not in (torch.int32, torch.int64) or indices.dim() != 2 \
            or indices.shape[1] != 3 or not indices.is_contiguous():
        raise ValueError(f"indices must be contiguous int32 or int64 (T, 3), got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    if indices.device != fields.device:
        raise ValueError(f"indices is on {indices.device}, fields on {fields.device}")
    setup.check_fill_rule(fill_rule)
    _check_frame(width, height)
    ntx, nty = tile_grid(width, height)
    B, _, nv = fields.shape
    if B * indices.shape[0] >= 2**31 or nv >= 2**31 or B * ntx * nty >= 2**31:
        raise ValueError("frames * triangles, vertices and frames * tiles must stay below "
                         "2**31 (int32 rows and keys)")
    if fields.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {fields.device}")


def _index_error(nv: int, lo=None, hi=None) -> ValueError:
    got = "" if lo is None else f", got [{lo}, {hi}]"
    return ValueError(f"indices must lie in [0, {nv}){got}")


def rec_setup(fields: torch.Tensor, indices: torch.Tensor, width: int, height: int,
              fill_rule: str = "inclusive"):
    """The record route's inputs from B frames' post-VS fields (B, 7, N):
    the triangles of ``indices`` ((T, 3) int32 or int64, every index in
    [0, N)) set up under ``fill_rule`` and binned into tiles. Returns
    (records (R, REC_WIDTH) f32, Binning): the R binned triangles' records
    in ascending (frame, id) order, and the tiles' lists of rows into them.

    CPU tensors: setup.rec_setup_plain. CUDA tensors: the chain of
    csrc/records.cu, 3 launches, one read of the totals and the index
    check, then, where a triangle is binned, 1 + 3 a sort pass (one pass
    per REC_DIGIT_BITS bits of the largest tile key); the same bytes. No
    triangle or no frame: no record, empty lists, nothing launched. An
    index outside [0, N) raises ValueError.
    """
    _check_rec_setup(fields, indices, width, height, fill_rule)
    B, _, nv = fields.shape
    T = indices.shape[0]
    ntx, nty = tile_grid(width, height)
    n_keys = B * ntx * nty
    dev = fields.device
    i32 = dict(dtype=torch.int32, device=dev)
    if B * T == 0:
        return (torch.empty((0, REC_WIDTH), dtype=torch.float32, device=dev),
                Binning(rows=torch.empty(0, **i32), offsets=torch.zeros(n_keys + 1, **i32),
                        boxes=torch.empty(0, **i32)))
    if dev.type == "cpu":
        lo, hi = (int(v) for v in torch.aminmax(indices))
        if lo < 0 or hi >= nv:
            raise _index_error(nv, lo, hi)
        return setup.rec_setup_plain(fields, indices, width, height, fill_rule)
    lib = load()
    frame_args = (fields.data_ptr(), nv, indices.data_ptr(), int(indices.dtype == torch.int64),
                  T, B, width, height, int(fill_rule == "hw"))
    blocks = B * -(-T // REC_BLOCK)
    bits = torch.empty(blocks * REC_BLOCK // 32, **i32)
    block_binned, block_bad, rec_first = (torch.empty(blocks, **i32) for _ in range(3))
    block_pairs, pair_first = (torch.empty(blocks, dtype=torch.int64, device=dev)
                               for _ in range(2))
    info = torch.empty(3, dtype=torch.int64, device=dev)    # records, pairs, bad index
    _build.launch(rec_setup, lib.vf_rec_setup_count, fields, *frame_args, bits.data_ptr(),
                  block_binned.data_ptr(), block_pairs.data_ptr(), block_bad.data_ptr())
    _build.launch(rec_setup, lib.vf_rec_setup_totals, fields, block_binned.data_ptr(),
                  block_pairs.data_ptr(), block_bad.data_ptr(), blocks, rec_first.data_ptr(),
                  pair_first.data_ptr(), info.data_ptr())
    n_rec, n_pairs, bad = _trace.d2h(info).cpu().tolist()     # the one read
    if bad:
        raise _index_error(nv)
    if n_pairs >= 2**31:
        raise ValueError(f"{n_pairs} (tile, record) pairs: the lists' int32 offsets "
                         "hold fewer than 2**31")
    records = torch.empty((n_rec, REC_WIDTH), dtype=torch.float32, device=dev)
    keys, rows, boxes = (torch.empty(n_pairs, **i32) for _ in range(3))
    if n_rec:
        _build.launch(rec_setup, lib.vf_rec_setup_emit, fields, *frame_args, bits.data_ptr(),
                      rec_first.data_ptr(), pair_first.data_ptr(), records.data_ptr(),
                      keys.data_ptr(), rows.data_ptr(), boxes.data_ptr())
        passes = rec_sort_passes(n_keys)
        hist, offs = (torch.empty((1 << REC_DIGIT_BITS) * -(-n_pairs // REC_SORT_BLOCK), **i32)
                      for _ in range(2))
        digit_total = torch.empty(1 << REC_DIGIT_BITS, **i32)
        spare = [torch.empty(n_pairs, **i32) for _ in range(3)]
        for shift in range(0, passes * REC_DIGIT_BITS, REC_DIGIT_BITS):
            _build.launch(rec_setup, lib.vf_rec_sort_count, fields, keys.data_ptr(), n_pairs,
                          shift, hist.data_ptr())
            _build.launch(rec_setup, lib.vf_rec_sort_scan, fields, hist.data_ptr(), n_pairs,
                          offs.data_ptr(), digit_total.data_ptr())
            _build.launch(rec_setup, lib.vf_rec_sort_scatter, fields, keys.data_ptr(),
                          rows.data_ptr(), boxes.data_ptr(), n_pairs, shift, offs.data_ptr(),
                          digit_total.data_ptr(), *(t.data_ptr() for t in spare))
            spare, (keys, rows, boxes) = [keys, rows, boxes], spare
    offsets = torch.empty(n_keys + 1, **i32)
    _build.launch(rec_setup, lib.vf_rec_setup_offsets, fields, keys.data_ptr(), n_pairs, n_keys,
                  offsets.data_ptr())
    return records, Binning(rows=rows, offsets=offsets, boxes=boxes)


rec_setup.launches = 0


def rec_sort_passes(n_keys: int) -> int:
    """The radix passes that order tile keys 0..n_keys-1: one per
    REC_DIGIT_BITS bits of the largest (none for a single tile)."""
    return -(-(n_keys - 1).bit_length() // REC_DIGIT_BITS)


def rec_setup_launches(n_frames: int, width: int, height: int, binned: bool) -> int:
    """The launches ``rec_setup`` makes on the card for ``n_frames`` frames
    of width x height with at least one triangle, some binned or none."""
    ntx, nty = tile_grid(width, height)
    return 3 + (1 + 3 * rec_sort_passes(n_frames * ntx * nty) if binned else 0)


# ---------------- the extended fragment shader (csrc/fragment.cu) ----------------

def _check_fs_extended(h, u, v, mask, lut, heights, h_min, h_max, exposure, sun_dir,
                       spacing, exaggeration) -> None:
    scalars = (("h_min", h_min), ("h_max", h_max), ("exposure", exposure),
               ("exaggeration", exaggeration))
    if isinstance(spacing, torch.Tensor):
        scalars += (("spacing", spacing),)
    tensors = (("h", h), ("u", u), ("v", v), ("lut", lut), ("heights", heights),
               ("sun_dir", sun_dir)) + scalars
    for name, t in tensors:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 tensor, got "
                             f"{getattr(t, 'dtype', type(t).__name__)}")
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a bool tensor, got "
                         f"{getattr(mask, 'dtype', type(mask).__name__)}")
    for name, t in tensors + (("mask", mask),):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    if not h.shape == u.shape == v.shape == mask.shape:
        raise ValueError(f"h, u, v and mask must share one shape, got {tuple(h.shape)}, "
                         f"{tuple(u.shape)}, {tuple(v.shape)} and {tuple(mask.shape)}")
    if lut.shape != (256, 4):
        raise ValueError(f"lut must be float32 (256, 4), got {tuple(lut.shape)}")
    if heights.dim() != 2 or heights.numel() == 0:
        raise ValueError(f"heights must be a non-empty (Ht, Wt), got {tuple(heights.shape)}")
    if sun_dir.numel() != 3:
        raise ValueError(f"sun_dir must hold 3 values, got {sun_dir.numel()}")
    if any(t.numel() != 1 for _, t in scalars):
        raise ValueError("h_min, h_max, exposure, spacing and exaggeration must hold one "
                         "value each")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")


def terrain_fs_extended(h, u, v, mask, lut, heights, h_min, h_max, exposure, sun_dir,
                        spacing, exaggeration) -> torch.Tensor:
    """The extended fragment shader over a g-buffer: (..., H, W) uint32
    RGBA words (arguments as ``fragment.terrain_fs_extended``; ``spacing``
    a float32 tensor of one value or a number).

    CPU tensors: fragment.terrain_fs_extended_plain. CUDA tensors:
    ``vf_terrain_fs_extended``, one launch, which reads the scalars on the
    device and takes a numeric spacing by value. No pixel: the empty words,
    on either device, with nothing launched or counted.
    """
    _check_fs_extended(h, u, v, mask, lut, heights, h_min, h_max, exposure, sun_dir,
                       spacing, exaggeration)
    numeric = not isinstance(spacing, torch.Tensor)
    if h.device.type == "cpu":
        sp = torch.tensor(float(spacing), dtype=torch.float32) if numeric else spacing
        return fragment.terrain_fs_extended_plain(h, u, v, mask, lut, heights, h_min, h_max,
                                                  exposure, sun_dir, sp, exaggeration)
    out = torch.empty(h.shape, dtype=torch.int32, device=h.device)
    if h.numel() == 0:
        return out.view(torch.uint32)
    for name, t in (("h", h), ("u", u), ("v", v), ("mask", mask), ("lut", lut),
                    ("heights", heights), ("sun_dir", sun_dir)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # Four pixels a thread load and store as vectors where the planes allow.
    vec = all(t.data_ptr() % 16 == 0 for t in (h, u, v, out)) and mask.data_ptr() % 4 == 0
    _build.launch(terrain_fs_extended, load().vf_terrain_fs_extended, h, h.data_ptr(),
                  u.data_ptr(), v.data_ptr(), mask.data_ptr(), h.numel(), lut.data_ptr(),
                  heights.data_ptr(), heights.shape[0], heights.shape[1], h_min.data_ptr(),
                  h_max.data_ptr(), exposure.data_ptr(), sun_dir.data_ptr(),
                  None if numeric else spacing.data_ptr(), float(spacing) if numeric else 0.0,
                  exaggeration.data_ptr(), int(vec), out.data_ptr())
    return out.view(torch.uint32)


terrain_fs_extended.launches = 0
