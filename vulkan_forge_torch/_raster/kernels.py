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
    shipped fragment shader fused.

The sources (and the header they share, ``csrc/raster_common.cuh``) are
compiled on first use with ``nvcc``, one process per source started
together, and linked into one shared library with a plain C interface,
keyed by a hash of the sources and flags, under ``build/vulkan_forge_torch/``
at the root of the checkout, and loaded with ctypes. Kernels launch on
torch's current stream and never synchronise.

Each wrapper takes a CPU tensor to its plain PyTorch version (tiles.py,
fragment.py, vtx.py, packed.py, segments.py) and launches the kernel for a
CUDA tensor, or raises; it counts its kernel launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _trace
from .._build import BUILD_DIR
from . import fragment, packed, segments, tiles, vtx
from .setup import REC_WIDTH, TILE, Binning, tile_grid

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC = _PKG_DIR / "csrc"
_SOURCES = (_CSRC / "raster.cu", _CSRC / "vtx.cu", _CSRC / "packed.cu",
            _CSRC / "segments.cu")
_HEADERS = (_CSRC / "raster_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
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
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                           "use and need the CUDA toolkit")
    return path


def source_hash() -> str:
    h = hashlib.sha256()
    for src in _SOURCES + _HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libvf_raster_{source_hash()}.so"


def _run(procs, what: str) -> str:
    """Wait for every process; raise with their output if one failed."""
    logs, failed = [], []
    for p in procs:
        out, err = p.communicate()
        logs.append(out + err)
        if p.returncode != 0:
            failed.append(f"{what} failed ({p.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built.

    Each source compiles in its own ``nvcc`` process, all started
    together; the objects are then linked. The compiler's ``-Xptxas -v``
    report (registers, shared memory, spills) is kept beside the library as
    ``<library>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _SOURCES]
        log = _run([subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
                    for src, obj in zip(_SOURCES, objs)], "nvcc")
        lib = os.path.join(tmp, out.name)
        _run([subprocess.Popen([nvcc, "-shared", "-o", lib, *objs],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)], "nvcc link")
        Path(str(out) + ".log").write_text(log)
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def load():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib
    if _lib is None:
        with _trace.setup("vf.setup.load"):
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            if lib.vf_tile() != TILE:
                raise RuntimeError(f"csrc/raster.cu rasterizes {lib.vf_tile()}-pixel "
                                   f"tiles but setup.TILE is {TILE}")
            for src, fn in (("vtx.cu", lib.vf_vtx_big_pixels),
                            ("packed.cu", lib.vf_packed_big_pixels)):
                if fn() != vtx.BIG_PIXELS:
                    raise RuntimeError(f"csrc/{src} lists triangles above {fn()} "
                                       f"pixels but vtx.BIG_PIXELS is {vtx.BIG_PIXELS}")
            if lib.vf_big_tile() != vtx.BIG_TILE:
                raise RuntimeError(f"csrc/raster_common.cuh walks {lib.vf_big_tile()}-pixel "
                                   f"big tiles but vtx.BIG_TILE is {vtx.BIG_TILE}")
            resolve = (lib.vf_resolve_tile_w(), lib.vf_resolve_warp_w())
            if resolve != (vtx.RESOLVE_TILE_W, vtx.RESOLVE_WARP_W):
                raise RuntimeError(f"csrc/raster_common.cuh resolves {resolve[0]}-pixel-wide "
                                   f"tiles in {resolve[1]}-pixel-wide warp patches but vtx.py "
                                   f"mirrors {vtx.RESOLVE_TILE_W} and {vtx.RESOLVE_WARP_W}")
            if (lib.vf_seg_tile_h(), lib.vf_seg_tile_w()) != (segments.TILE_H,
                                                              segments.TILE_W):
                raise RuntimeError(f"csrc/segments.cu walks {lib.vf_seg_tile_h()}x"
                                   f"{lib.vf_seg_tile_w()} tiles but segments.py bins "
                                   f"{segments.TILE_H}x{segments.TILE_W}")
            _lib = lib
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


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


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
    lib = load()
    with torch.cuda.device(records.device):
        err = getattr(lib, symbol)(
            *_launch_args(records, binning, n_frames, width, height),
            v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), mask.data_ptr(),
            None if evaluated is None else evaluated.data_ptr(), _stream(records.device))
    _raise_on(err, symbol)
    wrapper.launches += 1
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
    lut_rgb, par = _shading_params(lut, h_range, exposure, sun_dir)
    image = torch.empty((n_frames, height, width), dtype=torch.int32,
                        device=records.device)
    lib = load()
    with torch.cuda.device(records.device):
        err = getattr(lib, symbol)(
            *_launch_args(records, binning, n_frames, width, height),
            lut_rgb.data_ptr(), par.data_ptr(), image.data_ptr(),
            None if evaluated is None else evaluated.data_ptr(), _stream(records.device))
    _raise_on(err, symbol)
    wrapper.launches += 1
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
    lib = load()
    with torch.cuda.device(xyuv.device):
        err = lib.vf_vs_fields(xyuv.data_ptr(), N, heights.data_ptr(), heights.shape[0],
                               heights.shape[1], views.data_ptr(), projs.data_ptr(), B,
                               spacing.data_ptr(), exaggeration.data_ptr(), width, height,
                               int(fs_mode == "shipped"), fields.data_ptr(),
                               _stream(xyuv.device))
    _raise_on(err, "vf_vs_fields")
    vs_fields.launches += 1
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
    with torch.cuda.device(fields.device):
        err = lib.vf_vtx_cover(fields.data_ptr(), B, grid_n, width, height,
                               winner.data_ptr(), big.data_ptr(), count.data_ptr(),
                               None if per is None else per.data_ptr(),
                               _stream(fields.device))
    _raise_on(err, "vf_vtx_cover")
    vtx_cover.launches += 1
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
    lib = load()
    with torch.cuda.device(fields.device):
        err = lib.vf_vtx_cover_big(fields.data_ptr(), grid_n, width, height,
                                   big.data_ptr(), count.data_ptr(), winner.data_ptr(),
                                   None if walked is None else walked.data_ptr(),
                                   _stream(fields.device))
    _raise_on(err, "vf_vtx_cover_big")
    vtx_cover_big.launches += 1
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
    lib = load()
    with torch.cuda.device(fields.device):
        err = lib.vf_vtx_resolve_gbuffer(
            fields.data_ptr(), B, grid_n, width, height, winner.data_ptr(),
            v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), mask.data_ptr(),
            _stream(fields.device))
    _raise_on(err, "vf_vtx_resolve_gbuffer")
    vtx_resolve_gbuffer.launches += 1
    return v0, v1, v2, mask


vtx_resolve_gbuffer.launches = 0


def _check_shading(lut, h_range, exposure, sun_dir, device) -> None:
    if lut.shape != (256, 4) or lut.dtype != torch.float32:
        raise ValueError(f"lut must be float32 (256, 4), got {lut.dtype} {tuple(lut.shape)}")
    for name, t in (("lut", lut), ("h_range", h_range), ("exposure", exposure),
                    ("sun_dir", sun_dir)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the frame on {device}")


def _shading_params(lut, h_range, exposure, sun_dir):
    """(lut_rgb (256, 3), par [hr2, exposure, l0, l1, l2]) for the fused
    kernels, with ``fragment.fs_scalars``'s ops."""
    hr2, expo, l = fragment.fs_scalars(h_range, exposure, sun_dir)
    par = torch.stack([hr2, expo, l[0], l[1], l[2]]).to(torch.float32).contiguous()
    return lut[:, :3].contiguous(), par


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
    lut_rgb, par = _shading_params(lut, h_range, exposure, sun_dir)
    image = torch.empty_like(winner)
    lib = load()
    with torch.cuda.device(fields.device):
        err = lib.vf_vtx_resolve_shade_shipped(
            fields.data_ptr(), B, grid_n, width, height, winner.data_ptr(),
            lut_rgb.data_ptr(), par.data_ptr(), image.data_ptr(), _stream(fields.device))
    _raise_on(err, "vf_vtx_resolve_shade_shipped")
    vtx_resolve_shade_shipped.launches += 1
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
    with torch.cuda.device(fields.device):
        err = lib.vf_packed_cover(fields.data_ptr(), B, nv, indices.data_ptr(), T,
                                  width, height, winner.data_ptr(), big.data_ptr(),
                                  count.data_ptr(), None if per is None else per.data_ptr(),
                                  _stream(fields.device))
    _raise_on(err, "vf_packed_cover")
    packed_cover.launches += 1
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
    lib = load()
    with torch.cuda.device(fields.device):
        err = lib.vf_packed_cover_big(fields.data_ptr(), fields.shape[2], indices.data_ptr(),
                                      indices.shape[0], width, height, big.data_ptr(),
                                      count.data_ptr(), winner.data_ptr(),
                                      None if walked is None else walked.data_ptr(),
                                      _stream(fields.device))
    _raise_on(err, "vf_packed_cover_big")
    packed_cover_big.launches += 1
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
    lib = load()
    with torch.cuda.device(fields.device):
        err = lib.vf_packed_resolve_gbuffer(
            fields.data_ptr(), B, fields.shape[2], indices.data_ptr(), width, height,
            winner.data_ptr(), v0.data_ptr(), v1.data_ptr(), v2.data_ptr(),
            mask.data_ptr(), _stream(fields.device))
    _raise_on(err, "vf_packed_resolve_gbuffer")
    packed_resolve_gbuffer.launches += 1
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
    lib = load()
    with torch.cuda.device(records.device):
        err = lib.vf_seg_gbuffer(
            *_seg_args(records, ids, bbox, binning, n_frames, width, height),
            v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), mask.data_ptr(),
            None if evaluated is None else evaluated.data_ptr(), _stream(records.device))
    _raise_on(err, "vf_seg_gbuffer")
    seg_gbuffer.launches += 1
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
    lut_rgb, par = _shading_params(lut, h_range, exposure, sun_dir)
    image = torch.empty((n_frames, height, width), dtype=torch.int32, device=records.device)
    lib = load()
    with torch.cuda.device(records.device):
        err = lib.vf_seg_shade_shipped(
            *_seg_args(records, ids, bbox, binning, n_frames, width, height),
            lut_rgb.data_ptr(), par.data_ptr(), image.data_ptr(),
            None if evaluated is None else evaluated.data_ptr(), _stream(records.device))
    _raise_on(err, "vf_seg_shade_shipped")
    seg_shade_shipped.launches += 1
    return image.view(torch.uint32)


seg_shade_shipped.launches = 0
