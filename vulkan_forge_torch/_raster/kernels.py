"""Build, binding and wrappers of the hand-written CUDA raster kernels.

``csrc/raster.cu`` holds two kernels over one raster body of triangle
records (see the note at the top of that file for what each replaces and
what bounds it):

  - ``raster_gbuffer`` -> ``vf_raster_gbuffer``: replaces
    ``pallas_backend._kernel`` (K1, pallas_backend.py:33) and the inclusive
    rule of ``strips._strip_kernel`` (K7, strips.py:155).
  - ``raster_shade_shipped`` -> ``vf_raster_shade_shipped``: replaces
    ``packed._packed_kernel_resident_fused`` (K4, packed.py:755) with the
    shipped fragment shader ``fragment.terrain_fs_tile`` (K2,
    fragment.py:81) in its epilogue.

``csrc/vtx.cu`` holds the vertex-stream route's four kernels, one wrapper
each, which together replace ``vtx._vtx_kernel`` (K3a, vtx.py:590) and
``vtx._vtx_kernel_fused`` (K3b, vtx.py:616):

  - ``vtx_cover`` -> ``vf_vtx_cover`` and ``vtx_cover_big`` ->
    ``vf_vtx_cover_big``: the per-pixel winning triangle id;
  - ``vtx_resolve_gbuffer`` -> ``vf_vtx_resolve_gbuffer`` (K3a's output)
    and ``vtx_resolve_shade_shipped`` -> ``vf_vtx_resolve_shade_shipped``
    (K3b's).

``vtx.render_gbuffer_vtx_batch`` and ``vtx.render_image_vtx_batch`` chain
them.

Both sources (and the header they share, ``csrc/raster_common.cuh``) are
compiled on first use with ``nvcc``, one process per source started
together, and linked into one shared library with a plain C interface,
keyed by a hash of the sources and flags, under ``build/vulkan_forge_torch/``
at the root of the checkout, and loaded with ctypes. Kernels launch on
torch's current stream and never synchronise.

Each wrapper takes a CPU tensor to its plain PyTorch version (tiles.py,
fragment.py, vtx.py) and launches the kernel for a CUDA tensor, or raises;
it counts its kernel launches in ``<wrapper>.launches``.
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

from . import fragment, tiles, vtx
from .setup import REC_WIDTH, TILE, Binning, tile_grid

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC = _PKG_DIR / "csrc"
_SOURCES = (_CSRC / "raster.cu", _CSRC / "vtx.cu")
_HEADERS = (_CSRC / "raster_common.cuh",)
BUILD_DIR = _PKG_DIR.parent / "build" / "vulkan_forge_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vf_raster_gbuffer": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vf_raster_shade_shipped": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "vf_tile": [],
    "vf_vtx_cover": [_P, _I, _I, _I, _I, _P, _P, _P, _P],
    "vf_vtx_cover_big": [_P, _I, _I, _I, _P, _P, _P, _P],
    "vf_vtx_resolve_gbuffer": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "vf_vtx_resolve_shade_shipped": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vf_vtx_big_pixels": [],
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
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        if lib.vf_tile() != TILE:
            raise RuntimeError(f"csrc/raster.cu rasterizes {lib.vf_tile()}-pixel "
                               f"tiles but setup.TILE is {TILE}")
        if lib.vf_vtx_big_pixels() != vtx.BIG_PIXELS:
            raise RuntimeError(f"csrc/vtx.cu lists triangles above "
                               f"{lib.vf_vtx_big_pixels()} pixels but "
                               f"vtx.BIG_PIXELS is {vtx.BIG_PIXELS}")
        _lib = lib
    return _lib


def _check_inputs(records: torch.Tensor, binning: Binning, n_frames: int,
                  width: int, height: int) -> None:
    if records.dtype != torch.float32 or records.dim() != 2 \
            or records.shape[1] != REC_WIDTH or not records.is_contiguous():
        raise ValueError(f"records must be contiguous float32 (R, {REC_WIDTH}), "
                         f"got {records.dtype} {tuple(records.shape)}")
    ntx, nty = tile_grid(width, height)
    for name, t in (("rows", binning.rows), ("offsets", binning.offsets)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"binning.{name} must be contiguous 1-D int32")
        if t.device != records.device:
            raise ValueError(f"binning.{name} is on {t.device}, records on {records.device}")
    if binning.offsets.numel() != n_frames * ntx * nty + 1:
        raise ValueError("binning.offsets does not match the frame and tile counts")
    if records.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {records.device}")


def _launch_args(records, binning, n_frames, width, height):
    ntx, nty = tile_grid(width, height)
    return [records.data_ptr(), REC_WIDTH, binning.rows.data_ptr(),
            binning.offsets.data_ptr(), n_frames * ntx * nty, ntx, nty,
            width, height]


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def raster_gbuffer(records: torch.Tensor, binning: Binning, n_frames: int,
                   width: int, height: int):
    """Binned records -> g-buffer (v0, v1, v2, mask), each (B, H, W).

    CPU tensors: tiles.render_gbuffer. CUDA tensors: ``vf_raster_gbuffer``.
    """
    _check_inputs(records, binning, n_frames, width, height)
    if records.device.type == "cpu":
        return tiles.render_gbuffer(records, binning, n_frames, width, height)
    shape = (n_frames, height, width)
    opts = dict(dtype=torch.float32, device=records.device)
    v0, v1, v2 = (torch.empty(shape, **opts) for _ in range(3))
    mask = torch.empty(shape, dtype=torch.bool, device=records.device)
    lib = load()
    with torch.cuda.device(records.device):
        err = lib.vf_raster_gbuffer(
            *_launch_args(records, binning, n_frames, width, height),
            v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), mask.data_ptr(),
            _stream(records.device))
    _raise_on(err, "vf_raster_gbuffer")
    raster_gbuffer.launches += 1
    return v0, v1, v2, mask


raster_gbuffer.launches = 0


def raster_shade_shipped(records: torch.Tensor, binning: Binning,
                         n_frames: int, width: int, height: int,
                         lut: torch.Tensor, h_range: torch.Tensor,
                         exposure: torch.Tensor, sun_dir: torch.Tensor):
    """Binned records -> (B, H, W) uint32 RGBA through the shipped shader.

    CPU tensors: tiles.render_gbuffer then fragment.terrain_fs. CUDA
    tensors: ``vf_raster_shade_shipped``, with hr2, exposure and the
    normalized sun computed here by ``fragment.fs_scalars``.
    """
    _check_inputs(records, binning, n_frames, width, height)
    _check_shading(lut, h_range, exposure, sun_dir, records.device)
    if records.device.type == "cpu":
        v0, v1, v2, mask = tiles.render_gbuffer(records, binning, n_frames,
                                                width, height)
        return fragment.terrain_fs(v0, v1, v2, mask, lut, h_range, exposure,
                                   sun_dir)
    lut_rgb, par = _shading_params(lut, h_range, exposure, sun_dir)
    image = torch.empty((n_frames, height, width), dtype=torch.int32,
                        device=records.device)
    lib = load()
    with torch.cuda.device(records.device):
        err = lib.vf_raster_shade_shipped(
            *_launch_args(records, binning, n_frames, width, height),
            lut_rgb.data_ptr(), par.data_ptr(), image.data_ptr(), _stream(records.device))
    _raise_on(err, "vf_raster_shade_shipped")
    raster_shade_shipped.launches += 1
    return image.view(torch.uint32)


raster_shade_shipped.launches = 0


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


def vtx_cover(fields: torch.Tensor, grid_n: int, width: int, height: int):
    """Cover pass: (winner (B, H, W) int32 = max id+1 of the triangles of at
    most ``vtx.BIG_PIXELS`` bbox pixels, big (B*T,) int32 list of the
    others as frame*T + id, count (1,) int32).

    CPU tensors: vtx.cover_plain. CUDA tensors: ``vf_vtx_cover``.
    """
    _check_fields(fields, grid_n)
    if fields.device.type == "cpu":
        return vtx.cover_plain(fields, grid_n, width, height)
    B = fields.shape[0]
    winner = torch.zeros((B, height, width), dtype=torch.int32, device=fields.device)
    big = torch.empty(B * vtx.n_triangles(grid_n), dtype=torch.int32, device=fields.device)
    count = torch.zeros(1, dtype=torch.int32, device=fields.device)
    lib = load()
    with torch.cuda.device(fields.device):
        err = lib.vf_vtx_cover(fields.data_ptr(), B, grid_n, width, height,
                               winner.data_ptr(), big.data_ptr(), count.data_ptr(),
                               _stream(fields.device))
    _raise_on(err, "vf_vtx_cover")
    vtx_cover.launches += 1
    return winner, big, count


vtx_cover.launches = 0


def vtx_cover_big(fields: torch.Tensor, grid_n: int, winner: torch.Tensor,
                  big: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Big-triangle pass: deposits the listed triangles into ``winner`` in
    place and returns it.

    CPU tensors: vtx.cover_big_plain. CUDA tensors: ``vf_vtx_cover_big``.
    """
    _check_fields(fields, grid_n)
    _check_winner(winner, fields)
    for name, t in (("big", big), ("count", count)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous 1-D int32")
        if t.device != fields.device:
            raise ValueError(f"{name} is on {t.device}, fields on {fields.device}")
    if big.numel() != fields.shape[0] * vtx.n_triangles(grid_n) or count.numel() != 1:
        raise ValueError("big must hold frames * triangles entries and count one")
    if fields.device.type == "cpu":
        return vtx.cover_big_plain(fields, grid_n, winner, big, count)
    _, height, width = winner.shape
    lib = load()
    with torch.cuda.device(fields.device):
        err = lib.vf_vtx_cover_big(fields.data_ptr(), grid_n, width, height,
                                   big.data_ptr(), count.data_ptr(), winner.data_ptr(),
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

