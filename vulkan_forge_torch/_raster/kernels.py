"""Build, binding and wrappers of the hand-written CUDA raster kernels.

``csrc/raster.cu`` holds two kernels over one raster body (see the note at
the top of that file for what each replaces and what bounds it):

  - ``raster_gbuffer`` -> ``vf_raster_gbuffer``: replaces
    ``pallas_backend._kernel`` (K1, pallas_backend.py:33) and the inclusive
    rule of ``strips._strip_kernel`` (K7, strips.py:155).
  - ``raster_shade_shipped`` -> ``vf_raster_shade_shipped``: replaces
    ``packed._packed_kernel_resident_fused`` (K4, packed.py:755) with the
    shipped fragment shader ``fragment.terrain_fs_tile`` (K2,
    fragment.py:81) in its epilogue.

The source is compiled on first use with ``nvcc`` into a shared library
with a plain C interface, keyed by a hash of the source, under
``build/vulkan_forge_torch/`` at the root of the checkout, and loaded with
ctypes. Kernels launch on torch's current stream and never synchronise.

Each wrapper takes a CPU tensor to its plain PyTorch version (tiles.py,
fragment.py) and launches the kernel for a CUDA tensor, or raises; it
counts its kernel launches in ``<wrapper>.launches``.
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

from . import fragment, tiles
from .setup import REC_WIDTH, TILE, Binning, tile_grid

_PKG_DIR = Path(__file__).resolve().parents[1]
_SOURCES = (_PKG_DIR / "csrc" / "raster.cu",)
BUILD_DIR = _PKG_DIR.parent / "build" / "vulkan_forge_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vf_raster_gbuffer": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vf_raster_shade_shipped": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "vf_tile": [],
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
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libvf_raster_{source_hash()}.so"


def build() -> Path:
    """Compile csrc/ into the shared library unless it is already built.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside the library as ``<library>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
        stream = torch.cuda.current_stream(records.device).cuda_stream
        err = lib.vf_raster_gbuffer(
            *_launch_args(records, binning, n_frames, width, height),
            v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), mask.data_ptr(), stream)
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
    if lut.shape != (256, 4) or lut.dtype != torch.float32:
        raise ValueError(f"lut must be float32 (256, 4), got {lut.dtype} {tuple(lut.shape)}")
    for name, t in (("lut", lut), ("h_range", h_range), ("exposure", exposure),
                    ("sun_dir", sun_dir)):
        if t.device != records.device:
            raise ValueError(f"{name} is on {t.device}, records on {records.device}")
    if records.device.type == "cpu":
        v0, v1, v2, mask = tiles.render_gbuffer(records, binning, n_frames,
                                                width, height)
        return fragment.terrain_fs(v0, v1, v2, mask, lut, h_range, exposure,
                                   sun_dir)
    hr2, expo, l = fragment.fs_scalars(h_range, exposure, sun_dir)
    par = torch.stack([hr2, expo, l[0], l[1], l[2]]).to(torch.float32).contiguous()
    lut_rgb = lut[:, :3].contiguous()
    image = torch.empty((n_frames, height, width), dtype=torch.int32,
                        device=records.device)
    lib = load()
    with torch.cuda.device(records.device):
        stream = torch.cuda.current_stream(records.device).cuda_stream
        err = lib.vf_raster_shade_shipped(
            *_launch_args(records, binning, n_frames, width, height),
            lut_rgb.data_ptr(), par.data_ptr(), image.data_ptr(), stream)
    _raise_on(err, "vf_raster_shade_shipped")
    raster_shade_shipped.launches += 1
    return image.view(torch.uint32)


raster_shade_shipped.launches = 0
