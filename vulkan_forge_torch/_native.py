"""Host core of the port: ``grid_generate``'s C++ path (``csrc/host.cpp``).

The counterpart of the JAX package's ``vulkan_forge/_native``. The port
carries one of its entry points, ``grid_generate_native``, which
``_mesh.grid_generate`` runs at every size. Its output is bit-equal to
``_mesh.make_grid``'s: the source is built with ``-ffp-contract=off``, so
no multiply-add is fused where numpy rounds twice, and without
``-march=native``, which would tie the library to one CPU for a loop bound
by memory.

The library is compiled with the host's ``g++`` on first use into
``build/vulkan_forge_torch/libvf_host_<hash>.so``, named by a hash of the
source and the flags, and loaded with ctypes (``_build.py``). A missing
compiler, a failed build or a failed load raises ``RuntimeError``; nothing
falls back to numpy.

``grid_generate_native.calls`` counts the calls that ran the core.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "host.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_F32P = ctypes.POINTER(ctypes.c_float)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_SIGNATURES = {"vf_grid_generate": [ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                                    ctypes.c_float, _F32P, _F32P, _U32P]}

_lib = None


def library_path() -> Path:
    return _build.library_path("host", (SOURCE,), CXX_FLAGS)


def build() -> Path:
    """Compile ``csrc/host.cpp`` into the shared library unless it is built."""
    return _build.build(library_path(), (SOURCE,), CXX_FLAGS, CXX, "the host core")


def load():
    """Build (if needed) and load the host core; returns the CDLL."""
    global _lib
    if _lib is None:
        _lib = _build.load(build(), _SIGNATURES, "the host core", restype=None)
    return _lib


def grid_generate_native(nx: int, nz: int, dx: float, dy: float):
    """(xy (N, 2) f32, uv (N, 2) f32, idx (M,) u32) of an nx x nz grid via
    the C++ core; bit-equal to ``_mesh.make_grid(nx, nz, dx, dy)`` with
    its indices as uint32."""
    nx, nz = int(nx), int(nz)
    if nx < 2 or nz < 2:
        raise ValueError("nx and nz must be >= 2")
    lib = load()
    n = nx * nz
    xy = np.empty((n, 2), dtype=np.float32)
    uv = np.empty((n, 2), dtype=np.float32)
    idx = np.empty(((nx - 1) * (nz - 1) * 6,), dtype=np.uint32)
    lib.vf_grid_generate(nx, nz, np.float32(dx), np.float32(dy),
                         xy.ctypes.data_as(_F32P), uv.ctypes.data_as(_F32P),
                         idx.ctypes.data_as(_U32P))
    grid_generate_native.calls += 1
    return xy, uv, idx


grid_generate_native.calls = 0
