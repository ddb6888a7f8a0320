"""Host core of the port: ``grid_generate``'s C++ path (``csrc/host.cpp``).

The counterpart of the JAX package's ``vulkan_forge/_native``. The port
carries one of its entry points, ``grid_generate_native``, which
``_mesh.grid_generate`` runs at every size. Its output is bit-equal to
``_mesh.make_grid``'s: the source is built with ``-ffp-contract=off``, so
no multiply-add is fused where numpy rounds twice, and without
``-march=native``, which would tie the library to one CPU for a loop bound
by memory.

The library is compiled with the host's ``g++`` on first use into
``build/vulkan_forge_torch/`` at the root of the checkout, named by a hash
of the source and the flags, and loaded with ctypes. Several processes may
build at once: each compiles into a directory of its own and moves the
result into place. A missing compiler, a failed build or a failed load
raises ``RuntimeError``; nothing falls back to numpy.

``grid_generate_native.calls`` counts the calls that ran the core.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "host.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_F32P = ctypes.POINTER(ctypes.c_float)
_U32P = ctypes.POINTER(ctypes.c_uint32)

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvf_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/host.cpp`` into the shared library unless it is built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        lib = os.path.join(tmp, out.name)
        cmd = [CXX, *CXX_FLAGS, "-o", lib, str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"the host core is built with a C++ compiler on first "
                               f"use, and {' '.join(cmd)} did not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def load():
    """Build (if needed) and load the host core; returns the CDLL."""
    global _lib
    if _lib is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
            fn = lib.vf_grid_generate
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"could not load the host core {path}: {e}") from e
        fn.restype = None
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                       _F32P, _F32P, _U32P]
        _lib = lib
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
