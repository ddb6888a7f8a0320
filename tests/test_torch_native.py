"""The port's host core (``vulkan_forge_torch._native``, ``csrc/host.cpp``)
against ``make_grid``, and the port's PNG encoder against the JAX package's.

``grid_generate`` runs the C++ core at every size, and its output must
equal ``make_grid``'s bit for bit at every shape and spacing: the port's
``make_grid`` and ``vulkan_forge._mesh``'s.

The JAX package's own core is not an oracle here. It is built with
``g++ -O3 -march=native``, and on a host with FMA GCC contracts
``x*dx - cx`` into one fused multiply-add, which rounds once where
``make_grid`` (and the reference) round twice. Rebuilding
``cpp/vfcore.cpp`` and comparing its ``xy`` with ``make_grid`` on such a
host gave:

  ===========================  ===================  ============================  =====
  shape and spacing            -O3 -march=native    ... -ffp-contract=off         -O3
  ===========================  ===================  ============================  =====
  257x129, (0.1, 1/3)          30,262 floats differ  equal                        equal
  301x255, (0.7, 1.3)          72,539 differ         equal                        equal
  255x257, (1e-3, 7.77)        69,371 differ         equal                        equal
  ===========================  ===================  ============================  =====

``uv`` and ``idx`` were equal in every build. So the port builds its core
with ``-ffp-contract=off`` and no ``-march=native``, and no test here holds
it to ``vulkan_forge._native.grid_generate_native`` at an inexact spacing.
The JAX core stays as it is: it is the reference, and the JAX ``Renderer``
builds its mesh with ``make_grid``, so no image of it is affected.
"""
import ctypes
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest

from vulkan_forge import _mesh as jmesh
from vulkan_forge import _native as jnative

import vulkan_forge_torch as vt
from vulkan_forge_torch import _build, _io as tio, _mesh as tmesh, _native as tnative

SHAPES = [(127, 129),   # 16383 vertices: below the JAX package's threshold
          (128, 128),   # 16384: the JAX package's threshold for its core
          (160, 130), (255, 257),   # 65,535 vertices: make_grid's u16/u32 edge
          (256, 256), (1024, 1024)]
SPACINGS = [(1.0, 1.0), (30.0, 30.0), (0.1, 1 / 3), (0.7, 1.3), (1e-3, 7.77)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_grid_equal(out, ref):
    """``out`` is grid_generate's (xy, uv, idx); ``ref`` make_grid's."""
    xy, uv, idx = out
    assert (xy.dtype, uv.dtype, idx.dtype) == (np.float32, np.float32, np.uint32)
    assert xy.flags.c_contiguous and uv.flags.c_contiguous and idx.flags.c_contiguous
    assert xy.shape == ref[0].shape and uv.shape == ref[1].shape
    np.testing.assert_array_equal(_bits(xy), _bits(ref[0]))
    np.testing.assert_array_equal(_bits(uv), _bits(ref[1]))
    np.testing.assert_array_equal(idx, ref[2].astype(np.uint32))


@pytest.mark.parametrize("spacing", SPACINGS, ids=lambda s: f"{s[0]:g}x{s[1]:g}")
@pytest.mark.parametrize("nx,nz", SHAPES)
def test_grid_generate_bit_equal_to_make_grid(nx, nz, spacing):
    before = tnative.grid_generate_native.calls
    out = vt.grid_generate(nx, nz, spacing)
    assert tnative.grid_generate_native.calls == before + 1
    _assert_grid_equal(out, tmesh.make_grid(nx, nz, *spacing))
    _assert_grid_equal(out, jmesh.make_grid(nx, nz, *spacing))


_ROOT = Path(tnative.__file__).resolve().parents[1]
_CSRC = _ROOT / "vulkan_forge_torch" / "csrc"


@pytest.mark.parametrize("name", sorted(p.name for p in _CSRC.iterdir()))
def test_csrc_file_is_package_data(name):
    """Every source the port builds at run time ships in an installed package."""
    pyproject = tomllib.loads((_ROOT / "pyproject.toml").read_text())
    globs = pyproject["tool"]["setuptools"]["package-data"]["vulkan_forge_torch"]
    assert any((_CSRC / name).relative_to(_CSRC.parent).match(g) for g in globs), globs


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no loaded library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    return tmp_path / "build"


@pytest.mark.parametrize("nx,nz", [(2, 2), (160, 130)])
def test_missing_compiler_raises(fresh_build, monkeypatch, tmp_path, nx, nz):
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-g++"))
    before = tnative.grid_generate_native.calls
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        vt.grid_generate(nx, nz)
    assert tnative.grid_generate_native.calls == before
    assert not any(fresh_build.iterdir())


def test_failed_build_raises_with_compiler_output(fresh_build, monkeypatch, tmp_path):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'host.cpp:1: error: broken on purpose' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(tnative, "CXX", str(cxx))
    with pytest.raises(RuntimeError, match="broken on purpose"):
        vt.grid_generate(256, 256)
    assert not any(fresh_build.iterdir())


def test_failed_load_raises(fresh_build):
    fresh_build.mkdir()
    tnative.library_path().write_bytes(b"not a shared library")
    with pytest.raises(RuntimeError, match="could not load the host core"):
        vt.grid_generate(256, 256)


def test_build_flags_and_library_name(monkeypatch):
    assert "-ffp-contract=off" in tnative.CXX_FLAGS
    assert not any(f.startswith("-march") for f in tnative.CXX_FLAGS)
    assert _build.BUILD_DIR.parts[-2:] == ("build", "vulkan_forge_torch")
    name = tnative.library_path().name
    assert name.startswith("libvf_host_") and name.endswith(".so")
    # The name follows the flags, so a library built otherwise is never loaded.
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS[:-1])
    assert tnative.library_path().name != name
    # The port's own source: standard headers only, nothing of cpp/.
    includes = [ln for ln in tnative.SOURCE.read_text().splitlines()
                if ln.startswith("#include")]
    assert includes == ["#include <cstdint>"]
    with pytest.raises(ValueError, match="nx and nz must be >= 2"):
        tnative.grid_generate_native(1, 300, 1.0, 1.0)


_BUILD_ONE = """
import sys
sys.path.insert(0, sys.argv[1])
from vulkan_forge_torch import _build, _native as native
_build.BUILD_DIR = native.Path(sys.argv[2])
xy, uv, idx = native.grid_generate_native(200, 100, 0.1, 1 / 3)
print(native.build().name, float(xy[-1, 0]), int(idx[-1]))
"""


def test_concurrent_builds_share_one_library(tmp_path):
    """Test workers build at once: each compiles into a directory of its own
    and moves the library into place, so every process loads a whole one."""
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(_ROOT), str(build)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    want = tmesh.make_grid(200, 100, 0.1, 1 / 3)
    expect = f"{tnative.library_path().name} {float(want[0][-1, 0])} {int(want[2][-1])}"
    assert [o.strip() for o, _ in outs] == [expect] * 4
    assert sorted(p.name for p in build.iterdir()) == [tnative.library_path().name]


def _frame(h, w, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    # A rendered-looking frame: smooth gradients, flat runs and a few edges.
    y, x = np.mgrid[0:h, 0:w]
    img = np.empty((h, w, 4), np.uint8)
    img[..., 0] = (x * 255 // max(w - 1, 1)).astype(np.uint8)
    img[..., 1] = (y * 255 // max(h - 1, 1)).astype(np.uint8)
    img[..., 2] = np.where(rng.random((h, w)) < 0.01, 255, 40)
    img[..., 3] = 255
    return img


@pytest.fixture(scope="module")
def jax_png_encode(tmp_path_factory):
    """``vulkan_forge._native.png_encode_rgba`` on a library of its own.

    The JAX package builds ``cpp/vfcore.cpp`` in place at first use, with no
    temporary file, so under ``pytest -n`` a worker running
    ``tests/test_grid.py`` can hand this one a half-written library, and
    ``available()`` then says False with no reason. Here the same source is
    built with the JAX package's command (``_native/__init__.py:40``) into a
    directory of this module's own and handed to the JAX wrapper; it skips
    only when that build fails, with the compiler's output as the reason."""
    src = Path(jnative.__file__).resolve().parents[2] / "cpp" / "vfcore.cpp"
    lib_path = tmp_path_factory.mktemp("vfcore") / "libvfcore.so"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", str(src),
           "-o", str(lib_path), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except OSError as e:
        pytest.skip(f"the JAX package's native core does not build: {e}")
    if proc.returncode != 0:
        pytest.skip(f"the JAX package's native core does not build: {proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.vf_png_encode_rgba.restype = ctypes.c_int64
    lib.vf_png_encode_rgba.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", lib)
        mp.setattr(jnative, "_TRIED", True)
        yield jnative.png_encode_rgba


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("h,w", [(600, 800), (61, 97)])
def test_png_bytes_equal_jax_core(h, w, kind, jax_png_encode):
    img = _frame(h, w, kind, seed=h * 1000 + w)
    want = jax_png_encode(img)
    assert want is not None
    assert tio.png_encode_rgba(img) == want
