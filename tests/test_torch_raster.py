"""Raster stage of the PyTorch port: the plain tile raster against the JAX
oracles and the wrapper contract. The CUDA kernels against their plain
versions are in test_torch_cuda.py (no jax there: the card machine has none).

The JAX side runs the jnp oracles that ``backend_name()`` picks on the CPU
(``tiles.render_gbuffer``, the list path's spec) and K4's pure-jnp spec
(``packed.render_gbuffer_packed_ref`` + ``fragment.terrain_fs``), fed the
SAME records the port rasterizes. Tolerances:
- coverage masks: identical;
- varyings: |d| <= 1e-5 * max(1, |x|). XLA:CPU contracts the edge
  functions and the three-term sums into FMAs, and the port rounds them
  as it does (``tiles.mad``), so on this machine the two agree bit for
  bit; with that contraction off (``XLA_FLAGS=--xla_cpu_max_isa=AVX``, a
  subprocess) they differ within the tolerance, which
  ``test_plain_gbuffer_bit_equal_without_fma`` shows;
- images: the FS policy (every differing byte off by 1, <= 1e-4 of bytes).
"""
import functools
from fractions import Fraction
import hashlib
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vulkan_forge import _camera as jcam, _colormap as jcmap, _mesh as jmesh
from vulkan_forge._raster import fragment as jfrag, packed as jpacked
from vulkan_forge._raster import pipeline as jpipe, setup as jsetup
from vulkan_forge._raster import tiles as jtiles, transform as jtrans

from vulkan_forge_torch import _build
from vulkan_forge_torch._parity import assert_fs_policy, assert_gbuffer_close
from vulkan_forge_torch._raster import fragment as tfrag, kernels
from vulkan_forge_torch._raster import setup as tsetup, tiles as ttiles
from vulkan_forge_torch.lab import _kernels as lab_kernels

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (grid or None for the triangle, W, H, eye, fovy, znear)
CASES = {
    "triangle_97x61": (None, 97, 61, None, None, None),
    "triangle_800x600": (None, 800, 600, None, None, None),
    "golden_cam_g16_128x96": (16, 128, 96, (2.0, 1.5, 2.5), 50.0, 0.1),
    "orbit_g32_160x120": (32, 160, 120, (-2.0, 1.4, 2.6), 45.0, 0.1),
    "near_cross_g48_160x120": (48, 160, 120, (0.15, 0.7, 0.1), 60.0, 0.5),
    "w_cross_g12_160x120": (12, 160, 120, (0.0, 0.9, 0.0), 60.0, 0.1),
    "spike_default_g128_800x600": (128, 800, 600, (3.0, 2.0, 3.0), 45.0, 0.1),
}


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_triangle_records(W, H):
    clip, vary = jtrans.triangle_vs(jnp.asarray(jpipe._TRI_POS), jnp.asarray(jpipe._TRI_COLOR))
    x, y, z, w = jsetup.clip_to_fb(clip, W, H)
    return jsetup.triangle_setup(x, y, z, w, vary, jnp.array([[0, 1, 2]], jnp.int32), W, H)


def _jax_records(case):
    """Records + bbox from the JAX setup (numpy), the input both sides use."""
    grid, W, H, eye, fovy, zn = CASES[case]
    if grid is None:
        recs, bbox = _jax_triangle_records(W, H)
    else:
        xyuv, idx = jmesh.build_grid_xyuv(grid)
        target = (0, 0, 0) if "cross" not in case else (1.5, -0.2, 1.5)
        view = jcam.look_at_rh(eye, target, (0, 1, 0))
        proj = jcam.perspective_wgpu(np.float32(math.radians(fovy)), np.float32(W / H),
                                     np.float32(zn), np.float32(100.0))
        recs, bbox = jpipe._terrain_records(
            jnp.asarray(xyuv), jnp.asarray(idx.astype(np.int32).reshape(-1, 3)),
            jnp.zeros((1, 1), jnp.float32), jnp.asarray(view), jnp.asarray(proj),
            jnp.float32(1.0), jnp.float32(1.0), W, H)
    return np.asarray(recs), np.asarray(bbox), W, H


_jax_bin = jax.jit(jsetup.bin_triangles, static_argnums=(1, 2, 3),
                   static_argnames=("span_x", "span_y"))
_jax_tiles = jax.jit(jtiles.render_gbuffer, static_argnums=(2, 3))


def _jax_gbuffer(recs, bbox, W, H):
    cap, sx, sy = jpipe._static_bin_params(jnp.asarray(bbox), W, H)
    lists = _jax_bin(jnp.asarray(bbox), W, H, cap, span_x=sx, span_y=sy).tile_lists
    return [np.asarray(a) for a in _jax_tiles(jnp.asarray(recs), lists, W, H)]


def _port_inputs(recs, bbox, W, H):
    records = torch.from_numpy(recs.copy())
    return records, tsetup.bin_tiles(torch.from_numpy(bbox.copy()), W, H)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_gbuffer_matches_jax_tiles(case):
    recs, bbox, W, H = _jax_records(case)
    records, binning = _port_inputs(recs, bbox, W, H)
    got = [a[0] for a in ttiles.render_gbuffer(records, binning, 1, W, H)]
    want = _jax_gbuffer(recs, bbox, W, H)
    assert got[3].dtype == torch.bool and tuple(got[0].shape) == (H, W)
    assert_gbuffer_close(got, want, case)
    assert 0 < int(got[3].sum()) < H * W


_AVX_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from vulkan_forge._raster import pipeline as P, setup as S, tiles as T
d = np.load(sys.argv[1])
recs, bbox, W, H = d["recs"], d["bbox"], int(d["W"]), int(d["H"])
cap, sx, sy = P._static_bin_params(jnp.asarray(bbox), W, H)
lists = S.bin_triangles(jnp.asarray(bbox), W, H, cap, span_x=sx, span_y=sy).tile_lists
out = jax.jit(T.render_gbuffer, static_argnums=(2, 3))(jnp.asarray(recs), lists, W, H)
np.savez(sys.argv[2], *[np.asarray(a) for a in out])
"""


@pytest.mark.parametrize("case", ["w_cross_g12_160x120"])
def test_plain_gbuffer_bit_equal_without_fma(case, tmp_path):
    """The port's plain raster rounds its multiply-adds as XLA:CPU's
    contraction does: bit-equal to the JAX oracle as it runs here, and
    within the varying tolerance of the oracle with the contraction off."""
    recs, bbox, W, H = _jax_records(case)
    np.savez(tmp_path / "in.npz", recs=recs, bbox=bbox, W=W, H=H)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO, VF_NO_CACHE="1")
    proc = subprocess.run([sys.executable, "-c", _AVX_SCRIPT, str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with np.load(tmp_path / "out.npz") as d:
        want = [d[f"arr_{k}"] for k in range(4)]
    records, binning = _port_inputs(recs, bbox, W, H)
    got = [a[0].numpy() for a in ttiles.render_gbuffer(records, binning, 1, W, H)]
    for g, w in zip(got, _jax_gbuffer(recs, bbox, W, H)):
        np.testing.assert_array_equal(g, w)
    assert_gbuffer_close(got, want, f"{case}: port vs the oracle without FMA")


def _fma_exact(a, b, c):
    """fma(a, b, c) rounded once to f32 (ties to even), from exact rationals."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(x))
    cands = [near, np.nextafter(near, np.float32(-np.inf)), np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.uint32)) & 1))


@pytest.mark.parametrize("case", ["ties", "random"])
def test_mad_rounds_once(case):
    """tiles.mad is a single-rounding fused multiply-add (what XLA:CPU
    contracts the raster's a*b + c into, and __fmaf_rn on the card), also
    where an f64 sum lands on an f32 tie and rounding it again would
    differ."""
    if case == "ties":
        e = 2.0 ** -23
        a = np.float32([1 - e, -(1 - e), 1 - e, 1 + e])
        b = np.float32([(1 + e) * 2.0 ** -24] * 4)
        c = np.float32([1 + e, -(1 + e), 1.0, 1 + e])
    else:
        rng = np.random.default_rng(9)
        a, b = (np.float32(rng.standard_normal(3000) * 10.0 ** rng.integers(-3, 4, 3000))
                for _ in range(2))
        c = np.float32(-(a.astype(np.float64) * b) * (1 + rng.standard_normal(3000) * 1e-6))
    got = ttiles.mad(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.float32([_fma_exact(*t) for t in zip(a, b, c)])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if case == "ties":
        twice = np.float32(a.astype(np.float64) * b + c)
        assert (twice != want).sum() == 2, "two tie cases must defeat double rounding"


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_cols_records(xyuv, idx, view, proj, W, H):
    clip, vary = jtrans.terrain_vs(xyuv, jnp.zeros((1, 1), jnp.float32), view, proj,
                                   jnp.float32(1.0), jnp.float32(1.0))
    x, y, z, w = jsetup.clip_to_fb(clip, W, H)
    cols, bbox = jsetup.setup_cols(x, y, z, w, vary, idx, W, H)
    recs, _ = jsetup.triangle_setup(x, y, z, w, vary, idx, W, H)
    return cols, bbox, recs


@pytest.fixture(scope="module")
def packed_case():
    """Two frames of a g24 spike at 160x84 (cf. tests/test_resident.py:115-123):
    K4's pure-jnp spec + the XLA shipped FS, and the same frames' records."""
    grid, W, H = 24, 160, 84
    xyuv, idx = jmesh.build_grid_xyuv(grid)
    idx = jnp.asarray(idx.astype(np.int32).reshape(-1, 3))
    lut = jnp.asarray(jcmap.build_lut("terrain")[0])
    h_range, exposure = jnp.float32(1.0), jnp.float32(1.1)
    sun = jnp.asarray([0.35, 0.9, 0.2], jnp.float32)
    frames = []
    for i in range(2):
        a = 2 * math.pi * i / 2 + 0.4
        view = jcam.look_at_rh((3 * math.cos(a), 2.0, 3 * math.sin(a)), (0, 0, 0), (0, 1, 0))
        proj = jcam.perspective_wgpu(np.float32(math.radians(45)), np.float32(W / H),
                                     np.float32(0.1), np.float32(100))
        cols, bbox, recs = _jax_cols_records(jnp.asarray(xyuv), idx, jnp.asarray(view),
                                             jnp.asarray(proj), W, H)
        frames.append((cols, bbox, np.asarray(recs), np.asarray(bbox)))
    cols_b = tuple(jnp.stack([f[0][k] for f in frames]) for k in range(31))
    bbox_b = jnp.stack([f[1] for f in frames])
    gbuf = jax.jit(jax.vmap(lambda cb, bb: jpacked.render_gbuffer_packed_ref(
        tuple(cb), bb, 2 * (grid - 1), W, H)))(cols_b, bbox_b)
    img = jax.vmap(lambda a, b, c, m: jfrag.terrain_fs(a, b, c, m, lut, h_range, exposure, sun)
                   )(*gbuf)
    return dict(W=W, H=H, recs=np.stack([f[2] for f in frames]),
                bbox=np.stack([f[3] for f in frames]),
                gbuf=[np.asarray(a) for a in gbuf], img=np.asarray(img),
                shade=(np.asarray(lut), np.float32(h_range), np.float32(exposure),
                       np.asarray(sun)))


def _shade_args(shade):
    return tuple(torch.as_tensor(np.array(a)) for a in shade)


def test_plain_fused_matches_packed_spec(packed_case):
    c = packed_case
    W, H = c["W"], c["H"]
    records = torch.from_numpy(c["recs"].reshape(-1, tsetup.REC_WIDTH).copy())
    binning = tsetup.bin_tiles(torch.from_numpy(c["bbox"].copy()), W, H)
    gbuf = ttiles.render_gbuffer(records, binning, 2, W, H)
    assert_gbuffer_close(gbuf, c["gbuf"], "g-buffer vs packed spec")
    img = kernels.raster_shade_shipped(records, binning, 2, W, H, *_shade_args(c["shade"]))
    assert img.dtype == torch.uint32 and tuple(img.shape) == (2, H, W)
    assert_fs_policy(img, c["img"], "fused image vs packed spec + terrain_fs")
    np.testing.assert_array_equal(
        img.view(torch.int32).numpy(),
        tfrag.terrain_fs(*gbuf, *_shade_args(c["shade"])).view(torch.int32).numpy())


def test_wrappers_take_cpu_tensors_to_plain(packed_case):
    c = packed_case
    W, H = c["W"], c["H"]
    records = torch.from_numpy(c["recs"].reshape(-1, tsetup.REC_WIDTH).copy())
    binning = tsetup.bin_tiles(torch.from_numpy(c["bbox"].copy()), W, H)
    n_g, n_s = kernels.raster_gbuffer.launches, kernels.raster_shade_shipped.launches
    got = kernels.raster_gbuffer(records, binning, 2, W, H)
    want = ttiles.render_gbuffer(records, binning, 2, W, H)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    kernels.raster_shade_shipped(records, binning, 2, W, H, *_shade_args(c["shade"]))
    assert kernels.raster_gbuffer.launches == n_g
    assert kernels.raster_shade_shipped.launches == n_s


def test_wrappers_reject_bad_inputs(packed_case):
    c = packed_case
    W, H = c["W"], c["H"]
    records = torch.from_numpy(c["recs"].reshape(-1, tsetup.REC_WIDTH).copy())
    binning = tsetup.bin_tiles(torch.from_numpy(c["bbox"].copy()), W, H)
    with pytest.raises(ValueError, match="records"):
        kernels.raster_gbuffer(records.double(), binning, 2, W, H)
    with pytest.raises(ValueError, match="records"):
        kernels.raster_gbuffer(records[:, :31], binning, 2, W, H)
    with pytest.raises(ValueError, match="offsets does not match"):
        kernels.raster_gbuffer(records, binning, 1, W, H)
    with pytest.raises(ValueError, match="binning.rows"):
        kernels.raster_gbuffer(records, binning._replace(rows=binning.rows.long()), 2, W, H)
    lut, hr, ex, sun = _shade_args(c["shade"])
    with pytest.raises(ValueError, match="lut"):
        kernels.raster_shade_shipped(records, binning, 2, W, H, lut[:, :3], hr, ex, sun)


# Each CUDA library: its module, its name and the files its hash covers.
CUDA_LIBRARIES = {"raster": (kernels, kernels._SOURCES + kernels._HEADERS),
                  "lab": (lab_kernels, (lab_kernels._SOURCE,) + lab_kernels._HEADERS)}


@pytest.mark.parametrize("name", sorted(CUDA_LIBRARIES))
def test_build_needs_nvcc(monkeypatch, tmp_path, name):
    module, files = CUDA_LIBRARIES[name]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    h = hashlib.sha256(b"".join(f.read_bytes() for f in files))
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    assert module.library_path() == tmp_path / "build" / f"libvf_{name}_{h.hexdigest()[:16]}.so"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        module.build()
    assert not any((tmp_path / "build").iterdir())


def test_kernel_tile_matches_binning_tile():
    # kernels.load() makes the same check against the built library's vf_tile().
    src = (kernels._PKG_DIR / "csrc" / "raster.cu").read_text()
    found = [int(ln.split("=")[1].split(";")[0]) for ln in src.splitlines()
             if ln.startswith("constexpr int kTile =")]
    assert found == [tsetup.TILE]
    assert tsetup.tile_grid(800, 600) == (-(-800 // tsetup.TILE), -(-600 // tsetup.TILE))
