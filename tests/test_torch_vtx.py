"""The port's vertex-stream route (``_raster/vtx.py``) against the record
route and the JAX package (CPU).

On the CPU every vtx wrapper runs its plain PyTorch version, which is the
specification ``csrc/vtx.cu`` is held to on the card (test_torch_cuda.py).
Tolerances:
- grid corners and record columns against a record setup over
  ``build_grid_xyuv`` indices: bit for bit (same ops on the same values);
- vtx g-buffer against the port's record route: bit for bit (masks and
  varyings), the two routes being independent code;
- against the JAX jnp oracle, fed the same post-VS fields: masks exact,
  varyings |d| <= 1e-5 * max(1, |x|) (XLA:CPU contracts multiply-adds);
- images: the FS policy (every differing byte off by 1, on <= 1e-4 of the
  bytes): sin, cos and pow differ by ulps between math libraries.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vulkan_forge import _camera as jcam, _colormap as jcmap, _mesh as jmesh
from vulkan_forge._raster import fragment as jfrag, pipeline as jpipe
from vulkan_forge._raster import setup as jsetup, tiles as jtiles
from vulkan_forge._raster import transform as jtrans, vtx as jvtx

import vulkan_forge_torch as vt
from vulkan_forge_torch import _formats
from vulkan_forge_torch._parity import assert_fs_policy, assert_gbuffer_close
from vulkan_forge_torch._raster import fragment as tfrag, kernels, pipeline as tpipe
from vulkan_forge_torch._raster import setup as tsetup, tiles as ttiles
from vulkan_forge_torch._raster import transform as ttrans, vtx as tvtx

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)

# name -> (grid, W, H, eye, target, fovy, znear)
CAMERAS = {
    "orbit_g40_160x120": (40, 160, 120, (3.0, 2.0, 3.0), (0, 0, 0), 45.0, 0.1),
    # Close in: near-camera cells span many pixels (the big-triangle pass).
    "close_g32_128x96": (32, 128, 96, (0.6, 0.45, 0.5), (0, 0, 0), 60.0, 0.1),
    # Eye inside the relief, near plane closer than a cell: valid triangles
    # crossing w = 0 (full-screen bboxes) and the near plane.
    "w_cross_g24_128x96": (24, 128, 96, (0.0, 0.9, 0.0), (1.5, -0.2, 1.5), 60.0, 0.001),
}


def _camera(name):
    grid, W, H, eye, target, fovy, znear = CAMERAS[name]
    view = jcam.look_at_rh(eye, target, (0, 1, 0))
    proj = jcam.perspective_wgpu(np.float32(math.radians(fovy)), np.float32(W / H),
                                 np.float32(znear), np.float32(100.0))
    return grid, W, H, view, proj


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_fields(xyuv, heights, view, proj, W, H):
    """The JAX vertex stage's post-VS fields (pipeline.py:467-482)."""
    clip, vary = jtrans.terrain_vs(xyuv, heights, view, proj, jnp.float32(1.0),
                                   jnp.float32(1.0))
    x, y, z, w = jsetup.clip_to_fb(clip, W, H)
    return (x, y, w, vary[:, 0], vary[:, 1], vary[:, 2], z, jnp.zeros_like(x))


@functools.lru_cache(maxsize=None)
def _fields(name):
    """(JAX post-VS fields as numpy (7, N), grid, W, H) of a camera: the
    port's rows, without JAX's eighth, zero row."""
    grid, W, H, view, proj = _camera(name)
    xyuv, _ = jmesh.build_grid_xyuv(grid)
    f = _jax_fields(jnp.asarray(xyuv), jnp.zeros((1, 1), jnp.float32),
                    jnp.asarray(view), jnp.asarray(proj), W, H)
    return np.stack([np.asarray(a) for a in f[:tvtx.FIELDS]]), grid, W, H


def _port_fields(name, batch=1):
    f, grid, W, H = _fields(name)
    return torch.from_numpy(np.repeat(f[None], batch, axis=0)).contiguous(), grid, W, H


def _record_route(fields, grid, W, H):
    """The port's slice-1 plain record route on the same fields."""
    _, idx = jmesh.build_grid_xyuv(grid)
    records, bbox = tsetup.triangle_setup(
        fields[:, 0], fields[:, 1], fields[:, 6], fields[:, 2],
        fields[:, 3:6].transpose(1, 2), torch.from_numpy(idx.astype(np.int64).reshape(-1, 3)),
        W, H)
    return ttiles.render_gbuffer(records.reshape(-1, tsetup.REC_WIDTH),
                                 tsetup.bin_tiles(bbox, W, H), fields.shape[0], W, H)


# ---------------- (a) the grid-corner helper ----------------

@pytest.mark.parametrize("n", [2, 5, 17])
def test_grid_corners_match_record_setup(n):
    rng = np.random.default_rng(n)
    fields = [torch.from_numpy(rng.uniform(-50, 250, (2, n * n)).astype(np.float32))
              for _ in range(7)]
    fields[2] = torch.from_numpy(rng.uniform(-0.5, 3.0, (2, n * n)).astype(np.float32))
    corners = tsetup.grid_corners(fields, n)
    _, idx = jmesh.build_grid_xyuv(n)
    idx = torch.from_numpy(idx.astype(np.int64).reshape(-1, 3))
    assert idx.shape[0] == tvtx.n_triangles(n)
    for j in range(3):
        for f, got in zip(fields, corners[j]):
            assert torch.equal(got, f[:, idx[:, j]])
    # Decoding ids as the kernels do gives the same corners.
    tri = torch.arange(idx.shape[0]).repeat(2)
    frame = torch.arange(2).repeat_interleave(idx.shape[0])
    stacked = torch.stack(fields, dim=1)
    decoded = tvtx.tri_corners(stacked, n, frame, tri)
    for j in range(3):
        for a, b in zip(decoded[j], corners[j]):
            assert torch.equal(a, b.reshape(-1))
    cols_g = tsetup.setup_fields_core(*corners, 64, 48)[0]
    cols_r, _ = tsetup.setup_cols(fields[0], fields[1], fields[6], fields[2],
                                  torch.stack(fields[3:6], dim=-1), idx, 64, 48)
    for a, b in zip(cols_g, cols_r):
        assert torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))


# ---------------- (b) plain vtx route == plain record route ----------------

@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_plain_vtx_gbuffer_equals_record_route(name):
    fields, grid, W, H = _port_fields(name, batch=2)
    winner, big, count = kernels.vtx_cover(fields, grid, W, H)
    if name != "orbit_g40_160x120":
        assert int(count[0]) > 0, "the camera must exercise the big-triangle pass"
    corners = tsetup.grid_corners([fields[:, f] for f in range(7)], grid)
    valid = tsetup.setup_fields_core(*corners, W, H)[5]
    w_cross = valid & ~((corners[0][2] > 1e-8) & (corners[1][2] > 1e-8) & (corners[2][2] > 1e-8))
    assert bool(w_cross.any()) == name.startswith("w_cross")
    got = tvtx.render_gbuffer_vtx_batch(fields, grid, W, H)
    want = _record_route(fields, grid, W, H)
    assert bool(got[3].any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_big_pass_split_does_not_change_pixels(monkeypatch):
    """Moving the big-triangle threshold moves triangles between the two
    cover passes and changes no winner."""
    fields, grid, W, H = _port_fields("close_g32_128x96")
    want = tvtx.render_gbuffer_vtx_batch(fields, grid, W, H)
    for limit in (0, 1 << 30):
        monkeypatch.setattr(tvtx, "BIG_PIXELS", limit)
        _, _, count = tvtx.cover_plain(fields, grid, W, H)
        assert (int(count[0]) == 0) == (limit > 0)
        for a, b in zip(tvtx.render_gbuffer_vtx_batch(fields, grid, W, H), want):
            assert torch.equal(a, b)


# ---------------- (c) against the JAX jnp oracle ----------------

def _jax_oracle(f, grid, W, H):
    _, idx = jmesh.build_grid_xyuv(grid)
    indices = jnp.asarray(idx.astype(np.int32).reshape(-1, 3))
    x, y, w, z = (jnp.asarray(f[k]) for k in (0, 1, 2, 6))
    records, bbox = jsetup.triangle_setup(x, y, z, w, jnp.asarray(f[3:6].T), indices, W, H)
    cap = int(jsetup.tile_counts(bbox, W, H).max())
    sx, sy = jsetup.tile_span_max(bbox, W, H)
    binning = jsetup.bin_triangles(bbox, W, H, max(cap, 8), span_x=int(sx), span_y=int(sy))
    return [np.asarray(a) for a in jtiles.render_gbuffer(records, binning.tile_lists, W, H)]


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_plain_vtx_gbuffer_matches_jax_oracle(name):
    f, grid, W, H = _fields(name)
    got = tvtx.render_gbuffer_vtx_batch(torch.from_numpy(f[None].copy()), grid, W, H)
    assert_gbuffer_close([g[0] for g in got], _jax_oracle(f, grid, W, H), name)


# ---------------- (d) against the JAX vtx kernel (interpret mode) ----------------

SHADE = dict(colormap="terrain", h_range=1.0, exposure=1.1, sun=(0.35, 0.9, 0.2))


@pytest.fixture(scope="module")
def jax_vtx_image():
    """One JAX vtx.render_image_vtx_batch call in Pallas interpret mode
    (grid 24, 64x48, slots 8: tests/test_vtx_fused.py's configuration)."""
    grid, W, H = 24, 64, 48
    xyuv, _ = jmesh.build_grid_xyuv(grid)
    view = jcam.look_at_rh((3.0, 2.0, 3.0), (0, 0, 0), (0, 1, 0))
    proj = jcam.perspective_wgpu(np.float32(math.radians(45.0)), np.float32(W / H),
                                 np.float32(0.1), np.float32(100.0))
    f = _jax_fields(jnp.asarray(xyuv), jnp.zeros((1, 1), jnp.float32),
                    jnp.asarray(view), jnp.asarray(proj), W, H)
    lut, _ = jcmap.build_lut(SHADE["colormap"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VF_VTX_INTERPRET", "1")
        img, needed = jvtx.render_image_vtx_batch(
            tuple(a[None] for a in f), jnp.asarray(lut), jnp.float32(SHADE["h_range"]),
            jnp.float32(SHADE["exposure"]), jnp.asarray(SHADE["sun"], jnp.float32),
            grid, W, H, slots=8)
    assert float(needed) <= 8
    return (np.stack([np.asarray(a) for a in f[:tvtx.FIELDS]]), lut, np.asarray(img),
            grid, W, H)


def test_vtx_image_matches_jax_vtx_kernel(jax_vtx_image):
    f, lut, want, grid, W, H = jax_vtx_image
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    img = tvtx.render_image_vtx_batch(torch.from_numpy(f[None].copy()), t(lut),
                                      t(SHADE["h_range"]), t(SHADE["exposure"]),
                                      t(SHADE["sun"]), grid, W, H)
    assert img.dtype == torch.uint32 and tuple(img.shape) == (1, H, W)
    assert_fs_policy(img, want, "port vtx image vs JAX vtx kernel (interpret)")


# ---------------- (e) the extended shader, both routes, against JAX ----------------

def _extended_scene():
    grid, W, H = 40, 160, 120
    xyuv, idx = jmesh.build_grid_xyuv(grid)
    heights = np.random.default_rng(5).uniform(-0.6, 0.5, (37, 29)).astype(np.float32)
    view = jcam.look_at_rh((-2.4, 1.6, 2.0), (0.1, 0, 0), (0, 1, 0))
    proj = jcam.perspective_wgpu(np.float32(math.radians(50.0)), np.float32(W / H),
                                 np.float32(0.1), np.float32(60.0))
    lut, _ = jcmap.build_lut("terrain")
    args = dict(spacing=0.9, exaggeration=1.3, h_min=-0.6, h_max=0.5, exposure=1.2,
                sun_dir=np.array([0.3, 0.8, -0.4], np.float32), lut=lut, width=W, height=H,
                fs_mode="extended")
    return grid, xyuv, idx, heights, view, proj, args


@pytest.fixture(scope="module")
def jax_extended_image():
    grid, xyuv, idx, heights, view, proj, args = _extended_scene()
    return jpipe.render_terrain_u8(xyuv, idx, heights, view, proj, backend="jnp",
                                   normal_spacing=0.7, **args)


@pytest.mark.parametrize("route", ["record", "vtx", "indexed"])
def test_extended_shader_matches_jax(route, jax_extended_image, monkeypatch):
    """The extended shader over each route's g-buffer. The pipeline sends a
    grid mesh that names its grid to the vtx route and one that does not to
    the indexed route; the record route's g-buffer is composed here from
    its stages (``terrain_records`` + ``raster_gbuffer``)."""
    grid, xyuv, idx, heights, view, proj, args = _extended_scene()
    W, H = args["width"], args["height"]
    if route == "record":
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
        records, binning = tpipe.terrain_records(
            t(xyuv), torch.from_numpy(idx.astype(np.int64).reshape(-1, 3)), t(heights),
            t(view)[None], t(proj)[None], t(args["spacing"]), t(args["exaggeration"]),
            W, H, fs_mode="extended")
        img = tfrag.terrain_fs_extended(
            *kernels.raster_gbuffer(records, binning, 1, W, H), t(args["lut"]), t(heights),
            t(args["h_min"]), t(args["h_max"]), t(args["exposure"]), t(args["sun_dir"]),
            t(0.7), t(args["exaggeration"]))[0]
        got = _formats.u32_image_to_rgba_u8(img).numpy()
    else:
        used = {name: _spy(monkeypatch, name)
                for name in ("vtx_resolve_gbuffer", "packed_resolve_gbuffer")}
        got = tpipe.render_terrain_u8(xyuv, idx, heights, view, proj,
                                      grid_n=grid if route == "vtx" else None,
                                      normal_spacing=0.7, device="cpu", **args)
        assert used == {"vtx_resolve_gbuffer": [1] if route == "vtx" else [],
                        "packed_resolve_gbuffer": [1] if route == "indexed" else []}
    assert got.dtype == np.uint8 and got.shape == (H, W, 4)
    assert_fs_policy(got, jax_extended_image, f"extended, {route} route")


def test_terrain_vs_extended_matches_jax():
    grid, xyuv, _, heights, view, proj, args = _extended_scene()
    sp, ex = np.float32(args["spacing"]), np.float32(args["exaggeration"])
    x, z = jnp.asarray(xyuv[:, 0]), jnp.asarray(xyuv[:, 1])
    h = jtrans.sample_height_nearest(jnp.asarray(heights), jnp.asarray(xyuv[:, 2:4]))
    world = jnp.stack([x * sp, h * ex, z * sp, jnp.ones_like(x)], axis=-1)
    want = np.asarray((world @ jnp.asarray(view).T) @ jnp.asarray(proj).T)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    clip, vary = ttrans.terrain_vs_extended(t(xyuv), t(heights), t(view), t(proj), t(sp), t(ex))
    np.testing.assert_array_equal(clip.numpy(), want)
    np.testing.assert_array_equal(
        vary.numpy(), np.stack([np.asarray(h), xyuv[:, 2], xyuv[:, 3]], axis=-1))


@pytest.mark.parametrize("seed", [0, 1])
def test_terrain_fs_extended_matches_jax(seed):
    rng = np.random.default_rng(seed)
    H, W = 24, 40
    h = rng.uniform(-0.8, 0.8, (H, W)).astype(np.float32)
    u, v = (rng.uniform(-0.1, 1.1, (H, W)).astype(np.float32) for _ in range(2))
    mask = rng.random((H, W)) > 0.2
    heights = rng.uniform(-0.5, 0.5, (13, 17)).astype(np.float32)
    lut, _ = jcmap.build_lut("magma")
    sc = [np.float32(s) for s in (-0.6, 0.7, 1.4, 0.8, 1.2)]  # h_min h_max exposure spacing exag
    sun = np.array([0.2, 0.9, 0.3], np.float32)
    want = jfrag.terrain_fs_extended(*(jnp.asarray(a) for a in (h, u, v, mask, lut, heights)),
                                     sc[0], sc[1], sc[2], jnp.asarray(sun), sc[3], sc[4])
    t = torch.as_tensor
    got = tfrag.terrain_fs_extended(t(h), t(u), t(v), t(mask), t(lut), t(heights),
                                    *(t(s) for s in sc[:3]), t(sun), *(t(s) for s in sc[3:]))
    assert_fs_policy(got, np.asarray(want), "terrain_fs_extended")


# ---------------- (f) Scene through the vtx route ----------------

def _spy(monkeypatch, name):
    """Record each call of kernels.<name> in the returned list."""
    calls, fn = [], getattr(kernels, name)

    def spy(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    monkeypatch.setattr(kernels, name, spy)
    return calls


@pytest.mark.parametrize("cls", ["Scene", "TerrainSpike"])
def test_scene_vtx_route_equals_record_route(cls, monkeypatch):
    """A Scene names its grid, so it takes the vtx route; the record route
    (the same Scene with no grid named) gives the same bytes."""
    s = getattr(vt, cls)(160, 120, 64, "magma", device="cpu")
    s.set_camera_look_at((1.1, 0.8, -1.6), (0, 0, 0), (0, 1, 0), 55.0, 0.1, 50.0)
    used = _spy(monkeypatch, "vtx_resolve_shade_shipped")
    vtx_img = s.render_rgba()
    assert used == [1]
    monkeypatch.setattr(s, "grid", None)
    np.testing.assert_array_equal(s.render_rgba(), vtx_img)
    assert used == [1]


def test_route_choice():
    assert not tpipe.use_vtx_route(None, 1024 * 1024, tvtx.n_triangles(1024))
    assert tpipe.use_vtx_route(1024, 1024 * 1024, tvtx.n_triangles(1024))
    assert tpipe.use_vtx_route(2, 4, 2)
    assert not tpipe.use_vtx_route(1, 1, 0)
    assert not tpipe.use_vtx_route(256, 256 * 256, tvtx.n_triangles(256) - 2)
    assert not tpipe.use_vtx_route(256, 255 * 256, tvtx.n_triangles(256))
    # No size crossover: every grid that names itself takes the vtx route.
    for n in (8, 64, 128, 256):
        assert tpipe.use_vtx_route(n, n * n, tvtx.n_triangles(n))


def test_batch_vtx_route_matches_reference(monkeypatch):
    """The batched entry over the vtx route against the JAX package's
    per-frame render, shipped shader."""
    W, H, grid = 96, 72, 48
    xyuv, idx = jmesh.build_grid_xyuv(grid)
    lut, _ = jcmap.build_lut("viridis")
    views = np.stack([jcam.look_at_rh((3 * math.cos(a), 1.8, 3 * math.sin(a)), (0, 0, 0),
                                      (0, 1, 0)) for a in (0.3, 2.0)])
    proj = jcam.perspective_wgpu(np.float32(math.radians(45)), np.float32(W / H),
                                 np.float32(0.1), np.float32(100))
    args = dict(spacing=1.0, exaggeration=1.0, h_min=-0.5, h_max=0.5, exposure=1.0,
                sun_dir=np.array([0.4, 0.8, 0.45], np.float32), lut=lut, width=W, height=H)
    heights = np.zeros((1, 1), np.float32)
    used = _spy(monkeypatch, "vtx_resolve_shade_shipped")
    imgs = tpipe.render_terrain_batch_u32(xyuv, idx, heights, views, np.stack([proj] * 2),
                                          grid_n=grid, device="cpu", **args)
    assert used == [1]
    rgba = _formats.u32_image_to_rgba_u8(imgs).numpy()
    for b in range(2):
        want = jpipe.render_terrain_u8(xyuv, idx, heights, views[b], proj, backend="jnp",
                                       fs_mode="shipped", **args)
        assert_fs_policy(rgba[b], want, f"vtx batch frame {b}")


# ---------------- the wrapper contract on the CPU ----------------

def test_vtx_wrappers_take_cpu_tensors_to_plain():
    fields, grid, W, H = _port_fields("close_g32_128x96", batch=2)
    names = ("vtx_cover", "vtx_cover_big", "vtx_resolve_gbuffer", "vtx_resolve_shade_shipped")
    before = [getattr(kernels, n).launches for n in names]
    winner, big, count = kernels.vtx_cover(fields, grid, W, H)
    p = tvtx.cover_plain(fields, grid, W, H)
    for a, b in zip((winner, big, count), p):
        assert torch.equal(a, b)
    kernels.vtx_cover_big(fields, grid, winner, big, count)
    gbuf = kernels.vtx_resolve_gbuffer(fields, grid, winner)
    lut, _ = jcmap.build_lut("viridis")
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    shade = (t(lut), t(1.0), t(1.0), t([0.3, 0.9, 0.2]))
    img = kernels.vtx_resolve_shade_shipped(fields, grid, winner, *shade)
    np.testing.assert_array_equal(img.view(torch.int32).numpy(),
                                  tfrag.terrain_fs(*gbuf, *shade).view(torch.int32).numpy())
    assert [getattr(kernels, n).launches for n in names] == before


def test_vtx_wrappers_reject_bad_inputs():
    fields, grid, W, H = _port_fields("orbit_g40_160x120")
    with pytest.raises(ValueError, match="fields"):
        kernels.vtx_cover(fields.double(), grid, W, H)
    with pytest.raises(ValueError, match="fields"):
        kernels.vtx_cover(fields, grid + 1, W, H)
    with pytest.raises(ValueError, match="fields"):
        kernels.vtx_cover(fields.transpose(0, 1), grid, W, H)
    winner, big, count = kernels.vtx_cover(fields, grid, W, H)
    with pytest.raises(ValueError, match="winner"):
        kernels.vtx_resolve_gbuffer(fields, grid, winner.float())
    with pytest.raises(ValueError, match="big"):
        kernels.vtx_cover_big(fields, grid, winner, big[:-1], count)
    lut, _ = jcmap.build_lut("viridis")
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    with pytest.raises(ValueError, match="lut"):
        tvtx.render_image_vtx_batch(fields, t(lut)[:, :3], t(1.0), t(1.0),
                                    t([0.0, 1.0, 0.0]), grid, W, H)
    with pytest.raises(ValueError, match="fs_mode"):
        tpipe.render_terrain_batch_u32(np.zeros((4, 4), np.float32), np.zeros(6), np.zeros((1, 1)),
                                       np.eye(4)[None], np.eye(4)[None], spacing=1, exaggeration=1,
                                       h_min=0, h_max=1, exposure=1, sun_dir=[0, 1, 0],
                                       lut=lut, width=8, height=8, fs_mode="fancy",
                                       device="cpu")


def test_vs_fields_layout():
    grid, W, H = 9, 64, 48
    xyuv, _ = jmesh.build_grid_xyuv(grid)
    views, projs = (np.stack([m] * 3) for m in _camera("orbit_g40_160x120")[3:])
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    f = tvtx.vs_fields(t(xyuv), t(np.zeros((1, 1))), t(views), t(projs), t(1.0), t(1.0), W, H)
    assert f.dtype == torch.float32 and tuple(f.shape) == (3, 7, grid * grid)
    assert f.is_contiguous()
    clip, vary = ttrans.terrain_vs(t(xyuv), t(np.zeros((1, 1))), t(views), t(projs),
                                   t(1.0), t(1.0))
    x, y, z, w = tsetup.clip_to_fb(clip, W, H)
    for k, want in enumerate((x, y, w, vary[:, 0], vary[:, 1], vary[:, 2], z)):
        assert torch.equal(f[:, k], want.expand(3, -1))
