"""The cover kernels' factored setup and their survivor counts (CPU).

``vf_vtx_cover`` and ``vf_packed_cover`` (csrc/vtx.cu, csrc/packed.cu)
test each triangle's bbox first and build a record only for the valid
triangles of at most ``vtx.BIG_PIXELS`` bbox pixels: setup is split into
per-vertex terms (``vf::VertexTerms``), the bbox test (``vf::setup_bbox``,
which computes a near-plane crossing only on an edge that straddles
z_clip = 0) and the record's columns (``vf::setup_columns``). Their torch
mirror, ``setup.vertex_terms`` + ``setup.setup_from_terms`` (its crossing
points NaN wherever they are not computed), must give ``setup_fields_core``'s
records, bboxes and valid flags bit for bit:
- on Hypothesis-drawn corners: w-crossing, |w| < 1e-12, edges straddling
  z_clip = 0 in front of the camera, NaN and +-inf, huge w (crossing
  points that overflow), +-1e9 coordinates;
- on a grid and a DEM at close-in, w-crossing and near-plane-cut cameras,
  the last with clean (w > 1e-8) valid triangles whose edges straddle the
  near plane, where the crossing points set the bbox.
The wrappers' ``survivors=`` output (on the card: one count per block,
summed per frame; test_torch_cuda.py holds it to the plain pass's) is the
count of valid triangles of at most BIG_PIXELS bbox pixels per frame that
the mirror's bbox test (``setup.setup_bbox``) finds.

The tests marked ``gpu`` (they skip without a card) feed the same corner
draws to the CUDA kernels, whose setup (``vf::setup_bbox`` in every cover,
big pass and resolve) must give the plain passes' results bit for bit.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _mesh, _renderer
from vulkan_forge_torch._raster import kernels, packed, setup, vtx

torch.set_num_threads(1)

W, H = 160, 120


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _proj(near, fovy=60.0):
    return _camera.perspective_wgpu(np.float32(math.radians(fovy)), np.float32(W / H),
                                    np.float32(near), np.float32(1e4))


def _bits_equal(a, b):
    """Bit-equal tensors, NaN compared as NaN wherever either is NaN."""
    if a.dtype != torch.float32:
        return a.dtype == b.dtype and torch.equal(a, b)
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _assert_factored_equal(c0, c1, c2, width=W, height=H):
    """setup_from_terms over vertex_terms == setup_fields_core; returns the
    latter's output."""
    want = setup.setup_fields_core(c0, c1, c2, width, height)
    got = setup.setup_from_terms(*(setup.vertex_terms(c) for c in (c0, c1, c2)),
                                 width, height)
    for j, (a, b) in enumerate(zip(want[0], got[0])):
        assert _bits_equal(a.expand(want[0][0].shape), b.expand(want[0][0].shape)), \
            f"column {j}"
    for name, a, b in zip(("px0", "px1", "py0", "py1", "valid"), want[1:], got[1:]):
        assert _bits_equal(a, b), name
    return want


def _corners(rng, mode, n):
    """Three corners (lists of 7 (1, n) f32 tensors: x_fb, y_fb, w, v0..v2,
    z_ndc) of n random triangles of a W x H frame, shaped by ``mode``."""
    return [[torch.from_numpy(np.asarray(a, dtype=np.float32)[None])
             for a in _points(rng, mode, n, j)] for j in range(3)]


def _points(rng, mode, n, j):
    """The 7 fields (float64 arrays: x_fb, y_fb, w, v0..v2, z_ndc) of n
    random vertices, shaped by ``mode``, as corner j of n triangles."""
    x, y = rng.uniform(-40, 200, n), rng.uniform(-40, 160, n)
    w = rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-3, 0.5, n)
    zn = rng.uniform(-0.5, 1.5, n)
    v = [rng.uniform(-100, 100, n) for _ in range(3)]
    if mode == "wcross":
        w = np.abs(w) * (1 if j else -1) * rng.choice([-1, 1], n)
    if mode == "tiny_w":
        w = np.where(rng.random(n) < 0.5,
                     rng.choice([-1, 1, 0], n) * 10.0 ** rng.uniform(-16, -11, n), w)
    if mode == "straddle":
        # In front of the camera (w > 1e-8), clip z of either sign.
        w = 10.0 ** rng.uniform(-7.9, 1, n)
        zn = rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-3, 1, n)
    if mode == "nonfinite":
        bad = rng.choice([np.nan, np.inf, -np.inf], n)
        x = np.where(rng.random(n) < 0.2, bad, x)
        w = np.where(rng.random(n) < 0.1, rng.choice([np.nan, np.inf, -np.inf], n), w)
        zn = np.where(rng.random(n) < 0.1, rng.choice([np.nan, np.inf], n), zn)
    if mode == "overflow":
        # Huge w across the near plane: x*w overflows, and a crossing
        # point in front of the camera can be inf or NaN.
        w = 10.0 ** rng.uniform(20, 38, n)
        zn = rng.choice([-1, 1], n) * 10.0 ** rng.uniform(-3, 1, n)
        x = np.where(rng.random(n) < 0.5, rng.choice([-1, 1], n) * 1e9, x)
    if mode == "far":
        x = np.where(rng.random(n) < 0.4, rng.choice([-1, 1], n) * 1e9, x)
        y = np.where(rng.random(n) < 0.4, rng.choice([-1, 1], n) * rng.uniform(5e8, 1e9, n), y)
    return [x, y, w, *v, zn]


CORNER_MODES = ["wcross", "tiny_w", "straddle", "nonfinite", "overflow", "far"]


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**32 - 1), mode=st.sampled_from(CORNER_MODES))
def test_factored_setup_is_bit_equal_on_random_corners(seed, mode):
    _assert_factored_equal(*_corners(np.random.default_rng(seed), mode, 256))


def _grid_case(grid, camera):
    """Corners of the spike grid's triangles at a close-in camera (near
    0.1), one inside the relief whose near plane (0.001) lies closer than a
    cell (w-crossing), or the close-in camera with near 0.5, a plane that
    cuts the mesh."""
    xyuv, _ = _mesh.build_grid_xyuv(grid)
    eye, target, near = {"close-in": ((0.6, 0.45, 0.5), (0, 0, 0), 0.1),
                         "w-crossing": ((0.0, 0.9, 0.0), (1.5, -0.2, 1.5), 0.001),
                         "near-cut": ((0.6, 0.45, 0.5), (0, 0, 0), 0.5)}[camera]
    view = _camera.look_at_rh(eye, target, (0, 1, 0))
    f = vtx.vs_fields(_t(xyuv), _t(np.zeros((1, 1))), _t(view[None]), _t(_proj(near)[None]),
                      _t(1.0), _t(1.0), W, H)
    return setup.grid_corners([f[:, k] for k in range(vtx.FIELDS)], grid)


def _dem_case(n, camera):
    """Corners of a Renderer DEM n x n (30 m cells) from 300 m above its
    centre (near 0.1), from 5 m above it (near 0.001, w-crossing), or at
    the Renderer's default camera with its near plane at 0.8 of the
    distance to the centre, which cuts the mesh."""
    rng = np.random.default_rng(n)
    y, x = np.mgrid[0:n, 0:n] / np.float32(n)
    dem = sum(rng.uniform(100, 400) * np.sin(2 * math.pi * (rng.uniform(1, 3) * x
                                                            + rng.uniform(1, 3) * y
                                                            + rng.uniform()))
              for _ in range(4)).astype(np.float32)
    r = vt.Renderer(W, H, device="cpu")
    r.add_terrain(dem, (30.0, 30.0), 1.5, "terrain")
    xyuv, tris = _renderer.grid_mesh(n, n, 30.0, 30.0, "cpu")
    h0 = float(r._terrain.heights[n // 2, n // 2])
    if camera == "near-cut":
        view, _ = r._default_terrain_camera(r._terrain)
        proj = _proj(0.8 * math.sqrt(2.0) * 0.9 * (n - 1) * 30.0, fovy=45.0)
    else:
        above, near, target = ((5.0, 0.001, (3000.0, h0 - 100.0, 2500.0))
                               if camera == "w-crossing"
                               else (300.0, 0.1, (-3000.0, h0 - 400.0, -2000.0)))
        view = _camera.look_at_rh((0.0, h0 + above, 0.0), target, (0.0, 1.0, 0.0))
        proj = _proj(near)
    f = vtx.vs_fields(xyuv, _t(r._terrain.heights), _t(view[None]), _t(proj[None]),
                      _t(1.0), _t(1.0), W, H, "extended")
    return setup.indexed_corners([f[:, k] for k in range(vtx.FIELDS)], tris)


MESHES = {f"{mesh} {camera}": (case, camera)
          for mesh, case in (("g64", lambda cam: _grid_case(64, cam)),
                             ("DEM-64", lambda cam: _dem_case(64, cam)))
          for camera in ("close-in", "w-crossing", "near-cut")}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_factored_setup_is_bit_equal_on_meshes(name):
    case, camera = MESHES[name]
    corners = case(camera)
    valid = _assert_factored_equal(*corners)[5]
    assert int(valid.sum()) > 0
    if camera == "near-cut":
        # The crossing points set these triangles' bboxes.
        assert int(setup.near_cut(*corners, valid).sum()) > 0, "the near plane must cut the mesh"


def _grid_fields(grid, batch):
    """Post-VS fields of the spike grid at ``batch`` cameras turning about
    a close-in eye (near-camera triangles, so the big list is not empty)."""
    xyuv, _ = _mesh.build_grid_xyuv(grid)
    views = np.stack([_camera.look_at_rh((0.8 * math.cos(0.9 * b), 0.6, 0.8 * math.sin(0.9 * b)),
                                         (0, 0, 0), (0, 1, 0)) for b in range(batch)])
    return vtx.vs_fields(_t(xyuv), _t(np.zeros((1, 1))), _t(views),
                         _t(np.stack([_proj(0.1)] * batch)), _t(1.0), _t(1.0), W, H)


def _mirror_survivors(corners, batch):
    """Per frame: the triangles the mirror's bbox test (``setup.setup_bbox``
    over ``setup.vertex_terms``, the kernels' phase A) finds valid with at
    most BIG_PIXELS bbox pixels."""
    px0, px1, py0, py1, valid = setup.setup_bbox(*(setup.vertex_terms(c) for c in corners), W, H)
    area = (px1 - px0 + 1).long() * (py1 - py0 + 1).long()
    return (valid & (area <= vtx.BIG_PIXELS)).reshape(batch, -1).sum(dim=1).to(torch.int32)


@pytest.mark.parametrize("route", ["vtx", "packed"])
def test_cover_survivors_equal_the_plain_count(route):
    """The CPU wrappers' survivors (the plain pass's count) equal the
    mirror's phase-A count, frame by frame."""
    grid, batch = 48, 3
    fields = _grid_fields(grid, batch)
    survivors = torch.full((batch,), -1, dtype=torch.int32)
    if route == "vtx":
        kernels.vtx_cover(fields, grid, W, H, survivors=survivors)
        corners = setup.grid_corners([fields[:, k] for k in range(vtx.FIELDS)], grid)
    else:
        _, idx = _mesh.build_grid_xyuv(grid)
        tris = torch.as_tensor(idx.astype(np.int32).reshape(-1, 3))
        kernels.packed_cover(fields, tris, W, H, survivors=survivors)
        corners = setup.indexed_corners([fields[:, k] for k in range(vtx.FIELDS)], tris)
    expect = _mirror_survivors(corners, batch)
    assert torch.equal(survivors, expect)
    assert int(expect.min()) > 0 and not torch.equal(expect, expect[:1].expand(batch))


def test_survivors_rejects_bad_tensors():
    grid = 8
    fields = _grid_fields(grid, 2)
    _, idx = _mesh.build_grid_xyuv(grid)
    tris = torch.as_tensor(idx.astype(np.int32).reshape(-1, 3))
    cover = {"vtx": lambda s: kernels.vtx_cover(fields, grid, W, H, survivors=s),
             "packed": lambda s: kernels.packed_cover(fields, tris, W, H, survivors=s)}
    for run in cover.values():
        with pytest.raises(ValueError, match="survivors must be contiguous int32"):
            run(torch.zeros(2, dtype=torch.int64))
        with pytest.raises(ValueError, match="survivors must be contiguous int32"):
            run(torch.zeros(3, dtype=torch.int32))
        with pytest.raises(ValueError, match="survivors must be contiguous int32"):
            run(torch.zeros((2, 2), dtype=torch.int32)[:, 0])
        with pytest.raises(ValueError, match="survivors is on meta"):
            run(torch.zeros(2, dtype=torch.int32, device="meta"))


# ---------------- on the card: the kernels' setup on the same corner draws ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _check_route(dev, cover, cover_plain, cover_big, cover_big_plain, resolve, resolve_plain):
    """One frame through a route's three kernels and their plain versions:
    winner planes bit-equal after the cover and the big pass, the big list
    equal as a set, survivors equal to the plain count, the g-buffer
    bit-equal (NaN where the plain one is NaN)."""
    survivors = torch.full((1,), -1, dtype=torch.int32, device=dev)
    stats = {}
    winner, big, count = cover(survivors)
    p_winner, p_big, p_count = cover_plain(stats)
    assert torch.equal(winner, p_winner) and torch.equal(count, p_count)
    k = int(count[0])
    assert torch.equal(torch.sort(big[:k]).values, p_big[:k])
    assert torch.equal(survivors.long(), stats["survivors"])
    cover_big(winner, big, count)
    cover_big_plain(p_winner, p_big, p_count)
    assert torch.equal(winner, p_winner)
    for a, b in zip(resolve(winner), resolve_plain(winner)):
        assert _bits_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", CORNER_MODES)
def test_packed_kernels_equal_plain_on_corner_draws(cuda, mode):
    """A soup of 1024 triangles drawn as the Hypothesis test draws them,
    and the same 1024 shrunk 30 times about their corner 0 (small ones,
    which reach the survivors' phase B); identity indices."""
    n = 1024
    rng = np.random.default_rng(CORNER_MODES.index(mode))
    corners = [_points(rng, mode, n, j) for j in range(3)]
    with np.errstate(invalid="ignore"):  # inf - inf: NaN, as drawn
        for j in (1, 2):
            corners[j] = [np.concatenate([a, a0 + (a - a0) / 30 if f < 2 else a])
                          for f, (a, a0) in enumerate(zip(corners[j], corners[0]))]
    corners[0] = [np.concatenate([a, a]) for a in corners[0]]
    fields = torch.as_tensor(np.stack(corners, axis=-1).reshape(vtx.FIELDS, -1)[None]
                             .astype(np.float32), device=cuda)
    tris = torch.arange(6 * n, dtype=torch.int32, device=cuda).reshape(2 * n, 3)
    _check_route(cuda, lambda s: kernels.packed_cover(fields, tris, W, H, survivors=s),
                 lambda st: packed.cover_plain(fields, tris, W, H, st),
                 lambda w, b, c: kernels.packed_cover_big(fields, tris, w, b, c),
                 lambda w, b, c: packed.cover_big_plain(fields, tris, w, b, c),
                 lambda w: kernels.packed_resolve_gbuffer(fields, tris, w),
                 lambda w: packed.resolve_gbuffer_plain(fields, tris, w))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", CORNER_MODES)
def test_vtx_kernels_equal_plain_on_corner_draws(cuda, mode):
    """A 32 x 32 grid laid over the frame whose vertices move by a 50th of
    a draw as the Hypothesis test draws corners, w and z_ndc as drawn (the
    staged patch's vertex terms then carry the same NaN, inf, tiny and
    huge w, and x, y far off or non-finite)."""
    grid = 32
    x, y, *rest = _points(np.random.default_rng(CORNER_MODES.index(mode)), mode,
                          grid * grid, 1)
    gy, gx = np.mgrid[0:grid, 0:grid].reshape(2, -1)
    x = gx * (W / (grid - 1)) + (x - 80) / 50
    y = gy * (H / (grid - 1)) + (y - 60) / 50
    fields = torch.as_tensor(np.stack([x, y, *rest]).astype(np.float32)[None], device=cuda)
    _check_route(cuda, lambda s: kernels.vtx_cover(fields, grid, W, H, survivors=s),
                 lambda st: vtx.cover_plain(fields, grid, W, H, st),
                 lambda w, b, c: kernels.vtx_cover_big(fields, grid, w, b, c),
                 lambda w, b, c: vtx.cover_big_plain(fields, grid, w, b, c),
                 lambda w: kernels.vtx_resolve_gbuffer(fields, grid, w),
                 lambda w: vtx.resolve_gbuffer_plain(fields, grid, w))
