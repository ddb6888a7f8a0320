"""The record route's set-up (``kernels.rec_setup``: the ``vf_rec_*``
kernels of csrc/records.cu) against its plain version,
``setup.rec_setup_plain``.

On the CPU the wrapper runs the plain version without loading the library
or counting a launch; the plain version is ``triangle_setup`` and
``bin_tiles`` with the binned triangles' records alone and the rows
renumbered into them; the cases are checked to be what they are named (a
near-plane cut, a w-crossing camera, several frames, nothing seen), and
the wrapper refuses what the kernels do not take, an index out of range
among it. The ``gpu`` tests hold the kernels to the plain version on the
same CUDA tensors -- the records bit for bit, the rows, offsets and boxes
byte for byte -- count the launches, and raise on a bad index
(``python3 -m pytest -m gpu tests/test_torch_rec_setup.py``). This file
imports no jax.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _mesh, _renderer
from vulkan_forge_torch._raster import kernels, pipeline, setup, vtx

torch.set_num_threads(1)

DEM_N = 129                      # a 129^2 DEM: 32,768 triangles
SPIKE_N = 64                     # the spike's grid: 7,938 triangles

# name -> (mesh, eye (a share of the DEM's extent, or world units), near
# plane (a share of the eye's distance, or world units), frames, fill rule,
# (width, height), what the case must show). An "empty" case looks away
# from the terrain, straight up. "spike_inside" looks across
# the relief from inside it with a near plane closer than a grid cell, so
# that valid triangles cross w = 0.
CASES = {
    "renderer_hw": ("renderer", (-0.9, 0.9, 0.0), 1e-3, 1, "hw", (160, 120), "binned"),
    "renderer_inclusive": ("renderer", (-0.9, 0.9, 0.0), 1e-3, 1, "inclusive", (160, 120),
                           "binned"),
    "renderer_near_cut_hw": ("renderer", (-0.3, 0.25, -0.2), 0.5, 1, "hw", (160, 120),
                             "near_cut"),
    "renderer_nothing_seen_hw": ("renderer", (0.0, 2.0, 0.0), 1e-3, 1, "hw", (160, 120),
                                 "empty"),
    "spike_batch_hw": ("spike", (2.0, 1.5, 2.5), 0.1, 3, "hw", (161, 83), "batch"),
    "spike_batch_inclusive": ("spike", (-2.0, 1.4, 2.6), 0.1, 2, "inclusive", (128, 96),
                              "batch"),
    "spike_g64_shipped_hw": ("spike", (3.0, 2.0, 3.0), 0.1, 1, "hw", (800, 600), "binned"),
    "spike_w_crossing_hw": ("spike_inside", (0.0, 0.9, 0.0), 0.001, 1, "hw", (97, 61),
                            "w_crossing"),
    "spike_w_crossing_inclusive": ("spike_inside", (0.0, 0.9, 0.0), 0.001, 1, "inclusive",
                                   (97, 61), "w_crossing"),
    "triangle_hw": ("triangle", None, None, 1, "hw", (97, 61), "binned"),
    "triangle_inclusive": ("triangle", None, None, 1, "inclusive", (800, 600), "binned"),
}


def _dem(n, seed):
    rng = np.random.default_rng(seed)
    x = np.linspace(-3.0, 3.0, n, dtype=np.float32)
    h = 400.0 * np.exp(-(x[None] ** 2 + x[:, None] ** 2) / 2) + rng.normal(0.0, 20.0, (n, n))
    return h.astype(np.float32)


def _t(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _cameras(eyes, near, far, w, h, target=(0.0, 0.0, 0.0), fovy=45.0):
    views = []
    for eye in eyes:
        up = (0.0, 1.0, 0.0) if abs(eye[0] - target[0]) + abs(eye[2] - target[2]) > 0 \
            else (0.0, 0.0, 1.0)
        views.append(_camera.look_at_rh(eye, target, up))
    proj = _camera.perspective_wgpu(np.float32(math.radians(fovy)), np.float32(w / h),
                                    np.float32(near), np.float32(far))
    return np.stack(views), np.stack([proj] * len(eyes))


def _turned(eye, b):
    """``eye`` turned 0.7 rad a frame about the y axis."""
    c, s = math.cos(0.7 * b), math.sin(0.7 * b)
    return (eye[0] * c - eye[2] * s, eye[1], eye[0] * s + eye[2] * c)


def _inputs(case, device):
    """(fields, indices, width, height, fill rule) of a case on ``device``."""
    mesh, eye, near, frames, rule, (w, h), _ = CASES[case]
    if mesh == "triangle":
        return (*pipeline.triangle_fields(w, h, device), w, h, rule)
    if mesh == "renderer":
        r = vt.Renderer(w, h, device=device)
        r.add_terrain(_dem(DEM_N, 5), (30.0, 30.0), 1.5, "terrain")
        r.upload_height_r32f()
        terr = r._terrain
        xyuv, idx = _renderer.grid_mesh(terr.width, terr.height, *terr.spacing, device)
        extent = (DEM_N - 1) * 30.0
        e = tuple(extent * c for c in eye)
        dist = math.sqrt(sum(c * c for c in e))
        target = tuple(2.0 * c for c in e) if CASES[case][-1] == "empty" else (0.0, 0.0, 0.0)
        views, projs = _cameras([e], dist * near, dist * 10.0 + 10.0, w, h, target)
        heights, fs_mode = r._height_tex, "extended"
    else:
        xyuv, tris = _mesh.build_grid_xyuv(SPIKE_N)
        xyuv = _t(xyuv, device)
        idx = torch.as_tensor(tris.astype(np.int64).reshape(-1, 3), device=device)
        rng = np.random.default_rng(11)
        heights = _t(rng.uniform(0.0, 0.3, (SPIKE_N, SPIKE_N)), device)
        if mesh == "spike_inside":
            views, projs = _cameras([eye], near, 1e4, w, h, target=(1.5, -0.2, 1.5), fovy=60.0)
        else:
            views, projs = _cameras([_turned(eye, b) for b in range(frames)], near, 100.0, w, h)
        fs_mode = "shipped"
    fields = vtx.vs_fields(xyuv, heights, _t(views, device), _t(projs, device),
                           _t(1.0, device), _t(1.0, device), w, h, fs_mode)
    return fields, idx, w, h, rule


def _corners(fields, idx):
    """The unsnapped corners of every triangle of every frame, and their
    inclusive-rule valid flags."""
    corners = setup.indexed_corners([fields[:, k] for k in range(vtx.FIELDS)], idx)
    return corners, setup.setup_fields_core(*corners, 1 << 20, 1 << 20)[-1]


def _assert_same(got, want):
    (rec, b), (rec_w, b_w) = got, want
    assert rec.dtype == rec_w.dtype == torch.float32 and rec.shape == rec_w.shape
    assert rec.is_contiguous() and rec.shape[1] == setup.REC_WIDTH
    assert torch.equal(rec.view(torch.int32), rec_w.view(torch.int32))
    for name in setup.Binning._fields:
        a, c = getattr(b, name), getattr(b_w, name)
        assert a.dtype == c.dtype == torch.int32 and a.shape == c.shape, name
        assert a.is_contiguous() and torch.equal(a, c), name


# ---------------- on the CPU ----------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_takes_cpu_tensors_to_plain(case, monkeypatch):
    fields, idx, w, h, rule = _inputs(case, "cpu")
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("loaded the library"))
    before = kernels.rec_setup.launches
    got = kernels.rec_setup(fields, idx, w, h, rule)
    assert kernels.rec_setup.launches == before
    _assert_same(got, setup.rec_setup_plain(fields, idx, w, h, rule))
    records, binning = got
    what = CASES[case][-1]
    assert (records.shape[0] == 0) == (what == "empty")
    assert (binning.rows.numel() == 0) == (what == "empty")
    corners, valid = _corners(fields, idx)
    if what == "near_cut":
        assert int(setup.near_cut(*corners, valid).sum()) > 0
    if what == "w_crossing":
        w_min = torch.minimum(torch.minimum(corners[0][2], corners[1][2]), corners[2][2])
        assert int((valid & (w_min <= 1e-8)).sum()) > 0
    if what == "batch":
        assert fields.shape[0] > 1
        ntx, nty = setup.tile_grid(w, h)
        per_frame = binning.offsets[::ntx * nty]
        assert bool((per_frame[1:] > per_frame[:-1]).all())


@pytest.mark.parametrize("case", ["renderer_hw", "renderer_near_cut_hw", "spike_batch_hw",
                                  "spike_batch_inclusive", "spike_w_crossing_hw"])
def test_plain_is_setup_and_binning_renumbered(case):
    """``rec_setup_plain`` is ``triangle_setup`` + ``bin_tiles``: the same
    offsets and boxes, each pair's row naming the same (frame, triangle)
    and its record, every record binned, each tile's rows ascending."""
    fields, idx, w, h, rule = _inputs(case, "cpu")
    records, binning = setup.rec_setup_plain(fields, idx, w, h, rule)
    full, bbox = setup.triangle_setup(fields[:, 0], fields[:, 1], fields[:, 6], fields[:, 2],
                                      fields[:, 3:6].transpose(1, 2), idx, w, h, rule)
    want = setup.bin_tiles(bbox, w, h)
    T = idx.shape[0]
    binned = torch.nonzero((bbox[..., 1] >= bbox[..., 0]).reshape(-1))[:, 0]
    old_row = binned + torch.div(binned, T, rounding_mode="floor")   # frame * (T + 1) + id
    assert records.shape[0] == binned.numel() > 0
    assert torch.equal(old_row[binning.rows.long()], want.rows.long())
    assert torch.equal(binning.offsets, want.offsets) and torch.equal(binning.boxes, want.boxes)
    assert torch.equal(records, full.reshape(-1, setup.REC_WIDTH)[old_row])
    assert bool((records[:, 24] == 1.0).all())
    assert int(torch.unique(binning.rows).numel()) == records.shape[0]
    rows, offs = binning.rows, binning.offsets
    for k in range(offs.numel() - 1):
        lst = rows[offs[k]:offs[k + 1]]
        assert bool((lst[1:] > lst[:-1]).all())


def _bad(case):
    fields, idx, w, h, rule = _inputs("spike_batch_hw", "cpu")
    args = dict(fields=fields, indices=idx, width=w, height=h, fill_rule=rule)
    n = fields.shape[2]
    high, low = idx.clone(), idx.clone()
    high[5, 1] = n
    low[7, 2] = -1
    change = {
        "fields_dtype": dict(fields=fields.double()),
        "fields_shape": dict(fields=fields[0]),
        "fields_planes": dict(fields=fields[:, :6].contiguous()),
        "fields_strided": dict(fields=fields.transpose(1, 2).contiguous().transpose(1, 2)),
        "indices_dtype": dict(indices=idx.to(torch.int16)),
        "indices_shape": dict(indices=idx.reshape(-1)),
        "indices_strided": dict(indices=idx.t().contiguous().t()),
        "indices_device": dict(indices=torch.empty(idx.shape, dtype=torch.int64,
                                                   device="meta")),
        "fill_rule": dict(fill_rule="top-left"),
        "frame": dict(width=0),
        "index_high": dict(indices=high),
        "index_negative": dict(indices=low),
        "index_high_i32": dict(indices=high.int()),
    }[case]
    return {**args, **change}


BAD = {"fields_dtype": "fields must be", "fields_shape": "fields must be",
       "fields_planes": "fields must be", "fields_strided": "fields must be",
       "indices_dtype": "indices must be", "indices_shape": "indices must be",
       "indices_strided": "indices must be", "indices_device": "indices is on meta",
       "fill_rule": "fill_rule must be", "frame": "width and height",
       "index_high": r"indices must lie in \[0, 4096\), got \[0, 4096\]",
       "index_negative": r"indices must lie in \[0, 4096\), got \[-1, 4095\]",
       "index_high_i32": r"indices must lie in \[0, 4096\)"}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_rejects_bad_inputs(case):
    a = _bad(case)
    before = kernels.rec_setup.launches
    with pytest.raises(ValueError, match=BAD[case]):
        kernels.rec_setup(**a)
    assert kernels.rec_setup.launches == before


@pytest.mark.parametrize("frames, n_tris", [(0, 12), (2, 0)])
def test_no_frame_or_no_triangle_gives_empty_lists(frames, n_tris, monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda: pytest.fail("loaded the library"))
    fields = torch.zeros((frames, vtx.FIELDS, 9))
    idx = torch.zeros((n_tris, 3), dtype=torch.int64)
    records, binning = kernels.rec_setup(fields, idx, 40, 20, "hw")
    ntx, nty = setup.tile_grid(40, 20)
    assert records.shape == (0, setup.REC_WIDTH)
    assert binning.rows.numel() == binning.boxes.numel() == 0
    assert torch.equal(binning.offsets, torch.zeros(frames * ntx * nty + 1, dtype=torch.int32))


@pytest.mark.parametrize("frames, w, h, binned, want", [
    (1, 800, 600, True, 10),      # 1,900 tiles: 11 key bits, two passes
    (1, 800, 600, False, 3),
    (1, 16, 16, True, 4),         # one tile: sorted already
    (1, 64, 64, True, 7),         # 16 tiles: one pass
    (4, 800, 600, True, 10),      # 7,600 keys: 13 bits
    (1, 7680, 4320, True, 13),    # 129,600 tiles: 17 bits, three passes
])
def test_launch_count_is_three_and_a_sort(frames, w, h, binned, want):
    assert kernels.rec_setup_launches(frames, w, h, binned) == want


def test_routes_set_up_through_the_wrapper(monkeypatch):
    """``terrain_records`` hands the vertex stage's fields and the index
    buffer it was given to ``rec_setup``; ``triangle_records`` its three
    vertices as (1, 7, 3) fields."""
    seen = []
    real = kernels.rec_setup
    monkeypatch.setattr(kernels, "rec_setup", lambda *a: seen.append(a) or real(*a))
    fields, idx, w, h, rule = _inputs("spike_batch_hw", "cpu")
    xyuv, _ = _mesh.build_grid_xyuv(SPIKE_N)
    views, projs = _cameras([(2.0, 1.5, 2.5)], 0.1, 100.0, w, h)
    heights = _t(np.random.default_rng(11).uniform(0.0, 0.3, (SPIKE_N, SPIKE_N)), "cpu")
    got = pipeline.terrain_records(_t(xyuv, "cpu"), idx, heights, _t(views, "cpu"),
                                   _t(projs, "cpu"), _t(1.0, "cpu"), _t(1.0, "cpu"), w, h,
                                   "shipped", rule)
    assert seen[0][1].data_ptr() == idx.data_ptr() and seen[0][2:] == (w, h, rule)
    assert torch.equal(seen[0][0], fields[:1])
    _assert_same(got, real(fields[:1], idx, w, h, rule))
    records, _ = pipeline.triangle_records(97, 61, "cpu", "hw")
    fields, idx = pipeline.triangle_fields(97, 61, "cpu")
    assert torch.equal(seen[1][0], fields) and seen[1][0].shape == (1, vtx.FIELDS, 3)
    assert seen[1][1].tolist() == [[0, 1, 2]] and seen[1][2:] == (97, 61, "hw")
    assert records.shape == (1, setup.REC_WIDTH)


# ---------------- on the card ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the set-up kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_equals_plain_on_the_card(cuda, case):
    """Records (bits), rows, offsets and boxes equal the plain version's on
    the same CUDA tensors; the launches are three and the sort's."""
    fields, idx, w, h, rule = _inputs(case, cuda)
    before = kernels.rec_setup.launches
    got = kernels.rec_setup(fields, idx, w, h, rule)
    torch.cuda.synchronize()
    _assert_same(got, setup.rec_setup_plain(fields, idx, w, h, rule))
    binned = got[0].shape[0] > 0
    assert binned == (CASES[case][-1] != "empty")
    assert kernels.rec_setup.launches - before == kernels.rec_setup_launches(
        fields.shape[0], w, h, binned)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("bad", [4096, -1, 2**31 - 1])
def test_chain_raises_on_an_index_out_of_range(cuda, dtype, bad):
    fields, idx, w, h, rule = _inputs("spike_batch_hw", cuda)
    idx = idx.to(dtype)
    idx[100, 1] = bad
    with pytest.raises(ValueError, match=r"indices must lie in \[0, 4096\)"):
        kernels.rec_setup(fields, idx, w, h, rule)


@pytest.mark.gpu
def test_chain_rejects_mixed_devices(cuda):
    fields, idx, w, h, rule = _inputs("spike_batch_hw", cuda)
    with pytest.raises(ValueError, match="indices is on cpu"):
        kernels.rec_setup(fields, idx.cpu(), w, h, rule)
