"""The segment walk's set-up (``kernels.seg_setup``: the ``vf_seg_setup_*``
kernels of csrc/segments.cu) against its plain version,
``segments.setup_frame_plain``.

On the CPU the wrapper runs the plain version and launches nothing; the
cases below are checked to be what they are named (the walk axis each
camera picks, a near-plane cut, a frame with no valid triangle), and the
wrapper's input checks refuse what the kernels do not take. The ``gpu``
tests hold the kernels to the plain version on the same CUDA tensors: the
compacted records (bit for bit), ids and bboxes, all seven
``SegmentBinning`` tables and the axis choice, byte-equal, and count the
launches (``python3 -m pytest -m gpu tests/test_torch_seg_setup.py``).
This file imports no jax.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera, _mesh, _renderer
from vulkan_forge_torch._raster import kernels, pipeline, segments, setup, vtx

torch.set_num_threads(1)

W, H = 256, 4352                 # tall: the segment route's frames
DEM_N = 129                      # a 129^2 DEM: 32,768 triangles, rows of 256
DEM_ROW = 2 * (DEM_N - 1)

# name -> (mesh, eye as a share of the terrain's extent (renderer) or in
# world units (spike), near plane as a share of the eye's distance (renderer)
# or in world units (spike), row_size ("grid": the mesh's rows, "T": one row,
# or a number), what the case must show).
CASES = {
    "renderer_columns": ("renderer", (-0.9, 0.9, 0.0), 1e-3, "grid", "columns"),
    "renderer_rows": ("renderer", (0.0, 0.9, -0.9), 1e-3, "grid", "rows"),
    "renderer_near_cut": ("renderer", (-0.3, 0.25, -0.2), 0.5, "grid", "near_cut"),
    "renderer_one_row": ("renderer", (-0.9, 0.9, 0.0), 1e-3, "T", "rows"),
    "renderer_ragged_rows": ("renderer", (-0.9, 0.9, 0.0), 1e-3, DEM_ROW + 1, "rows"),
    "renderer_nothing_seen": ("renderer", (0.0, -2.0, 0.0), 1e-3, "grid", "empty"),
    "spike_rows": ("spike", (0.4, 1.6, 3.5), 0.1, "grid", "rows"),
    "spike_columns": ("spike", (3.5, 1.6, 0.4), 0.1, "grid", "columns"),
}


def _dem(n, seed):
    rng = np.random.default_rng(seed)
    x = np.linspace(-3.0, 3.0, n, dtype=np.float32)
    h = 400.0 * np.exp(-(x[None] ** 2 + x[:, None] ** 2) / 2) + rng.normal(0.0, 20.0, (n, n))
    return h.astype(np.float32)


def _t(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _cameras(eye, near, far, target=(0.0, 0.0, 0.0)):
    up = (0.0, 1.0, 0.0) if abs(eye[0] - target[0]) + abs(eye[2] - target[2]) > 0 \
        else (0.0, 0.0, 1.0)
    view = _camera.look_at_rh(eye, target, up)
    proj = _camera.perspective_wgpu(np.float32(math.radians(45.0)), np.float32(W / H),
                                    np.float32(near), np.float32(far))
    return view[None], proj[None]


def _inputs(case, device):
    """(fields, indices, grid_n, row_size) of a case's frame on ``device``."""
    mesh, eye, near, rows, _ = CASES[case]
    if mesh == "renderer":
        r = vt.Renderer(W, H, device=device)
        r.add_terrain(_dem(DEM_N, 5), (30.0, 30.0), 1.5, "terrain")
        r.upload_height_r32f()
        terr = r._terrain
        xyuv, tris = _renderer.grid_mesh(terr.width, terr.height, *terr.spacing, device)
        extent = (DEM_N - 1) * 30.0
        e = tuple(extent * c for c in eye)
        dist = math.sqrt(sum(c * c for c in e))
        view, proj = _cameras(e, dist * near, dist * 10.0 + 10.0)
        fields = vtx.vs_fields(xyuv, r._height_tex, _t(view, device), _t(proj, device),
                               _t(1.0, device), _t(1.0, device), W, H, "extended")
        idx, grid, T = tris, None, tris.shape[0]
    else:
        grid = 64
        xyuv, _ = _mesh.build_grid_xyuv(grid)
        view, proj = _cameras(eye, near, 100.0)
        fields = vtx.vs_fields(_t(xyuv, device), _t(np.zeros((1, 1)), device),
                               _t(view, device), _t(proj, device), _t(1.0, device),
                               _t(1.0, device), W, H)
        idx, T = None, vtx.n_triangles(grid)
    row_size = {"grid": 2 * ((DEM_N if mesh == "renderer" else grid) - 1), "T": T}.get(rows, rows)
    return fields, idx, grid, row_size


def _launches(n_tris, row_size, valid):
    """The kernels seg_setup launches: the bbox, per walk axis the init and
    the prefix and four more over a non-empty stream, the compaction where
    a triangle is valid."""
    walks = segments.walk_streams(n_tris, row_size)
    return (n_tris > 0) + sum(2 + 4 * (w.length > 0) for w in walks) + (valid > 0)


def _assert_same(got, want):
    names = ("records", "ids", "bbox")
    for name, a, b in zip(names, got[:3], want[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name
    for name in segments.SegmentBinning._fields:
        a, b = getattr(got[3], name), getattr(want[3], name)
        assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert got[4] is want[4]


# ---------------- on the CPU ----------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_setup_wrapper_takes_cpu_tensors_to_plain(case):
    fields, idx, grid, rs = _inputs(case, "cpu")
    before = kernels.seg_setup.launches
    got = kernels.seg_setup(fields, idx, grid, W, H, rs)
    assert kernels.seg_setup.launches == before
    _assert_same(got, segments.setup_frame_plain(fields, idx, grid, W, H, rs))
    records, _, _, binning, columns = got
    what = CASES[case][4]
    if what in ("columns", "rows"):
        assert columns == (what == "columns")
    assert (records.shape[0] == 0) == (what == "empty")
    assert int(binning.counts_est.sum()) > 0 or what == "empty"
    if what == "near_cut":
        f = [fields[:, k] for k in range(vtx.FIELDS)]
        corners = setup.indexed_corners(f, idx)
        *_, valid = setup.setup_fields_core(*corners, W, H)
        assert int(setup.near_cut(*corners, valid).sum()) > 0


@pytest.mark.parametrize("n_tris, row_size, want", [
    (24, 6, [(24, 6, 0, 0, False), (24, 8, 4, 3, True)]),
    (24, 24, [(24, 24, 0, 0, False)]),
    (24, 5, [(24, 5, 0, 0, False)]),
    (24, 1, [(24, 1, 0, 0, False), (0, 48, 24, 0, True)]),
    (0, 4, [(0, 4, 0, 0, False)]),
])
def test_walk_streams_are_the_reference_rule(n_tris, row_size, want):
    walks = segments.walk_streams(n_tris, row_size)
    assert [tuple(w) for w in walks] == want
    for w in walks[1:]:
        assert segments.column_major_perm(w.cells_rows, w.cells_cols).numel() == w.length


@pytest.mark.parametrize("estimates, want", [([5], 0), ([5, 5], 0), ([5, 4], 1), ([4, 5], 0)])
def test_cheaper_walk_keeps_rows_on_a_tie(estimates, want):
    assert segments.cheaper_walk(estimates) == want


def test_segment_frame_goes_through_the_set_up(monkeypatch):
    fields, idx, grid, rs = _inputs("spike_columns", "cpu")
    seen = []
    real = kernels.seg_setup
    monkeypatch.setattr(kernels, "seg_setup", lambda *a: seen.append(a[1:]) or real(*a))
    frame = pipeline.segment_frame(fields, _mesh.build_grid_xyuv(grid)[1], grid, W, H)
    assert seen == [(None, grid, W, H, rs)] and len(frame) == 4


def _bad(case):
    fields, idx, grid, rs = _inputs("renderer_rows", "cpu")
    args = dict(fields=fields, indices=idx, grid_n=None, width=W, height=H, row_size=rs)
    change = {
        "fields_dtype": dict(fields=fields.double()),
        "fields_shape": dict(fields=fields[0]),
        "fields_frames": dict(fields=torch.cat([fields, fields])),
        "fields_strided": dict(fields=fields.transpose(1, 2).contiguous().transpose(1, 2)),
        "indices_dtype": dict(indices=idx.long()),
        "indices_shape": dict(indices=idx.reshape(-1)),
        "indices_device": dict(indices=torch.empty(idx.shape, dtype=torch.int32,
                                                   device="meta")),
        "both_meshes": dict(grid_n=DEM_N),
        "no_mesh": dict(indices=None),
        "grid_not_the_mesh": dict(indices=None, grid_n=DEM_N + 1),
        "row_size": dict(row_size=0),
        "frame": dict(width=0),
    }[case]
    return {**args, **change}


BAD = {"fields_dtype": "fields must be", "fields_shape": "fields must be",
       "fields_frames": "one frame", "fields_strided": "fields must be",
       "indices_dtype": "indices must be", "indices_shape": "indices must be",
       "indices_device": "indices is on meta", "both_meshes": "exactly one",
       "no_mesh": "exactly one", "grid_not_the_mesh": "fields must be",
       "row_size": "row_size must be", "frame": "width and height"}


@pytest.mark.parametrize("case", sorted(BAD))
def test_setup_wrapper_rejects_bad_inputs(case):
    a = _bad(case)
    with pytest.raises(ValueError, match=BAD[case]):
        kernels.seg_setup(a["fields"], a["indices"], a["grid_n"], a["width"], a["height"],
                          a["row_size"])


def test_one_frame_stacks_without_a_copy():
    fields, idx, grid, rs = _inputs("spike_rows", "cpu")
    frame = kernels.seg_setup(fields, idx, grid, W, H, rs)[:4]
    records, ids, bbox, binning = segments.stack_frames([frame])
    assert records is frame[0] and ids is frame[1] and bbox is frame[2]
    for name in segments.SegmentBinning._fields:
        t = getattr(binning, name)
        assert t.is_contiguous() and torch.equal(t[0], getattr(frame[3], name))
        assert t.data_ptr() == getattr(frame[3], name).data_ptr()


# ---------------- on the card ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the set-up kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_setup_kernels_equal_plain_on_the_card(cuda, case):
    """Records (bits), ids, bboxes, the seven tables and the axis equal the
    plain version's on the same CUDA tensors; one launch per kernel."""
    fields, idx, grid, rs = _inputs(case, cuda)
    before = kernels.seg_setup.launches
    got = kernels.seg_setup(fields, idx, grid, W, H, rs)
    torch.cuda.synchronize()
    want = segments.setup_frame_plain(fields, idx, grid, W, H, rs)
    _assert_same(got, want)
    n_tris = idx.shape[0] if grid is None else vtx.n_triangles(grid)
    assert kernels.seg_setup.launches - before == _launches(n_tris, rs, got[0].shape[0])
    if CASES[case][4] in ("columns", "rows"):
        assert got[4] == (CASES[case][4] == "columns")


@pytest.mark.gpu
def test_setup_kernels_reject_mixed_devices(cuda):
    fields, idx, grid, rs = _inputs("renderer_rows", cuda)
    with pytest.raises(ValueError, match="indices is on cpu"):
        kernels.seg_setup(fields, idx.cpu(), None, W, H, rs)
