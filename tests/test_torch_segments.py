"""The port's segment-walk route (``_raster/segments.py``) against the JAX
package's K8 (``segments._seg_kernel``) and its tables (CPU).

On the CPU the segment wrappers run their plain PyTorch version, the
specification ``csrc/segments.cu`` is held to on the card
(test_torch_cuda.py). Records and bboxes are made in the JAX package and
carried across as numpy. Tolerances:
- the tables (``compact_valid``'s order, all five ``SegmentBinning``
  fields) and the walk-axis choice: exact;
- the plain walk against K8 itself (run in Pallas interpret mode): masks
  equal and varyings equal value for value, on the row-major and the
  column-major stream;
- tall frames through the public API: within the FS policy of
  ``vulkan_forge``'s frames (every differing byte off by 1, on at most
  1e-4 of the bytes), and byte-equal to the route the port took before.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import vulkan_forge as vf
from vulkan_forge import _camera as jcam, _mesh as jmesh
from vulkan_forge._raster import pipeline as jpipe, segments as jseg, transform as jtrans
from vulkan_forge._raster.setup import clip_to_fb as jclip_to_fb, triangle_setup as jsetup

import vulkan_forge_torch as vt
from vulkan_forge_torch import _convert
from vulkan_forge_torch._parity import assert_fs_policy
from vulkan_forge_torch._raster import (kernels, packed, pipeline as tpipe, segments as tseg,
                                        setup as tsetup, vtx)

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)

FIELDS = ("seg_lo", "seg_hi", "row_base", "r_bounds", "counts_est")


def _bbox(entries, T):
    """entries: dict id -> (px0, px1, py0, py1); the others invalid."""
    b = np.tile(np.array([10_000, -1, 10_000, -1], np.int32), (T, 1))
    for t, v in entries.items():
        b[t] = v
    return b


def _assert_tables_equal(port, ref):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


# ---------------- (a) tables, compaction and walk order ----------------

def test_segment_tables_basic():
    """tests/test_segments.py's basic case on both packages."""
    bbox = _bbox({0: (0, 10, 0, 3), 2: (130, 140, 0, 3), 5: (5, 6, 9, 12),
                  6: (100, 135, 9, 12)}, 8)
    sb = tseg.segment_bin(torch.from_numpy(bbox), width=256, height=16, row_size=4)
    _assert_tables_equal(sb, jseg.segment_bin(jnp.asarray(bbox), 256, 16, 4))
    assert sb.row_base.tolist() == [0, 2]
    assert sb.seg_lo.tolist() == [[0, 0], [1, 1]] and sb.seg_hi.tolist() == [[0, 1], [1, 1]]
    assert sb.r_bounds.tolist() == [[0, 1], [0, 1]]


def test_empty_scene_tables():
    bbox = _bbox({}, 8)
    sb = tseg.segment_bin(torch.from_numpy(bbox), width=256, height=16, row_size=4)
    _assert_tables_equal(sb, jseg.segment_bin(jnp.asarray(bbox), 256, 16, 4))
    assert bool((sb.r_bounds[0] > sb.r_bounds[1]).all())       # zero-trip walks
    assert int(sb.counts_est.abs().sum()) == 0


def test_compact_valid_order_preserving():
    T = 20
    bbox = _bbox({3: (0, 5, 0, 5), 7: (10, 20, 0, 5), 15: (30, 40, 0, 5)}, T)
    records = np.arange(T + 1, dtype=np.float32)[:, None] * np.ones((1, 40), np.float32)
    crec, ids, _ = tseg.compact_valid(torch.from_numpy(records), torch.from_numpy(bbox))
    _, src = jseg.compact_valid(jnp.asarray(records), jnp.asarray(bbox), cap=8)
    assert ids.dtype == torch.int32 and ids.tolist() == [3, 7, 15] == np.asarray(src)[:3].tolist()
    assert crec[:, 0].tolist() == [3.0, 7.0, 15.0] and crec.shape == (3, 40)
    # A permuted stream: each position takes its original row.
    perm = torch.arange(T - 1, -1, -1)
    crec, ids, _ = tseg.compact_valid(torch.from_numpy(records), torch.from_numpy(bbox)[perm],
                                      perm)
    assert ids.tolist() == [15, 7, 3] and crec[:, 0].tolist() == [15.0, 7.0, 3.0]


def _spike_frame(grid, W, H, eye):
    """The JAX spike terrain's records and bbox (test_raster_core.py:190-201)
    seen from ``eye``."""
    xyuv, idx = jmesh.build_grid_xyuv(grid)
    view = jnp.asarray(jcam.look_at_rh(eye, (0, 0, 0), (0, 1, 0)))
    proj = jnp.asarray(jcam.perspective_wgpu(np.float32(np.radians(45.0)), np.float32(W / H),
                                             np.float32(0.1), np.float32(100.0)))
    clip, vary = jtrans.terrain_vs(jnp.asarray(xyuv), jnp.zeros((1, 1), jnp.float32), view,
                                   proj, jnp.float32(1.0), jnp.float32(1.0))
    x, y, z, w = jclip_to_fb(clip, W, H)
    records, bbox = jsetup(x, y, z, w, vary, jnp.asarray(np.asarray(idx, np.int32).reshape(-1, 3)),
                           W, H)
    return np.array(records), np.array(bbox)


# Eyes along z and along x: mesh columns, then mesh rows, project near
# vertically, so each axis wins once.
AXIS_CASES = {"row_major": (0.4, 1.6, 3.5), "column_major": (3.5, 1.6, 0.4)}


@pytest.mark.parametrize("case", sorted(AXIS_CASES))
def test_tables_and_axis_choice_match_reference(case):
    grid, W, H = 24, 300, 200
    records, bbox = _spike_frame(grid, W, H, AXIS_CASES[case])
    T, rs = bbox.shape[0], 2 * (grid - 1)
    perm_j = jpipe._column_major_perm(grid - 1, grid - 1)
    perm = tseg.column_major_perm(grid - 1, grid - 1)
    np.testing.assert_array_equal(perm.numpy(), perm_j)
    est_r, est_c = (float(v) for v in jpipe._segment_axis_estimate(
        jnp.asarray(bbox), jnp.asarray(perm_j), W, H, rs, 2 * (grid - 1)))
    assert (est_c < est_r) == (case == "column_major"), "the scene must favour this axis"

    bbox_t = torch.from_numpy(bbox)
    walks = {"row_major": (None, bbox, rs), "column_major": (perm_j, bbox[perm_j], 2 * (grid - 1))}
    for name, (p, b, r) in walks.items():
        sb = tseg.segment_bin(torch.from_numpy(b), W, H, r)
        _assert_tables_equal(sb, jseg.segment_bin(jnp.asarray(b), W, H, r))
        assert tseg.segment_axis_estimate(sb) == (est_r if p is None else est_c)
        cap = jpipe._round_capacity(int((bbox[:, 1] >= bbox[:, 0]).sum()))
        crec_j, src = jseg.compact_valid(jnp.asarray(records), jnp.asarray(b), cap,
                                         ids=None if p is None else jnp.asarray(p))
        crec, ids, _ = tseg.compact_valid(torch.from_numpy(records), torch.from_numpy(b),
                                       None if p is None else torch.from_numpy(p))
        src = np.asarray(src)[:ids.numel()]
        np.testing.assert_array_equal(ids.numpy(), src if p is None else p[src])
        np.testing.assert_array_equal(crec[:, :31].numpy(), np.asarray(crec_j)[:ids.numel(), :31])

    perm_t, sb = tseg.walk_order(bbox_t, W, H, rs)
    assert (perm_t is not None) == (case == "column_major")
    want = walks[case]
    _assert_tables_equal(sb, jseg.segment_bin(jnp.asarray(want[1]), W, H, want[2]))
    # A row size that does not split the mesh into rows keeps the stream.
    assert tseg.walk_order(bbox_t, W, H, T)[0] is None
    assert tseg.walk_order(bbox_t, W, H, rs + 1)[0] is None


# ---------------- (b) the plain walk against K8 itself ----------------

@pytest.fixture(scope="module")
def k8_scene():
    """The grid-24 160x120 scene of test_raster_core.py:180-212 through
    JAX's render_gbuffer_segments with its pallas_call in interpret mode
    (K8 itself on the CPU), row-major and column-major; and the inputs."""
    grid, W, H = 24, 160, 120
    records, bbox = _spike_frame(grid, W, H, (3, 2, 3))
    perm = jpipe._column_major_perm(grid - 1, grid - 1)
    cap = jpipe._round_capacity(int((bbox[:, 1] >= bbox[:, 0]).sum()))
    walks = {"row_major": (None, bbox, 2 * (grid - 1)),
             "column_major": (perm, bbox[perm], 2 * (grid - 1))}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jseg.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        for name, (p, b, rs) in walks.items():
            crec, _ = jseg.compact_valid(jnp.asarray(records), jnp.asarray(b), cap,
                                         ids=None if p is None else jnp.asarray(p))
            sb = jseg.segment_bin(jnp.asarray(b), W, H, rs)
            out[name] = [np.asarray(a) for a in jseg.render_gbuffer_segments(crec, sb, W, H)]
    return records, walks, out, W, H


@pytest.mark.parametrize("budget", ["cpu", "cuda"])
@pytest.mark.parametrize("walk", ["row_major", "column_major"])
def test_plain_walk_matches_k8(k8_scene, walk, budget, monkeypatch):
    """In the host's steps and in the card's larger ones (more records per
    step), the plain walk is K8's g-buffer bit for bit."""
    monkeypatch.setitem(tseg._PLAIN_ELEMS, "cpu", tseg._PLAIN_ELEMS[budget])
    records, walks, out, W, H = k8_scene
    p, b, rs = walks[walk]
    b = torch.from_numpy(b)
    frame = tseg.stack_frames([(*tseg.compact_valid(torch.from_numpy(records), b,
                                                    None if p is None else torch.from_numpy(p)),
                                tseg.segment_bin(b, W, H, rs))])
    got = tseg.render_gbuffer_segments_batch(*frame, 1, W, H)
    want = out[walk]
    assert 0 < int(got[3].sum()) < W * H
    np.testing.assert_array_equal(got[3][0].numpy(), want[3])
    for a, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a[0].numpy(), w)


def test_ids_above_2_24_are_told_apart():
    """Two records cover the same pixels; their original ids, 2^24 + 1 and
    2^24, are one f32 value (the collision the reference's exact_ids split
    avoids). The int32 ids pick the higher, whichever comes first."""
    W, H = 32, 16
    clip = np.array([[-0.9, -0.9, 0.5, 1.0], [0.9, -0.9, 0.5, 1.0], [0.0, 0.9, 0.5, 1.0]],
                    np.float32)
    x, y, z, w = tsetup.clip_to_fb(torch.from_numpy(clip), W, H)
    vary = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                         [2.0, 0.0, 0.0], [2.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    xx, yy, zz, ww = (torch.cat([a, a]) for a in (x, y, z, w))
    records, bbox = tsetup.triangle_setup(xx, yy, zz, ww, vary,
                                          torch.tensor([[0, 1, 2], [3, 4, 5]]), W, H)
    assert np.float32(2**24) == np.float32(2**24 + 1)
    sb = tseg.segment_bin(bbox, W, H, 2)
    for hi in (0, 1):
        ids = torch.tensor([2**24 + 1 - hi, 2**24 + hi], dtype=torch.int32)
        v0, _, _, mask = tseg.render_gbuffer_segments_batch(
            *tseg.stack_frames([(records[:2], ids, bbox, sb)]), 1, W, H)
        assert int(mask.sum()) > 0
        assert set(v0[mask].tolist()) == {1.0 + hi}


def test_batch_of_frames_equals_single_frames(k8_scene):
    """Frames are independent: two walks of different orders and lengths
    stacked into one stream render each as alone."""
    records, walks, _, W, H = k8_scene
    frames = []
    for p, b, rs in walks.values():
        b = torch.from_numpy(b)
        if p is not None:
            b[: b.shape[0] // 3, 1] = -1                    # a shorter second stream
        frames.append((*tseg.compact_valid(torch.from_numpy(records), b,
                                           None if p is None else torch.from_numpy(p)),
                       tseg.segment_bin(b, W, H, rs)))
    both = tseg.render_gbuffer_segments_batch(*tseg.stack_frames(frames), 2, W, H)
    for k, f in enumerate(frames):
        one = tseg.render_gbuffer_segments_batch(*tseg.stack_frames([f]), 1, W, H)
        for x, y in zip(both, one):
            assert torch.equal(x[k], y[0])


def test_segment_wrappers_take_cpu_tensors_to_plain_and_check_inputs(k8_scene):
    records, walks, _, W, H = k8_scene
    _, b, rs = walks["row_major"]
    b = torch.from_numpy(b)
    rec, ids, bb, sb = tseg.stack_frames([(*tseg.compact_valid(torch.from_numpy(records), b),
                                       tseg.segment_bin(b, W, H, rs))])
    before = (kernels.seg_gbuffer.launches, kernels.seg_shade_shipped.launches)
    gbuf = kernels.seg_gbuffer(rec, ids, bb, sb, 1, W, H)
    for a, c in zip(gbuf, tseg.render_gbuffer_segments_plain(rec, ids, sb, 1, W, H)):
        assert torch.equal(a, c)
    shade = (torch.ones(256, 4), torch.tensor(1.0), torch.tensor(1.0), torch.tensor([0., 1., 0.]))
    assert torch.equal(kernels.seg_shade_shipped(rec, ids, bb, sb, 1, W, H, *shade),
                       tseg.render_image_segments_plain(rec, ids, sb, 1, W, H, *shade))
    assert (kernels.seg_gbuffer.launches, kernels.seg_shade_shipped.launches) == before
    with pytest.raises(ValueError, match="records"):
        kernels.seg_gbuffer(rec.double(), ids, bb, sb, 1, W, H)
    with pytest.raises(ValueError, match="ids"):
        kernels.seg_gbuffer(rec, ids.long(), bb, sb, 1, W, H)
    with pytest.raises(ValueError, match="ids must be original"):
        kernels.seg_gbuffer(rec, -ids - 1, bb, sb, 1, W, H)
    with pytest.raises(ValueError, match="binning.seg_lo"):
        kernels.seg_gbuffer(rec, ids, bb, sb._replace(seg_lo=sb.seg_lo[0]), 1, W, H)
    with pytest.raises(ValueError, match="binning.r_bounds"):
        kernels.seg_gbuffer(rec, ids, bb, sb, 1, W, H + 8)
    with pytest.raises(ValueError, match="lut"):
        kernels.seg_shade_shipped(rec, ids, bb, sb, 1, W, H, torch.ones(255, 4), *shade[1:])


# ---------------- (c) tall frames through the public API ----------------

TALL_W, TALL_H = 48, 4096


def _spy_routes(monkeypatch):
    """Record the segment kernels' wrappers; forbid the vtx, indexed and
    record routes."""
    calls = []
    for name in ("seg_gbuffer", "seg_shade_shipped"):
        real = getattr(kernels, name)
        monkeypatch.setattr(kernels, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))

    def forbid(module, name):
        def spy(*a, **k):
            raise AssertionError(f"a tall frame reached {name}")
        monkeypatch.setattr(module, name, spy)
    for name in ("render_image_vtx_batch", "render_gbuffer_vtx_batch"):
        forbid(vtx, name)
    forbid(packed, "render_gbuffer_packed_batch")
    for name in ("raster_gbuffer", "raster_shade_shipped", "raster_gbuffer_hw",
                 "raster_shade_shipped_hw"):
        forbid(kernels, name)
    return calls


def test_tall_spike_matches_reference(monkeypatch):
    """make_terrain(48, 4096, grid=128): T = 32,258 > 20,000 and H >= 4089,
    so the port walks segments as the JAX package's TPU route does; the
    frame is held to vulkan_forge's and equals the vtx route's bytes."""
    ref = vf.make_terrain(TALL_W, TALL_H, 128).render_rgba()
    s = vt.make_terrain(TALL_W, TALL_H, 128, device="cpu")
    vtx_route = tpipe.render_terrain_batch_u32(
        s._xyuv, s._indices, s._heights, s._view[None], s._proj[None], spacing=1.0,
        exaggeration=1.0, h_min=s._globals.h_min, h_max=s._globals.h_max,
        exposure=s._globals.exposure, sun_dir=s._globals.sun_dir, lut=s._lut, width=TALL_W,
        height=TALL_H, grid_n=128, device="cpu")[0]
    calls = _spy_routes(monkeypatch)
    got = s.render_rgba()
    assert calls == ["seg_shade_shipped"]
    assert got.shape == (TALL_H, TALL_W, 4) and 0.1 < (got[..., :3] != ref[0, 0, :3]).any(-1).mean()
    assert_fs_policy(got, ref, "tall spike vs vulkan_forge")
    np.testing.assert_array_equal(got.view(np.uint32)[..., 0], vtx_route.view(torch.int32).numpy()
                                  .view(np.uint32))


def test_tall_renderer_matches_reference(monkeypatch):
    """A Renderer(48, 4096) with a 128^2 DEM (T = 32,258): the extended
    shader over the segment walk's g-buffer, held to vulkan_forge's frame
    and equal to the indexed route's bytes."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:128, 0:128] / np.float32(128)
    dem = sum(rng.uniform(5, 30) * np.sin(2 * math.pi * (rng.uniform(1, 3) * x
                                                         + rng.uniform(1, 3) * y + rng.uniform()))
              for _ in range(5)).astype(np.float32)
    ref = vf.Renderer(TALL_W, TALL_H)
    ref.add_terrain(dem, (30.0, 30.0), 1.5, "terrain")
    ref.upload_height_r32f()
    ref.set_sun(35.0, 120.0)
    want = ref.render_rgba()
    r = _convert.renderer_from_reference(ref, device="cpu")
    calls = _spy_routes(monkeypatch)
    got = r.render_rgba()
    assert calls == ["seg_gbuffer"]
    assert_fs_policy(got, want, "tall Renderer vs vulkan_forge")
    monkeypatch.undo()
    np.testing.assert_array_equal(got, _indexed_frame(r))


def _indexed_frame(r):
    """The Renderer's frame through the indexed route (the batched entry)."""
    terr = r._terrain
    xyuv, tris = r._mesh
    view, proj = r._default_terrain_camera(terr)
    img = tpipe.render_terrain_batch_u32(
        xyuv, tris, r._height_tex, view[None], proj[None], spacing=1.0, exaggeration=1.0,
        normal_spacing=float(terr.spacing[0]), h_min=r._terrain_meta.h_min,
        h_max=r._terrain_meta.h_max, exposure=r._globals.exposure, sun_dir=r._globals.sun_dir,
        lut=vt._colormap.build_lut(terr.colormap)[0], width=r.width, height=r.height,
        fs_mode="extended", device="cpu")[0]
    return vt._formats.u32_image_to_rgba_u8(img).numpy()


# ---------------- (d) routing edges ----------------

@pytest.mark.parametrize("n_tris,height,rule,want", [
    (20_001, 4089, "inclusive", True), (20_001, 4088, "inclusive", False),
    (20_000, 4089, "inclusive", False), (20_001, 8192, "inclusive", True),
    (20_001, 4089, "hw", False), (2_093_058, 4320, "inclusive", True)])
def test_use_segment_route(n_tris, height, rule, want):
    assert tpipe.use_segment_route(n_tris, height, rule) is want


def _stub_routes(monkeypatch):
    """Replace both single-frame routes with stubs that record their call."""
    routes = []

    def seg(*a, height, width, **k):
        routes.append(("segments", k.get("row_size")))
        return torch.zeros((height, width), dtype=torch.uint32)

    def batch(*a, height, width, fill_rule, **k):
        routes.append(("batch", fill_rule))
        return torch.zeros((1, height, width), dtype=torch.uint32)
    monkeypatch.setattr(tpipe, "render_terrain_segments_u32", seg)
    monkeypatch.setattr(tpipe, "render_terrain_batch_u32", batch)
    return routes


@pytest.mark.parametrize("height,n_tris,rule,want", [
    (4088, 20_001, "inclusive", ("batch", "inclusive")),
    (4089, 20_001, "inclusive", ("segments", None)),
    (4089, 20_000, "inclusive", ("batch", "inclusive")),
    (4096, 20_001, "hw", ("batch", "hw"))])
def test_render_terrain_u8_routes_tall_frames(monkeypatch, height, n_tris, rule, want):
    """The single-frame entry takes the segment route exactly at the
    reference's edges; a hw frame keeps the batched entry (whose record
    route has the _hw kernels) with its rule."""
    routes = _stub_routes(monkeypatch)
    monkeypatch.setenv("VF_FILL_RULE", rule)
    s = vt.make_terrain(16, 16, 2, device="cpu")
    g = s._globals
    img = tpipe.render_terrain_u8(
        s._xyuv, np.zeros((n_tris, 3), np.int32), s._heights, s._view, s._proj,
        spacing=g.spacing, exaggeration=g.exaggeration, h_min=g.h_min, h_max=g.h_max,
        exposure=g.exposure, sun_dir=g.sun_dir, lut=s._lut, width=8, height=height,
        device="cpu")
    assert routes == [want] and img.shape == (height, 8, 4)


def test_grid_row_size_defaults_from_grid_n(monkeypatch):
    """A Scene/TerrainSpike names its grid; the walk reads its row stride,
    2 * (grid - 1), as vulkan_forge/_scene.py:100 passes it."""
    sizes = []
    real = tseg.walk_order
    monkeypatch.setattr(tseg, "walk_order",
                        lambda bbox, w, h, rs: sizes.append(rs) or real(bbox, w, h, rs))
    vt.make_terrain(8, 4096, 110, device="cpu").render_rgba()     # T = 23,762
    assert sizes == [2 * 109]


def test_hw_tall_frame_keeps_record_kernels(monkeypatch):
    """Under VF_FILL_RULE=hw a tall frame of more than 20,000 triangles
    takes the record route's _hw kernel, never the segment walk."""
    monkeypatch.setattr(tpipe, "SEGMENT_THRESHOLD", 10)
    calls = []
    for name in ("seg_gbuffer", "seg_shade_shipped"):
        monkeypatch.setattr(kernels, name, lambda *a, **k: calls.append("segment walk"))
    real = kernels.raster_shade_shipped_hw
    monkeypatch.setattr(kernels, "raster_shade_shipped_hw",
                        lambda *a, **k: calls.append("hw") or real(*a, **k))
    monkeypatch.setenv("VF_FILL_RULE", "hw")
    img = vt.make_terrain(8, 4096, 8, device="cpu").render_rgba()
    assert calls == ["hw"] and img.shape == (4096, 8, 4)


def test_batch_entry_never_walks_segments(monkeypatch):
    """render_terrain_batch_u32 keeps its routes at a tall frame above the
    threshold (the reference's batched entries never reach K8)."""
    monkeypatch.setattr(tpipe, "SEGMENT_THRESHOLD", 10)

    def forbid(*a, **k):
        raise AssertionError("the batched entry walked segments")
    monkeypatch.setattr(tseg, "render_image_segments_batch", forbid)
    monkeypatch.setattr(tseg, "render_gbuffer_segments_batch", forbid)
    s = vt.make_terrain(8, 4096, 8, device="cpu")
    g = s._globals
    img = tpipe.render_terrain_batch_u32(
        s._xyuv, s._indices, s._heights, s._view[None], s._proj[None], spacing=g.spacing,
        exaggeration=g.exaggeration, h_min=g.h_min, h_max=g.h_max, exposure=g.exposure,
        sun_dir=g.sun_dir, lut=s._lut, width=8, height=4096, grid_n=8, device="cpu")
    assert tuple(img.shape) == (1, 4096, 8)
    assert tpipe.use_segment_route(98, 4096, "inclusive")
