"""The hardware fill rule (``VF_FILL_RULE=hw``) of the PyTorch port against
``vulkan_forge`` and the int64 fixed-point oracle (CPU).

Setup is compared on identical clip coordinates (the JAX vertex stage's
output, as tests/test_torch_setup.py does). Tolerances:
- bboxes, valid flags, the edge thresholds (columns 31..33) and the snapped
  positions (columns 0, 1, 4, 5, 8, 9): exact;
- all other record columns: |d| <= 1e-5 * max(1, |x|), as
  tests/test_torch_setup.py states;
- coverage: equal to ``hw_oracle``'s, bit for bit (both the port's copy
  and the original), and to the JAX jnp raster's;
- images: the FS policy (every differing byte off by 1, on at most 1e-4 of
  the bytes), with the port's CPU bytes pinned below.
"""
import functools
import hashlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vulkan_forge as vf
from vulkan_forge._raster import hw_oracle as jhw, setup as jsetup, tiles as jtiles

import vulkan_forge_torch as vt
from vulkan_forge_torch import _camera as tcam, _mesh as tmesh
from vulkan_forge_torch._parity import assert_fs_policy, assert_gbuffer_close
from vulkan_forge_torch._raster import (hw_oracle as thw, kernels, packed, pipeline as tpipe,
                                        setup as tsetup, tiles as ttiles, vtx)

from test_torch_setup import RTOL, _jax_vs, _scene
from test_torch_slice import _render as _render_slice

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)

POS_COLS = [0, 1, 4, 5, 8, 9]
EXACT_COLS = POS_COLS + [24, 31, 32, 33]


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_setup_hw(clip, vary, idx, W, H):
    x, y, z, w = jsetup.clip_to_fb(clip, W, H)
    return jsetup.triangle_setup(x, y, z, w, vary, idx, W, H, fill_rule="hw")


@pytest.mark.parametrize("case", ["golden_cam_g16_128x96", "heights_g32_160x120",
                                  "near_cross_g48_160x120", "w_cross_g12_160x120"])
def test_hw_records_match_reference(case):
    xyuv, idx, heights, view, proj, W, H = _scene(case)
    clip, vary = _jax_vs(xyuv, heights, view, proj)
    recs_j, bbox_j = (np.asarray(a) for a in _jax_setup_hw(
        jnp.asarray(clip), jnp.asarray(vary), jnp.asarray(idx.astype(np.int32)), W, H))
    x, y, z, w = tsetup.clip_to_fb(torch.from_numpy(clip.copy()), W, H)
    recs_t, bbox_t = tsetup.triangle_setup(x, y, z, w, torch.from_numpy(vary.copy()),
                                           torch.from_numpy(idx), W, H, fill_rule="hw")
    recs_t, bbox_t = recs_t.numpy(), bbox_t.numpy()
    assert recs_t.shape == recs_j.shape and bbox_t.dtype == np.int32
    np.testing.assert_array_equal(bbox_t, bbox_j)
    np.testing.assert_array_equal(recs_t[:, EXACT_COLS], recs_j[:, EXACT_COLS])
    rest = [k for k in range(31) if k not in EXACT_COLS]
    d = np.abs(recs_t[:, rest].astype(np.float64) - recs_j[:, rest])
    assert np.all(d <= RTOL * np.maximum(1.0, np.abs(recs_j[:, rest]))), d.max()
    assert not np.any(recs_t[:, tsetup.HW_COLS:]) and not np.any(recs_t[-1])
    # Thresholds are 0 (top-left edge, or a w-crossing triangle) or 2^-16,
    # and the valid triangles' positions lie on the 8.8 lattice.
    valid = recs_t[:-1, 24] > 0
    bias = recs_t[:-1, 31:34][valid]
    assert set(np.unique(bias).tolist()) == {0.0, 2.0 ** -16}
    pos = recs_t[:-1, POS_COLS][valid].astype(np.float64) * 256.0
    small = np.abs(pos) < 2.0 ** 23
    np.testing.assert_array_equal(pos[small], np.round(pos[small]))
    if case.startswith("w_cross"):
        # The w-crossing triangles (full-screen bboxes) keep bias 0.
        full = np.all(bbox_t == [0, W - 1, 0, H - 1], axis=1)
        assert np.any(valid & full) and not np.any(recs_t[:-1, 31:34][valid & full])


def _plain(clip, vary, indices, W, H, fill_rule="hw"):
    """The port's plain record route: setup, binning, tiles.render_gbuffer."""
    x, y, z, w = tsetup.clip_to_fb(torch.as_tensor(np.asarray(clip, np.float32)), W, H)
    recs, bbox = tsetup.triangle_setup(
        x, y, z, w, torch.as_tensor(np.asarray(vary, np.float32)),
        torch.as_tensor(np.asarray(indices).reshape(-1, 3), dtype=torch.long), W, H, fill_rule)
    return [p[0] for p in ttiles.render_gbuffer(recs, tsetup.bin_tiles(bbox, W, H), 1, W, H)]


def _jax_plain(clip, vary, indices, W, H, fill_rule="hw"):
    """vulkan_forge's jnp raster of the same scene (tests/test_packed.py:45-56)."""
    with jax.default_device(jax.devices("cpu")[0]):
        x, y, z, w = jsetup.clip_to_fb(jnp.asarray(clip, jnp.float32), W, H)
        recs, bbox = jsetup.triangle_setup(x, y, z, w, jnp.asarray(vary, jnp.float32),
                                           jnp.asarray(np.asarray(indices, np.int32)
                                                       .reshape(-1, 3)), W, H,
                                           fill_rule=fill_rule)
        cap = int(jsetup.tile_counts(bbox, W, H).max())
        sx, sy = jsetup.tile_span_max(bbox, W, H)
        lists = jsetup.bin_triangles(bbox, W, H, max(cap, 8), span_x=int(sx),
                                     span_y=int(sy)).tile_lists
        return [np.asarray(p) for p in jtiles.render_gbuffer(recs, lists, W, H,
                                                             fill_rule=fill_rule)]


def _grid16_scene():
    """The grid-16 160x120 scene of tests/test_packed.py:261-283."""
    W, H = 160, 120
    xyuv, idx = tmesh.build_grid_xyuv(16)
    x, z = xyuv[:, 0], xyuv[:, 1]
    h = np.sin(x * 1.3) * 0.25 + np.cos(z * 1.1) * 0.25
    view = tcam.look_at_rh((3.0, 2.0, 3.0), (0, 0, 0), (0, 1, 0))
    proj = tcam.perspective_wgpu(np.float32(math.radians(45.0)), np.float32(W / H),
                                 np.float32(0.1), np.float32(100.0))
    clip = (np.stack([x, h, z, np.ones_like(x)], axis=-1) @ view.T) @ proj.T
    return clip, np.stack([h, x, z], axis=-1), idx.astype(np.int32).reshape(-1, 3), W, H


def test_hw_coverage_equals_fixed_point_oracle():
    clip, vary, indices, W, H = _grid16_scene()
    wid_t, attr_t = thw.rasterize_hw(clip, vary, indices, W, H)
    wid_j, attr_j = jhw.rasterize_hw(clip, vary, indices, W, H)
    np.testing.assert_array_equal(wid_t, wid_j)
    np.testing.assert_array_equal(attr_t, attr_j)
    got = _plain(clip, vary, indices, W, H)
    np.testing.assert_array_equal(got[3].numpy(), wid_t >= 0)
    assert_gbuffer_close(got, _jax_plain(clip, vary, indices, W, H), "grid-16 hw vs jnp")
    # The inclusive rule covers shared-edge pixels twice; the mesh's
    # silhouette is the same.
    incl = _plain(clip, vary, indices, W, H, "inclusive")[3]
    assert (incl >= got[3]).all() and incl.sum() >= got[3].sum()


def _coverage_counts(clip, vary, indices, W, H, fill_rule):
    return sum(_plain(clip, vary, tri[None], W, H, fill_rule)[3].to(torch.int32)
               for tri in indices)


def test_hw_shared_diagonal_single_owner():
    """tests/test_packed.py:286-317: two triangles sharing a diagonal through
    pixel centres. Under hw each tie pixel has one owner; the union is the
    inclusive union."""
    W, H = 64, 64
    pos = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]], np.float32)
    clip = np.concatenate([pos, np.zeros((4, 1), np.float32), np.ones((4, 1), np.float32)], 1)
    vary = np.eye(4, 3, dtype=np.float32)
    indices = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    masks = {rule: _plain(clip, vary, indices, W, H, rule)[3] for rule in ("inclusive", "hw")}
    assert torch.equal(masks["hw"], masks["inclusive"])
    np.testing.assert_array_equal(masks["hw"].numpy(),
                                  _jax_plain(clip, vary, indices, W, H)[3])
    counts = {rule: _coverage_counts(clip, vary, indices, W, H, rule)
              for rule in ("inclusive", "hw")}
    assert int(counts["inclusive"].max()) == 2          # the diagonal ties
    assert int(counts["hw"].max()) == 1
    assert torch.equal(counts["hw"] > 0, masks["hw"])


def test_hw_watertight_quad():
    """tests/test_fillrule.py:51-79 on the port's raster: a quad whose
    shared diagonal runs through pixel centres; every interior pixel is
    covered exactly once, as the oracle covers it."""
    W, H = 128, 96

    def ndc(px, py):
        return (2 * (px + 0.5) / W - 1, 1 - 2 * (py + 0.5) / H)

    quad = [ndc(10, 10), ndc(70, 10), ndc(70, 70), ndc(10, 70)]
    clip = np.array([[x, y, 0.5, 1.0] for x, y in quad])
    vary = np.ones((4, 3))
    indices = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    count = _coverage_counts(clip, vary, indices, W, H, "hw")
    assert int(count.max()) <= 1, "double coverage: fill rule not watertight"
    assert bool((count[12:69, 12:69] == 1).all()), "crack inside the quad"
    mask = _plain(clip, vary, indices, W, H)[3]
    assert torch.equal(mask, count == 1)
    wid, _ = thw.rasterize_hw(clip, vary, indices, W, H)
    np.testing.assert_array_equal(mask.numpy(), wid >= 0)


# ---------------- the public API under VF_FILL_RULE=hw ----------------

# The port's CPU SHA-256 of raw RGBA bytes under VF_FILL_RULE=hw.
HW_GOLDEN_CPU = {
    "triangle_97x61": "8a07837525ce73594a1502a885dbd6349b64c8c7d80a6d1ad49c4ac97b709ba2",
    "scene_viridis_160x120_g32": "a3807dfccdd09d93228dae6938ae5a0d4a9c006345bd4eb453a6d66cd4313daa",
    "spike_terrain_128x96_g16_cam": "6f4f79ec8770f7a314dc436c2d44cb11661ee268ea9fef0dfe9e83ceb9677836",
    "renderer_extended_96x96": "2a15a1a8dc57bad0fa0dd27a231d04a7d27b7a5541010cccd0ae0c2e5a3bb52c",
}


def _scene_height():
    """The height of tests/test_raster_core.py:113-114."""
    return (np.outer(np.sin(np.linspace(0, 2, 32)),
                     np.cos(np.linspace(0, 3, 32)))).astype(np.float32)


def _render(mod, name, **dev):
    if name == "scene_viridis_160x120_g32":
        s = mod.Scene(160, 120, 32, "viridis", **dev)
        s.set_height_from_r32f(_scene_height())
        return s.render_rgba()
    return _render_slice(mod, name, **dev)


@pytest.mark.parametrize("name", sorted(HW_GOLDEN_CPU))
def test_hw_public_api_matches_reference(name, monkeypatch):
    monkeypatch.setenv("VF_FILL_RULE", "hw")
    got = _render(vt, name, device="cpu")
    assert got.dtype == np.uint8 and got.shape[2] == 4
    assert hashlib.sha256(got.tobytes()).hexdigest() == HW_GOLDEN_CPU[name]
    assert_fs_policy(got, _render(vf, name), f"{name} under hw")


def test_hw_scene_differs_from_inclusive(monkeypatch):
    """tests/test_raster_core.py:129-135: the rule changes the image."""
    monkeypatch.setenv("VF_FILL_RULE", "hw")
    hw = _render(vt, "scene_viridis_160x120_g32", device="cpu")
    monkeypatch.setenv("VF_FILL_RULE", "inclusive")
    inclusive = _render(vt, "scene_viridis_160x120_g32", device="cpu")
    assert not np.array_equal(hw, inclusive)
    monkeypatch.setenv("VF_FILL_RULE", "nonsense")        # means "inclusive"
    np.testing.assert_array_equal(_render(vt, "scene_viridis_160x120_g32", device="cpu"),
                                  inclusive)


def test_fill_rule_from_env(monkeypatch):
    monkeypatch.delenv("VF_FILL_RULE", raising=False)
    assert tpipe.fill_rule_from_env() == "inclusive"
    for value, want in (("hw", "hw"), ("inclusive", "inclusive"), ("HW", "inclusive"),
                        ("", "inclusive")):
        monkeypatch.setenv("VF_FILL_RULE", value)
        assert tpipe.fill_rule_from_env() == want
    with pytest.raises(ValueError, match="fill_rule"):
        tsetup.check_fill_rule("top-left")


def _forbid(monkeypatch, module, name, hits):
    def spy(*a, **k):
        hits.append(name)
        raise AssertionError(f"{name} must not run under the hw rule")
    monkeypatch.setattr(module, name, spy)


def _record(monkeypatch, name, calls):
    real = getattr(kernels, name)
    monkeypatch.setattr(kernels, name, lambda *a, **k: calls.append(name) or real(*a, **k))


def test_hw_routes_every_frame_to_records(monkeypatch):
    """Under hw a grid mesh (with grid_n), the extended shader on a grid
    and a Renderer frame never reach the vtx or indexed routes, whose
    in-register setup has no thresholds (cf. tests/test_fillrule.py:153-213):
    each is set up by the record route's ``rec_setup`` (after the vertex
    stage every route shares) and drawn by its hw kernels."""
    hits, calls = [], []
    for name in ("render_image_vtx_batch", "render_gbuffer_vtx_batch"):
        _forbid(monkeypatch, vtx, name, hits)
    _forbid(monkeypatch, packed, "render_gbuffer_packed_batch", hits)
    for name in ("rec_setup", "raster_gbuffer_hw", "raster_shade_shipped_hw"):
        _record(monkeypatch, name, calls)
    monkeypatch.setenv("VF_FILL_RULE", "hw")

    vt.Scene(48, 32, 8, "terrain", device="cpu").render_rgba()
    s = vt.make_terrain(48, 32, 8, device="cpu")
    g = s._globals
    img = tpipe.render_terrain_u8(
        s._xyuv, s._indices, s._heights, s._view, s._proj, spacing=g.spacing,
        exaggeration=g.exaggeration, h_min=g.h_min, h_max=g.h_max, exposure=g.exposure,
        sun_dir=g.sun_dir, lut=s._lut, width=48, height=32, fs_mode="extended",
        grid_n=8, device="cpu")
    r = vt.Renderer(48, 32, device="cpu")
    r.add_terrain((np.arange(60, dtype=np.float32).reshape(6, 10) * 3.0), (10.0, 10.0))
    r.upload_height_r32f()
    frame = r.render_rgba()
    assert hits == [] and img.shape == frame.shape == (32, 48, 4)
    assert calls == ["rec_setup", "raster_shade_shipped_hw", "rec_setup", "raster_gbuffer_hw",
                     "rec_setup", "raster_gbuffer_hw"]


def test_batch_entry_ignores_fill_rule_env(monkeypatch):
    """render_terrain_batch_u32 takes its rule from fill_rule=, never from
    VF_FILL_RULE (the reference's batched entries take none): with grid_n
    it keeps the vtx route under the variable."""
    xyuv, idx = tmesh.build_grid_xyuv(12)
    s = vt.make_terrain(64, 48, 12, device="cpu")
    g = s._globals
    views, projs = np.stack([s._view, s._view]), np.stack([s._proj, s._proj])
    args = dict(spacing=g.spacing, exaggeration=g.exaggeration, h_min=g.h_min, h_max=g.h_max,
                exposure=g.exposure, sun_dir=g.sun_dir, lut=s._lut, width=64, height=48,
                grid_n=12, device="cpu")
    heights = np.zeros((1, 1), np.float32)
    want = tpipe.render_terrain_batch_u32(xyuv, idx, heights, views, projs, **args)
    monkeypatch.setenv("VF_FILL_RULE", "hw")
    routes = []
    real = vtx.render_image_vtx_batch
    monkeypatch.setattr(vtx, "render_image_vtx_batch",
                        lambda *a, **k: routes.append("vtx") or real(*a, **k))
    got = tpipe.render_terrain_batch_u32(xyuv, idx, heights, views, projs, **args)
    assert routes == ["vtx"] and torch.equal(got, want)
    hw = tpipe.render_terrain_batch_u32(xyuv, idx, heights, views, projs,
                                        fill_rule="hw", **args)
    assert routes == ["vtx"] and not torch.equal(hw, want)
    with pytest.raises(ValueError, match="fill_rule"):
        tpipe.render_terrain_batch_u32(xyuv, idx, heights, views, projs,
                                       fill_rule="top-left", **args)
