"""Twin of ``scripts/exp_fs_mosaic_ops.py``: every intermediate of the
shipped shader's chain at chosen pixels, the card's kernel against the
plain version on the CPU, to find the first op where the two part.

    python -m vulkan_forge_torch.lab.fs_chain [--device cuda|cpu]
    python -m vulkan_forge_torch.lab.fs_chain --from-scene NAME [--device cuda|cpu]

Without ``--from-scene`` it runs the script's two g-buffer pixels
(``PIXELS``) with the script's inputs (LUT "terrain", sun (0.35, 0.9, 0.2),
exposure 1.1, h_range 1.0) and prints, per pixel, each intermediate's value
and bits on the device (``vf_lab_fs_chain``, in ``vf::shade_shipped``'s op
order, and the word ``vf::shade_shipped`` returns) and on the CPU
(``_kernels.fs_chain_plain``, in ``fragment.terrain_fs``'s op order), with
``<-- DIFF`` where the bits differ. The chain departs from the script's in
one op: inv_len is ``1/sqrt`` (the kernels' and the plain shader's), where
the script takes ``lax.rsqrt``.

``--from-scene NAME`` renders one of ``SCENES`` on the device and on the
CPU, finds the colour bytes that differ, and dumps the chain at those
pixels (the first ``MAX_DUMPS`` in full; of the rest, the first row that
differs): the device side from the device's g-buffer and shading scalars,
the CPU side from the CPU's, the plain chain run over the whole frame
(torch's CPU results depend on where an element falls in a vectorised
loop, so the frame's shapes are kept) and gathered there. The first row
that differs is where the two images part; the last row must reproduce
each image's byte.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from .._raster import kernels
from . import _cli, _kernels
from ._kernels import CHAIN_NAMES

# scripts/exp_fs_mosaic_ops.py:22-25: (hh, xx, zz, diff_channel).
PIXELS = [
    (-0.02844862, -0.6119954, 0.84231335, 0),
    (0.029899813, -0.3251077, -0.9206853, 1),
]
PIXEL_LABELS = ("A", "B")
# scripts/exp_fs_mosaic_ops.py:36-42.
COLORMAP = "terrain"
SUN = (0.35, 0.9, 0.2)
EXPOSURE = 1.1
H_RANGE = 1.0
INPUT_NAMES = ("hh", "xx", "zz", "hr2", "exposure", "l0", "l1", "l2")
MAX_DUMPS = 8


def script_inputs(device):
    """(lut (256, 4) linear, lut_rgb (256, 3), par (5,)) of the script on
    ``device``; par by ``fragment.fs_scalars``'s ops on that device."""
    from .. import _colormap
    lut = torch.from_numpy(np.asarray(_colormap.build_lut(COLORMAP)[0], np.float32))
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    par = kernels.shading_params(f(H_RANGE), f(EXPOSURE), f(SUN))
    return lut.to(device), lut[:, :3].contiguous().to(device), par


def _bits(v) -> str:
    return hex(int(np.float32(v).view(np.uint32)))


def dump(label: str, sides, names=("dev", "cpu")) -> str | None:
    """Print one pixel's rows for two sides (each {row name: float32});
    returns the first row whose bits differ, or None."""
    first = None
    print(f"pixel {label}:")
    for row in sides[0]:
        a, b = np.float32(sides[0][row]), np.float32(sides[1][row])
        diff = a.view(np.uint32) != b.view(np.uint32)
        if row == "word":
            text = f"  {row:8s} {names[0]}={_bits(a)}  {names[1]}={_bits(b)}"
        else:
            text = (f"  {row:8s} {names[0]}={float(a):.9f} {_bits(a)}  "
                    f"{names[1]}={float(b):.9f} {_bits(b)}")
        print(text + ("  <-- DIFF" if diff else ""))
        if diff and first is None:
            first = row
    return first


def _rows(chain: np.ndarray, k: int, inputs: dict) -> dict:
    out = dict(inputs)
    out.update({n: chain[i, k] for i, n in enumerate(CHAIN_NAMES)})
    out["word"] = chain[len(CHAIN_NAMES), k]
    return out


def word_byte(word_bits, channel: int) -> int:
    return (int(np.float32(word_bits).view(np.uint32)) >> (8 * channel)) & 0xFF


def run_pixels(device) -> None:
    """The script's two pixels, device against CPU."""
    hh, xx, zz, ch = (np.array([p[i] for p in PIXELS], np.float32 if i < 3 else np.int32)
                      for i in range(4))
    _, lut_d, par_d = script_inputs(device)
    _, lut_c, par_c = script_inputs("cpu")
    t = lambda a, d: torch.from_numpy(a).to(d)
    got = _kernels.fs_chain(t(hh, device), t(xx, device), t(zz, device), t(ch, device),
                            lut_d, par_d).cpu().numpy()
    want = _kernels.fs_chain_plain(t(hh, "cpu"), t(xx, "cpu"), t(zz, "cpu"), t(ch, "cpu"),
                                   lut_c, par_c).numpy()
    for k, name in enumerate(PIXEL_LABELS):
        ins = lambda par: dict(zip(INPUT_NAMES, [hh[k], xx[k], zz[k], *par.cpu().numpy()]))
        dump(f"{name} ch{ch[k]}", [_rows(got, k, ins(par_d)), _rows(want, k, ins(par_c))],
             (device.type, "cpu"))


# ---------------- --from-scene ----------------

def _golden_height():
    """The golden Scene's height upload (tests/test_goldens.py:54-55)."""
    return (np.outer(np.sin(np.linspace(0, 3, 33)),
                     np.cos(np.linspace(0, 2, 45))) * 0.3).astype(np.float32)


def _spike(width, height, grid, colormap="viridis", camera=None, heights=None):
    def make(device):
        import vulkan_forge_torch as vt
        s = vt.TerrainSpike(width, height, grid, colormap, device=device)
        if camera is not None:
            s.set_camera_look_at(*camera)
        if heights is not None:
            s._heights = heights
        return s
    return make


def _scene_g32(device):
    import vulkan_forge_torch as vt
    s = vt.Scene(160, 120, 32, "magma", device=device)
    s.set_height_from_r32f(_golden_height())
    return s


# chip_smoke.py's and tests/test_torch_cuda.py's cuda-vs-cpu scenes with the
# shipped shader, and the close g256 frame whose card and CPU bytes differed
# when the vertex-stream route was first held to the CPU (a TerrainSpike
# with a seeded height texture, as tests/test_torch_cuda.py renders it).
SCENES = {
    "spike_800x600_g128": _spike(800, 600, 128),
    "spike_800x600_g1024": _spike(800, 600, 1024),
    "scene_magma_160x120_g32": _scene_g32,
    "spike_terrain_128x96_g16_cam": _spike(
        128, 96, 16, "terrain", ((2.0, 1.5, 2.5), (0, 0, 0), (0, 1, 0), 50.0, 0.1, 50.0)),
    "close_320x240_g256": _spike(
        320, 240, 256, "viridis", ((1.5, 0.9, 1.2), (0, 0, 0), (0, 1, 0), 50.0, 0.1, 50.0),
        np.random.default_rng(3).uniform(-0.4, 0.4, (33, 45)).astype(np.float32)),
}


def scene_gbuffer(obj, device):
    """The frame's g-buffer (v0, v1, v2 = h, x, z; mask), each (H, W), and
    its (lut_rgb, par), from the inputs the object renders, on ``device``
    through the vertex-stream route (every SCENES object takes it)."""
    from .._raster import pipeline, vtx
    g = obj._globals
    _, _, (xyuv, heights, views, projs, spacing, exaggeration, lut, exposure, sun_dir,
           h_min, h_max) = pipeline._frame_inputs(
        "shipped", "inclusive", device, obj._xyuv, obj._heights,
        np.asarray(obj._view)[None], np.asarray(obj._proj)[None], g.spacing, g.exaggeration,
        obj._lut, g.exposure, g.sun_dir, g.h_min, g.h_max)
    if not pipeline.use_vtx_route(obj.grid, xyuv.shape[0], int(np.prod(obj._indices.shape)) // 3):
        raise ValueError("the scene does not take the vertex-stream route")
    fields = vtx.vs_fields(xyuv, heights, views, projs, spacing, exaggeration,
                           obj.width, obj.height)
    v0, v1, v2, mask = vtx.render_gbuffer_vtx_batch(fields, obj.grid, obj.width, obj.height)
    par = kernels.shading_params(h_max - h_min, exposure, sun_dir)
    return (v0[0], v1[0], v2[0], mask[0]), lut[:, :3].contiguous(), par


def from_scene(name: str, device) -> dict:
    """Card (``device``) against CPU bytes of scene ``name``; the chain at
    the differing bytes. Returns the summary it prints last."""
    if name not in SCENES:
        raise ValueError(f"scene must be one of {sorted(SCENES)}, got {name!r}")
    obj_d, obj_c = SCENES[name](device), SCENES[name]("cpu")
    img_d, img_c = obj_d.render_rgba(), obj_c.render_rgba()
    delta = np.abs(img_d.astype(np.int16) - img_c.astype(np.int16))[..., :3]
    ys, xs, cs = np.nonzero(delta)
    summary = {"scene": name, "device": device.type, "bytes": int(delta.size),
               "differ": int(ys.size), "max_delta": int(delta.max()),
               "first_divergence": {}, "reproduces_images": True}
    print(f"scene {name}: {ys.size} of {delta.size} colour bytes differ between "
          f"{device.type} and cpu, max delta {summary['max_delta']}")
    if ys.size:
        gb_d, lut_d, par_d = scene_gbuffer(obj_d, device)
        gb_c, lut_c, par_c = scene_gbuffer(obj_c, "cpu")
        pick = lambda a: a.cpu().numpy()[ys, xs]
        in_d = [pick(a) for a in gb_d[:3]]
        in_c = [pick(a) for a in gb_c[:3]]
        ch = cs.astype(np.int32)
        t = lambda a, d: torch.from_numpy(np.ascontiguousarray(a)).to(d)
        got = _kernels.fs_chain(*(t(a, device) for a in in_d), t(ch, device), lut_d,
                                par_d).cpu().numpy()
        # The plain chain over the whole CPU frame, one run per channel.
        flat = [a.reshape(-1).contiguous() for a in gb_c[:3]]
        whole = {c: _kernels.fs_chain_plain(
            *flat, torch.full_like(flat[0], c, dtype=torch.int32), lut_c, par_c).numpy()
            for c in sorted(set(cs.tolist()))}
        idx = ys * obj_c.width + xs
        want = np.stack([whole[c][:, i] for c, i in zip(cs, idx)], axis=1)
        counts = collections.Counter()
        for k in range(ys.size):
            rows_d = _rows(got, k, dict(zip(INPUT_NAMES, [a[k] for a in in_d]
                                            + list(par_d.cpu().numpy()))))
            rows_c = _rows(want, k, dict(zip(INPUT_NAMES, [a[k] for a in in_c]
                                             + list(par_c.cpu().numpy()))))
            label = f"({xs[k]}, {ys[k]}) ch{cs[k]}"
            if k < MAX_DUMPS:
                first = dump(label, [rows_d, rows_c], (device.type, "cpu"))
            else:
                first = next((r for r in rows_d if np.float32(rows_d[r]).view(np.uint32)
                              != np.float32(rows_c[r]).view(np.uint32)), None)
            counts[first or "none"] += 1
            same = (word_byte(rows_d["word"], cs[k]) == img_d[ys[k], xs[k], cs[k]]
                    and word_byte(rows_c["word"], cs[k]) == img_c[ys[k], xs[k], cs[k]])
            summary["reproduces_images"] &= bool(same)
        summary["first_divergence"] = dict(counts)
        summary["gbuffer_equal_at_pixels"] = all(
            np.array_equal(a.view(np.uint32), b.view(np.uint32)) for a, b in zip(in_d, in_c))
    print("summary:", summary)
    return summary


def main(argv=None) -> int:
    def extra(ap):
        ap.add_argument("--from-scene", choices=sorted(SCENES), default=None,
                        help="dump the chain where this scene's device and CPU bytes differ")
    args, device = _cli.parse(__doc__.splitlines()[0], argv, extra)
    print(_cli.header(device))
    if args.from_scene:
        s = from_scene(args.from_scene, device)
        return 0 if s["reproduces_images"] else 1
    run_pixels(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
