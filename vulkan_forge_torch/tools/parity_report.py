"""Fill-rule parity report on the port (twin of
``python/tools/parity_report.py``): the port's f32 raster under each fill
rule ("shipped": all edges inclusive; "hw": VF_FILL_RULE=hw, 8.8 snap +
top-left) against the fixed-point top-left hardware oracle
(``vulkan_forge_torch._raster.hw_oracle``).

The setup and raster run on ``--device``: on a card the record kernels
``vf_raster_gbuffer`` and ``vf_raster_gbuffer_hw``, on the CPU their plain
versions. Per config: differing-coverage pixel counts (all boundary) and
final-image channel deltas after identical fragment shading. Writes ONE
JSON artifact with the original's fields:
  {"configs": [{name, rule, covered_px, cov_diff_px, cov_diff_frac,
                interior_mismatch_px, max_lsb_delta_interior,
                max_lsb_delta_all, pct_pixels_within_1lsb}, ...],
   "all_interior_exact": bool, "hw_coverage_exact": bool}

    python -m vulkan_forge_torch.tools.parity_report --rules hw [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from vulkan_forge_torch import _colormap, _mesh
from vulkan_forge_torch._camera import look_at_rh, perspective_wgpu
from vulkan_forge_torch._device import resolve_device
from vulkan_forge_torch._raster import fragment, hw_oracle, kernels
from vulkan_forge_torch._raster.setup import REC_WIDTH, bin_tiles, clip_to_fb, triangle_setup


def _boundary(img):
    h, w = img.shape
    p = np.pad(img, 1, mode="edge")
    m = np.zeros(img.shape, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            m |= p[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx] != img
    return m


def spike_config(grid, width, height, eye=(3.0, 2.0, 3.0)):
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    x = xyuv[:, 0]
    z = xyuv[:, 1]
    h = np.sin(x * 1.3) * 0.25 + np.cos(z * 1.1) * 0.25
    view = look_at_rh(eye, (0, 0, 0), (0, 1, 0))
    proj = perspective_wgpu(np.float32(math.radians(45.0)),
                            np.float32(width / height),
                            np.float32(0.1), np.float32(100.0))
    world = np.stack([x, h, z, np.ones_like(x)], axis=-1)
    clip = (world @ view.T) @ proj.T
    varyings = np.stack([h, x, z], axis=-1)
    indices = idx.astype(np.int32).reshape(-1, 3)
    return clip, varyings, indices


def gbuffer(clip, varyings, indices, width, height, fill_rule, device):
    """The port's record route on ``device``: setup under ``fill_rule``,
    binning, the g-buffer kernel. Returns numpy (v0, v1, v2, mask)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    x, y, z, w = clip_to_fb(t(clip), width, height)
    records, bbox = triangle_setup(
        x, y, z, w, t(varyings), torch.as_tensor(indices.astype(np.int64), device=device),
        width, height, fill_rule)
    raster = kernels.raster_gbuffer_hw if fill_rule == "hw" else kernels.raster_gbuffer
    planes = raster(records.reshape(-1, REC_WIDTH), bin_tiles(bbox, width, height), 1,
                    width, height)
    return [p[0].cpu().numpy() for p in planes]


def shade(v0, v1, v2, mask, device):
    """The shipped fragment shader on ``device`` over one g-buffer."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    lut = t(_colormap.build_lut("viridis")[0])
    sun = t(np.array([0.5, 1.0, 0.3], np.float32) / 1.1661904)
    one = t(1.0)
    return fragment.terrain_fs(t(v0), t(v1), t(v2),
                               torch.as_tensor(mask, device=device),
                               lut, one, one, sun).cpu().numpy()


def run_config(name, clip, varyings, indices, width, height, report,
               rule="shipped", device="cuda"):
    fill_rule = "hw" if rule == "hw" else "inclusive"
    hw_id, hw_attr = hw_oracle.rasterize_hw(clip, varyings, indices, width, height)
    v0, v1, v2, mask = gbuffer(clip, varyings, indices, width, height, fill_rule, device)

    hw_cov = hw_id >= 0
    cov_diff = mask != hw_cov
    onb = _boundary(hw_id) | _boundary(mask.astype(np.int32))
    interior = ~onb

    # shade both with the identical epilogue (quantifies final u8 delta)
    ours_u32 = shade(v0, v1, v2, mask, device)
    hw_u32 = shade(hw_attr[..., 0], hw_attr[..., 1], hw_attr[..., 2], hw_cov, device)

    def channels(u):
        return np.stack([(u >> s) & 0xFF for s in (0, 8, 16, 24)], -1).astype(np.int32)

    co, ch = channels(ours_u32), channels(hw_u32)
    delta = np.abs(co - ch).max(axis=-1)
    within1 = (delta <= 1).mean()

    entry = {
        "name": name,
        "rule": rule,
        "covered_px": int(hw_cov.sum()),
        "cov_diff_px": int(cov_diff.sum()),
        "cov_diff_frac": round(float(cov_diff.sum() / max(hw_cov.sum(), 1)), 5),
        "interior_mismatch_px": int((cov_diff & interior).sum()),
        "max_lsb_delta_interior": int(delta[interior].max()) if interior.any() else 0,
        "max_lsb_delta_all": int(delta.max()),
        "pct_pixels_within_1lsb": round(float(within1) * 100, 2),
    }
    report["configs"].append(entry)
    print(json.dumps(entry))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--grids", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--rules", choices=["shipped", "hw", "both"],
                    default="both",
                    help="production fill rule(s) to compare against the "
                         "fixed-point oracle: shipped (f32 all-inclusive) "
                         "and/or hw (VF_FILL_RULE=hw: 8.8 snap + top-left)")
    ap.add_argument("--full", action="store_true",
                    help="add the north-star 800x600 configs (grid=128 and "
                         "grid=1024, orbit + clip-crossing cameras; the "
                         "grid=1024 oracle pass takes minutes)")
    ap.add_argument("--json", default="parity_report_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rules = ["shipped", "hw"] if args.rules == "both" else [args.rules]
    configs = [(g, args.width, args.height, (3.0, 2.0, 3.0), "")
               for g in args.grids]
    if args.full:
        # 800x600; the clip-crossing camera sits low and close so that
        # near-plane clipping slices the mesh.
        configs += [
            (128, 800, 600, (3.0, 2.0, 3.0), "_orbit"),
            (128, 800, 600, (0.9, 0.25, 0.7), "_clipcross"),
            (1024, 800, 600, (0.9, 0.25, 0.7), "_clipcross"),
        ]

    report = {"configs": []}
    for (g, w, h, eye, tag) in configs:
        clip, varyings, indices = spike_config(g, w, h, eye=eye)
        for rule in rules:
            run_config(f"spike_g{g}_{w}x{h}{tag}",
                       clip, varyings, indices, w, h, report, rule=rule, device=device)

    report["all_interior_exact"] = all(
        c["interior_mismatch_px"] == 0 for c in report["configs"])
    hw_entries = [c for c in report["configs"] if c["rule"] == "hw"]
    report["hw_coverage_exact"] = bool(hw_entries) and all(
        c["cov_diff_px"] == 0 for c in hw_entries)
    with open(args.json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.json}; all_interior_exact="
          f"{report['all_interior_exact']}; hw_coverage_exact="
          f"{report.get('hw_coverage_exact')}")
    return 0 if report["all_interior_exact"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
