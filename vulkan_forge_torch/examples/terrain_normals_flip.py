"""Directional lighting: east vs west sun on a Gaussian bump (twin of
``python/examples/terrain_normals_flip.py``).

    python -m vulkan_forge_torch.examples.terrain_normals_flip [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

import vulkan_forge_torch as vt


def bump(n, amp=50.0, sigma=0.18):
    yy, xx = np.mgrid[0:n, 0:n]
    c = (n - 1) / 2.0
    r2 = ((xx - c) ** 2 + (yy - c) ** 2) / (n ** 2)
    return (amp * np.exp(-r2 / (2 * sigma ** 2))).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    for name, az in (("east", 90.0), ("west", 270.0)):
        r = vt.Renderer(400, 400, device=args.device)
        r.add_terrain(bump(256), spacing=(10.0, 10.0), exaggeration=1.0,
                      colormap="viridis")
        r.set_sun(elevation_deg=45.0, azimuth_deg=az)
        r.render_png(f"bump_{name}_torch.png")
        print(f"wrote bump_{name}_torch.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
