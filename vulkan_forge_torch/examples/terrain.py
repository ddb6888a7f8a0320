"""Full DEM render with sun + exposure (twin of
``python/examples/terrain.py``).

    python -m vulkan_forge_torch.examples.terrain [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

import vulkan_forge_torch as vt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    r = vt.Renderer(800, 600, device=args.device)
    x = np.linspace(-4, 4, 512, dtype=np.float32)
    dem = ((np.sin(x[None, :]) * np.cos(x[:, None]) + 1.0) * 60.0).astype(np.float32)

    r.add_terrain(dem, spacing=(20.0, 20.0), exaggeration=1.5, colormap="viridis")
    r.set_sun(elevation_deg=35.0, azimuth_deg=120.0)
    r.set_exposure(1.1)
    r.render_png("terrain_demo_torch.png")
    print("wrote terrain_demo_torch.png")
    print("metrics:", r.render_metrics())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
