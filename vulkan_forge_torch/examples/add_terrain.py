"""DEM upload + stats + normalization (twin of
``python/examples/add_terrain.py``).

    python -m vulkan_forge_torch.examples.add_terrain [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

import vulkan_forge_torch as vt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    r = vt.Renderer(512, 512, device=args.device)
    x = np.linspace(-3, 3, 256, dtype=np.float32)
    dem = np.exp(-(x[None, :] ** 2 + x[:, None] ** 2)).astype(np.float32) * 100.0

    r.add_terrain(dem, spacing=(25.0, 25.0), exaggeration=2.0, colormap="terrain")
    print("stats (min, max, mean, std):", r.terrain_stats())

    r.normalize_terrain("minmax", range=(0.0, 1.0))
    print("after minmax:", r.terrain_stats())

    r.upload_height_r32f()
    patch = r.debug_read_height_patch(10, 10, 4, 4)
    print("height patch:\n", patch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
