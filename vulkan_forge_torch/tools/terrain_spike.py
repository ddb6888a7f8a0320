"""Render the analytic terrain spike to a PNG (twin of
``python/tools/terrain_spike.py``).

    python -m vulkan_forge_torch.tools.terrain_spike --out spike.png [--device cpu]
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--colormap", default="viridis")
    ap.add_argument("--out", default="terrain_spike_torch.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vulkan_forge_torch import TerrainSpike
    t = TerrainSpike(args.width, args.height, args.grid, args.colormap, device=args.device)
    t.render_png(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
