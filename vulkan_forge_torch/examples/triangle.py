"""Render the deterministic gradient triangle (twin of
``python/examples/triangle.py``).

    python -m vulkan_forge_torch.examples.triangle [--device cpu]
"""
from __future__ import annotations

import argparse

import vulkan_forge_torch as vt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arr = vt.render_triangle_rgba(512, 512, device=args.device)
    print(f"rendered {arr.shape} {arr.dtype}")
    vt.render_triangle_png("triangle_torch.png", 512, 512, device=args.device)
    print("wrote triangle_torch.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
