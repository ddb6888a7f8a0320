"""Determinism demo: two renders must hash identically (twin of
``python/examples/two_triangles.py``).

    python -m vulkan_forge_torch.examples.two_triangles [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib

import vulkan_forge_torch as vt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    a = vt.render_triangle_rgba(256, 256, device=args.device)
    b = vt.render_triangle_rgba(256, 256, device=args.device)
    ha = hashlib.sha256(a.tobytes()).hexdigest()
    hb = hashlib.sha256(b.tobytes()).hexdigest()
    print("hash A:", ha)
    print("hash B:", hb)
    assert ha == hb, "non-deterministic output!"
    print("deterministic: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
