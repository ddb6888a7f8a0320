#!/usr/bin/env python3
"""Times the vertex-stream and indexed-mesh kernels of two checkouts of the
PyTorch/CUDA port on one card, in turns.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_cover_ab.py OTHER_ROOT

Runs OTHER, THIS, THIS, OTHER (THIS: the checkout that holds this script),
each in a process of its own that imports the package and
``chip_smoke.py`` of its checkout (and so builds that checkout's kernels).
Each run measures, at chip_smoke.py's main-path shapes and with its
helpers:

  - the vtx route's kernels (``vf_vtx_cover``, ``vf_vtx_cover_big``,
    ``vf_vtx_resolve_gbuffer``, ``vf_vtx_resolve_shade_shipped``) on the
    g1024 spike at 800x600, 4 orbit cameras per batch, and the indexed
    route's (``vf_packed_cover``, ``vf_packed_cover_big``,
    ``vf_packed_resolve_gbuffer``) on the Renderer's DEM-2048 frame at
    800x600, on 5 camera sets each as phases 4b and 4c take them: CUDA
    events around 20 back-to-back launches per set, the median per launch;
  - the vtx route's batch of 4 (host clock after synchronize, the median
    of those 5 sets after a warm-up set) and ``Renderer.render_rgba()`` at
    DEM-2048 (median of 20 calls after a warm-up call, readback included).

Prints one JSON line per run, the card's name and power limit (nvidia-smi),
and last one JSON object with each checkout's runs.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    if os.path.dirname(os.path.abspath(cs.__file__)) != os.path.abspath(root):
        raise SystemExit(f"imported {cs.__file__}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    cs.kernels.load()

    k = cs.kernels
    times = {}

    def time_all(per):
        for name, fn in per.items():
            times.setdefault(name, []).append(cs.cuda_ms(fn, reps=1, inner=cs.KERNEL_INNER))

    shade = cs.spike_shading(dev)
    for r in range(cs.REPS):
        views, projs = cs.orbit_cameras(cs.VBATCH, cs.W, cs.H, phase=0.31 * r + 0.05)
        fields = cs.grid_fields(cs.VGRID, views, projs, dev)
        winner, big, count = k.vtx_cover(fields, cs.VGRID, cs.W, cs.H)
        k.vtx_cover_big(fields, cs.VGRID, winner, big, count)
        time_all({
            "vf_vtx_cover": lambda: k.vtx_cover(fields, cs.VGRID, cs.W, cs.H),
            "vf_vtx_cover_big": lambda: k.vtx_cover_big(fields, cs.VGRID, winner, big, count),
            "vf_vtx_resolve_gbuffer": lambda: k.vtx_resolve_gbuffer(fields, cs.VGRID, winner),
            "vf_vtx_resolve_shade_shipped":
                lambda: k.vtx_resolve_shade_shipped(fields, cs.VGRID, winner, *shade)})
        del fields, winner, big
    cams = [cs.orbit_cameras(cs.VBATCH, cs.W, cs.H, phase=0.31 * r + 0.05)
            for r in range(cs.REPS + 1)]
    batch = cs.route_fn("vtx", cs.VGRID, dev)
    batch(*cams[-1])
    cs.sync()
    batch_ms = cs.host_ms(batch, cams[:cs.REPS])

    r = cs.make_renderer(cs.DEM_MAIN, dev)
    for cam in range(cs.REPS):
        xyuv, tris, heights, views, projs = cs.renderer_frame(r, *cs.turned_cameras(r, cam))
        fields = cs.frame_fields(xyuv, heights, views, projs)
        winner, big, count = k.packed_cover(fields, tris, cs.W, cs.H)
        k.packed_cover_big(fields, tris, winner, big, count)
        time_all({
            "vf_packed_cover": lambda: k.packed_cover(fields, tris, cs.W, cs.H),
            "vf_packed_cover_big": lambda: k.packed_cover_big(fields, tris, winner, big, count),
            "vf_packed_resolve_gbuffer": lambda: k.packed_resolve_gbuffer(fields, tris, winner)})
        del fields, winner, big
    r.render_rgba()
    frame_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        r.render_rgba()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"root": root}
    for name, ms in times.items():
        out[f"{name}_ms"], out[f"{name}_all"] = statistics.median(ms), ms
    return {**out, "g1024_x4_batch_ms": statistics.median(batch_ms),
            "g1024_x4_batch_all": batch_ms, "dem2048_frame_ms": statistics.median(frame_ms)}


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = os.path.abspath(sys.argv[1])
    this = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    runs = {"other": [], "this": []}
    for name, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root],
                             check=True, capture_output=True, text=True, cwd=root).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"run": name, **line}), flush=True)
        runs[name].append(line)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"order": "other, this, this, other", "other": other, "this": this,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
