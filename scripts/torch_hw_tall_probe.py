#!/usr/bin/env python3
"""One tall frame under the hardware fill rule on the card, once.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_hw_tall_probe.py [ROOT]

Renders a Renderer frame of chip_smoke.py's seeded DEM (the 3601 x 3601
SRTM-sized one at 30 m, x1.5, "terrain") at 7680x4320 with
VF_FILL_RULE=hw on device="cuda", through the package and chip_smoke.py
of the checkout at ROOT (by default the one that holds this script).
Under "hw" the port takes every frame through the record route (setup,
tile binning, vf_raster_gbuffer_hw), as the reference sends tall hw frames
to its list kernel. Prints, as one JSON line, each call's host
milliseconds (the first builds the mesh), the peak device memory of the
calls, the share of pixels the terrain covers and which kernels launched;
then the frame's records and binning once more (their peak device memory
and binned pairs) and vf_raster_gbuffer_hw's time on them alone (CUDA
events, the median of 3 launches after one); on a failure, the stage it
reached and the error, and exits 1. Then the card's name and power limit
(nvidia-smi).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)


DEM, WIDTH, HEIGHT = 3601, 7680, 4320


def main() -> int:
    os.environ["VF_FILL_RULE"] = "hw"

    import numpy as np
    import torch
    import chip_smoke as cs
    from vulkan_forge_torch._raster import kernels

    out = {"config": f"Renderer({WIDTH},{HEIGHT}), DEM-{DEM} (seed 1), VF_FILL_RULE=hw",
           "root": ROOT, "stage": "start"}
    every = {name: getattr(kernels, name.removeprefix("vf_")) for name in (
        "vf_raster_gbuffer", "vf_raster_gbuffer_hw", "vf_raster_shade_shipped_hw",
        "vf_packed_cover", "vf_seg_gbuffer", "vf_vtx_cover")}
    try:
        out["stage"] = "make_renderer"
        r = cs.make_renderer(DEM, "cuda", seed=1, size=(WIDTH, HEIGHT))
        torch.cuda.synchronize()
        for fn in every.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out["stage"] = "render_rgba"
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = r.render_rgba()
            times.append((time.perf_counter() - t0) * 1e3)
        out.update(stage="done", ms=times, peak_bytes=int(torch.cuda.max_memory_allocated()),
                   launches={name: fn.launches for name, fn in every.items()},
                   shape=list(img.shape),
                   covered_share=float((img[..., :3] != np.array([39, 39, 48], np.uint8))
                                       .any(-1).mean()))
        out["stage"] = "kernel"
        del img
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        xyuv, tris, heights, views, projs = cs.renderer_frame(r)
        one = cs.tensor(1.0, "cuda")
        records, binning = cs.pipeline.terrain_records(
            xyuv, tris.long(), heights, views, projs, one, one, WIDTH, HEIGHT,
            fs_mode="extended", fill_rule="hw")
        kernels.raster_gbuffer_hw(records, binning, 1, WIDTH, HEIGHT)
        torch.cuda.synchronize()
        out.update(records_peak_bytes=int(torch.cuda.max_memory_allocated()),
                   records_above_resident_bytes=int(torch.cuda.max_memory_allocated() - base),
                   pairs=int(binning.rows.numel()),
                   kernel_ms=cs.cuda_ms(lambda: kernels.raster_gbuffer_hw(
                       records, binning, 1, WIDTH, HEIGHT), reps=3, warmup=1),
                   stage="done")
        rc = 0
    except Exception as exc:  # the probe reports the failure and its stage
        out.update(error=f"{type(exc).__name__}: {exc}",
                   traceback=traceback.format_exc(limit=8).splitlines()[-12:],
                   peak_bytes=int(torch.cuda.max_memory_allocated()))
        rc = 1
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
