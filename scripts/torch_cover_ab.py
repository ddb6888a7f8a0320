#!/usr/bin/env python3
"""Times the raster kernels of two or more checkouts of the PyTorch/CUDA
port on one card, in turns.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_cover_ab.py OTHER_ROOT [OTHER_ROOT ...] [--only PARTS]

First builds every checkout's kernels, one process per checkout, started
together. Then runs each OTHER in the order given, THIS twice, and each
OTHER again in reverse order (one OTHER: OTHER, THIS, THIS, OTHER; THIS:
the checkout that holds this script), each in a process of its own that
imports the package and ``chip_smoke.py`` of its checkout. Each run
measures, at chip_smoke.py's main-path shapes and with its helpers:

  - the vtx route's kernels (``vf_vtx_cover``, ``vf_vtx_cover_big``,
    ``vf_vtx_resolve_gbuffer``, ``vf_vtx_resolve_shade_shipped``) on the
    g1024 spike at 800x600, 4 orbit cameras per batch, and the indexed
    route's (``vf_packed_cover``, ``vf_packed_cover_big``,
    ``vf_packed_resolve_gbuffer``) on the Renderer's DEM-2048 frame at
    800x600, on 5 camera sets each as phases 4b and 4c take them: CUDA
    events around 20 back-to-back launches per set, the median per launch;
  - the vtx route's batch of 4 (host clock after synchronize, the median
    of those 5 sets after a warm-up set) and ``Renderer.render_rgba()`` at
    DEM-2048 (median of 20 calls after a warm-up call, readback included);
  - the record route's four kernels (``vf_raster_gbuffer``,
    ``vf_raster_shade_shipped`` and their ``_hw`` twins) over each
    checkout's own records and binning, under both fill rules: the triangle
    at 800x600, the spike g128 and g1024 frames, the Renderer's DEM-2048
    frame and the loaded g1024 close-in + w-crossing pair (chip_smoke's
    special_cameras); the median of 5 runs of 20 back-to-back calls (CUDA
    events), and the kernel's own device time per launch over 20 calls
    (torch.profiler), which the wrapper's host work does not reach; then
    the record route's g128 batch of 32 orbit cameras and the g1024 spike
    frame under VF_FILL_RULE=hw (host clock after synchronize, medians);
  - the three resolves (``vf_vtx_resolve_gbuffer``,
    ``vf_vtx_resolve_shade_shipped``, ``vf_packed_resolve_gbuffer``) on
    the winners of each checkout's own cover passes, per case the median
    over its camera sets of the CUDA-event time per call (20 back-to-back
    calls) and of the device time per launch (torch.profiler, 20 calls):
    the g1024 spike with phase 4b's 5 sets of 4 orbit cameras, the first
    camera of each alone, and 5 turned close-in + w-crossing pairs
    (special_cameras); the Renderer's DEM-2048 frame at phase 4c's 5
    turned cameras, 5 turned close-in + w-crossing pairs
    (special_dem_cameras) and a DEM-256 frame at the same 5 turned
    cameras; with each kernel's registers and spills (ptxas) and its
    global loads in the SASS (``cuobjdump -sass``: LDG instructions), a
    sha256 of each kernel's outputs per case and of the two frames whose
    sha256 chip_smoke's phases 3b and 3c print (the g1024 spike's and the
    DEM-2048 Renderer's ``render_rgba()``); the last line says whether
    every run's outputs were the same bytes (``outputs_equal``).

``--only cover`` measures the first two parts, ``--only record`` the
third, ``--only resolve`` the last, ``--only resolve,cover`` both named;
without ``--only``, the first three.

Prints one JSON line per run, the card's name and power limit (nvidia-smi),
and last one JSON object with each checkout's runs.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def device_ms(torch, fn, key="raster_kernel", calls=20) -> float:
    """Device milliseconds per launch of the kernel whose name holds ``key``
    over ``calls`` calls of fn (torch.profiler): the kernel alone, without
    the wrapper's host work, which a short kernel cannot hide."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):              # a session may record none of them
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [a for a in prof.key_averages() if key in a.key]
        seen = sum(a.count for a in ev)
        if seen:
            break
    if not seen or seen > calls:
        raise SystemExit(f"the profiler saw {seen} {key} launches in {calls} calls")
    # The mean over the launches it recorded (its first session may miss some).
    return sum(a.self_device_time_total for a in ev) / seen / 1e3


def measure_record(cs, dev) -> dict:
    """Per-launch ms of the record kernels, keyed "<kernel> <case>": CUDA
    events around 20 back-to-back calls (``_ms``) and the kernel's device
    time from the profiler (``_device_ms``)."""
    k = cs.kernels
    shade = cs.spike_shading(dev)
    out = {}

    def time_rules(case, make, n_frames, shaded):
        for rule in ("inclusive", "hw"):
            records, binning = make(rule)
            name = "raster_shade_shipped" if shaded else "raster_gbuffer"
            if rule == "hw":
                name += "_hw"
            fn = getattr(k, name)
            args = shade if shaded else ()
            call = lambda: fn(records, binning, n_frames, cs.W, cs.H, *args)
            out[f"vf_{name} {case}_ms"] = cs.cuda_ms(call, inner=cs.KERNEL_INNER)
            out[f"vf_{name} {case}_device_ms"] = device_ms(cs.torch, call)
            del records, binning
            cs.torch.cuda.empty_cache()

    time_rules("triangle", lambda rule: cs.pipeline.triangle_records(cs.W, cs.H, dev, rule), 1,
               False)
    for grid in (cs.GRID, cs.VGRID):
        spike = cs.vt.make_terrain(cs.W, cs.H, grid, device="cpu")
        for shaded in (False, True):
            time_rules(f"spike g{grid}", lambda rule: cs.scene_inputs(spike, dev, rule)[:2], 1,
                       shaded)
    r = cs.make_renderer(cs.DEM_MAIN, dev)
    xyuv, tris, heights, views, projs = cs.renderer_frame(r)
    one = cs.tensor(1.0, dev)
    time_rules(f"DEM-{cs.DEM_MAIN}", lambda rule: cs.pipeline.terrain_records(
        xyuv, tris.long(), heights, views, projs, one, one, cs.W, cs.H, fs_mode="extended",
        fill_rule=rule), 1, False)
    del r, xyuv, tris, heights
    views, projs = cs.special_cameras(cs.W, cs.H)
    for shaded in (False, True):
        time_rules(f"g{cs.VGRID} close-in + w-crossing",
                   lambda rule: cs.record_route(cs.VGRID, views, projs, dev, rule), 2, shaded)

    # Whole record-route frames: the batch of 32 orbit cameras at g128 (the
    # mesh on the card), and make_terrain(800, 600, 1024).render_rgba()
    # under VF_FILL_RULE=hw; host clock after synchronize, medians.
    cams = [cs.orbit_cameras(cs.BATCH, cs.W, cs.H, phase=0.31 * r) for r in range(cs.REPS + 1)]
    batch = cs.route_fn("record", cs.GRID, dev)
    batch(*cams[-1])
    cs.sync()
    out["record_g128_x32_batch_ms"] = statistics.median(cs.host_ms(batch, cams[:cs.REPS]))
    spike = cs.vt.make_terrain(cs.W, cs.H, cs.VGRID, device=dev)
    os.environ["VF_FILL_RULE"] = "hw"
    spike.render_rgba()
    out["hw_spike_g1024_frame_ms"] = statistics.median(cs.host_ms(spike.render_rgba, [()] * 10))
    del os.environ["VF_FILL_RULE"]
    return out


RESOLVE_ENTRIES = (("vtx_resolve_kernelILb0", "vf_vtx_resolve_gbuffer"),
                   ("vtx_resolve_kernelILb1", "vf_vtx_resolve_shade_shipped"),
                   ("packed_resolve_kernel", "vf_packed_resolve_gbuffer"))


def sass_loads(cs, path: str) -> dict:
    """Global-memory load instructions (LDG) in the SASS of each resolve
    kernel of the library at ``path`` (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(cs.kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], check=True, capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = next((name for key, name in RESOLVE_ENTRIES if key in ln), None)
            if cur:
                out[cur] = 0
        elif cur and "LDG" in ln:
            out[cur] += 1
    return out


def measure_resolve(cs, dev) -> dict:
    """Per-launch ms of the three resolves, keyed "<kernel> <case>": the
    median over the case's camera sets of CUDA events around 20
    back-to-back calls (``_ms``) and of the kernel's device time from the
    profiler (``_device_ms``); each kernel's ptxas line and SASS loads."""
    k = cs.kernels
    shade = cs.spike_shading(dev)
    runs, digests = {}, {}

    def time_calls(case, calls):
        for name, call in calls.items():
            h = digests.setdefault(f"{name} {case}", hashlib.sha256())
            got = call()
            for plane in got if isinstance(got, tuple) else (got.view(cs.torch.int32),):
                h.update(plane.cpu().numpy().tobytes())
            runs.setdefault(f"{name} {case}_ms", []).append(
                cs.cuda_ms(call, reps=1, inner=cs.KERNEL_INNER))
            runs.setdefault(f"{name} {case}_device_ms", []).append(
                device_ms(cs.torch, call, key="resolve_kernel"))

    def vtx_case(case, cams):
        for views, projs in cams:
            fields = cs.grid_fields(cs.VGRID, views, projs, dev)
            winner = k.vtx_cover_big(fields, cs.VGRID,
                                     *k.vtx_cover(fields, cs.VGRID, cs.W, cs.H))
            time_calls(case, {
                "vf_vtx_resolve_gbuffer": lambda: k.vtx_resolve_gbuffer(fields, cs.VGRID, winner),
                "vf_vtx_resolve_shade_shipped":
                    lambda: k.vtx_resolve_shade_shipped(fields, cs.VGRID, winner, *shade)})
            del fields, winner

    orbit = [cs.orbit_cameras(cs.VBATCH, cs.W, cs.H, phase=0.31 * r + 0.05)
             for r in range(cs.REPS)]
    vtx_case(f"g{cs.VGRID} x{cs.VBATCH}", orbit)
    vtx_case(f"g{cs.VGRID} x1", [(v[:1], p[:1]) for v, p in orbit])
    vtx_case(f"g{cs.VGRID} close-in + w-crossing",
             [cs.special_cameras(cs.W, cs.H, turn=0.1 * r) for r in range(cs.REPS)])

    def packed_case(case, r, cams):
        for views, projs in cams:
            xyuv, tris, heights, views, projs = cs.renderer_frame(r, views, projs)
            fields = cs.frame_fields(xyuv, heights, views, projs)
            winner = k.packed_cover_big(fields, tris,
                                        *k.packed_cover(fields, tris, cs.W, cs.H))
            time_calls(case, {"vf_packed_resolve_gbuffer":
                              lambda: k.packed_resolve_gbuffer(fields, tris, winner)})
            del fields, winner

    r = cs.make_renderer(cs.DEM_MAIN, dev)
    frames = {f"make_terrain({cs.W},{cs.H},{cs.VGRID}).render_rgba()":
              cs.vt.make_terrain(cs.W, cs.H, cs.VGRID, device=dev).render_rgba(),
              f"Renderer DEM-{cs.DEM_MAIN} render_rgba()": r.render_rgba()}
    packed_case(f"DEM-{cs.DEM_MAIN}", r, [cs.turned_cameras(r, c) for c in range(cs.REPS)])
    packed_case(f"DEM-{cs.DEM_MAIN} close-in + w-crossing", r,
                [cs.special_dem_cameras(r, turn=0.1 * c) for c in range(cs.REPS)])
    del r
    r = cs.make_renderer(cs.DEM_CHECK, dev)
    packed_case(f"DEM-{cs.DEM_CHECK}", r, [cs.turned_cameras(r, c) for c in range(cs.REPS)])
    del r
    cs.torch.cuda.empty_cache()
    path = str(k.library_path())
    ptxas = cs.ptxas_summary(open(path + ".log").read())
    out = {key: statistics.median(v) for key, v in runs.items()}
    out.update({f"{key}_all": v for key, v in runs.items()})
    out["ptxas"] = {name: ptxas[name] for _, name in RESOLVE_ENTRIES}
    out["sass_global_loads"] = sass_loads(cs, path)
    out["sha256"] = {key: h.hexdigest() for key, h in digests.items()}
    out["sha256"].update({key: hashlib.sha256(img.tobytes()).hexdigest()
                          for key, img in frames.items()})
    return out


def measure(root: str, parts) -> dict:
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    if os.path.dirname(os.path.abspath(cs.__file__)) != os.path.abspath(root):
        raise SystemExit(f"imported {cs.__file__}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    cs.kernels.load()
    out = {"root": root}
    if "record" in parts:
        out.update(measure_record(cs, dev))
    if "resolve" in parts:
        out.update(measure_resolve(cs, dev))
    if "cover" not in parts:
        return out

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
    for name, ms in times.items():
        out[f"{name}_ms"], out[f"{name}_all"] = statistics.median(ms), ms
    return {**out, "g1024_x4_batch_ms": statistics.median(batch_ms),
            "g1024_x4_batch_all": batch_ms, "dem2048_frame_ms": statistics.median(frame_ms)}


def build(root: str) -> subprocess.Popen:
    """Starts a process that builds the kernels of the checkout at ``root``."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from vulkan_forge_torch._raster import kernels; kernels.build()")
    return subprocess.Popen([sys.executable, "-c", code, root], cwd=root)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2], sys.argv[3].split(","))), flush=True)
        return 0
    args = sys.argv[1:]
    parts = "cover,record"
    if len(args) >= 2 and args[-2] == "--only" \
            and set(args[-1].split(",")) <= {"cover", "record", "resolve"}:
        parts = args[-1]
        args = args[:-2]
    if not args or any(a.startswith("-") for a in args):
        raise SystemExit(__doc__)
    others = [os.path.abspath(a) for a in args]
    this = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    builds = [build(root) for root in others + [this]]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a checkout's kernels did not build")
    order = others + [this, this] + others[::-1]
    runs = {root: [] for root in order}
    for root in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root,
                              parts], check=True, capture_output=True, text=True,
                             cwd=root).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"run": "this" if root == this else root, **line}), flush=True)
        runs[root].append(line)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    digests = {json.dumps(line.get("sha256")) for lines in runs.values() for line in lines}
    print(json.dumps({"order": order, "this": this, "runs": runs,
                      "outputs_equal": len(digests) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
