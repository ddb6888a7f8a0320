"""Determinism harness on the port (twin of
``python/tools/determinism_harness.py``).

Renders a scene N times (optionally across processes) and checks that the
raw RGBA bytes hash identically; writes a JSON report with the original's
keys (width/height/runs/processes/hashes/unique/all_equal/avg_ms, optional
png/png_error, and scene for ``--scene terrain``). Child processes start
with the ``spawn`` method: CUDA does not survive ``fork``.

    python -m vulkan_forge_torch.tools.determinism_harness --runs 3 [--scene terrain]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import queue
import time
from dataclasses import dataclass

import numpy as np

from vulkan_forge_torch import Renderer, Scene

# How long a render process may take to report its hash.
PROCESS_TIMEOUT_S = 600


@dataclass
class RunResult:
    sha256: str
    millis: float


def render_bytes(w: int, h: int, scene: str, device: str) -> bytes:
    if scene == "terrain":
        s = Scene(w, h, 32, "viridis", device=device)
        hm = np.outer(np.sin(np.linspace(0, 3, 64)),
                      np.cos(np.linspace(0, 2, 64))).astype(np.float32)
        s.set_height_from_r32f(hm)
        return s.render_rgba().tobytes()
    return Renderer(w, h, device=device).render_triangle_rgba().tobytes()


def run_sequential(w: int, h: int, runs: int, scene: str, device: str) -> "list[RunResult]":
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        b = render_bytes(w, h, scene, device)
        dt = (time.perf_counter() - t0) * 1000.0
        out.append(RunResult(hashlib.sha256(b).hexdigest(), dt))
    return out


def _mp_worker(q, w, h, scene, device):
    b = render_bytes(w, h, scene, device)
    q.put((hashlib.sha256(b).hexdigest(), len(b)))


def _collect(q, ps) -> "list[str]":
    """One hash from each render process; raises (and kills the others) as
    soon as one exits without reporting, or after PROCESS_TIMEOUT_S."""
    shas, deadline = [], time.monotonic() + PROCESS_TIMEOUT_S
    while len(shas) < len(ps):
        try:
            shas.append(q.get(timeout=1.0)[0])
        except queue.Empty:
            failed = any(p.exitcode not in (None, 0) for p in ps)
            if failed or time.monotonic() > deadline:
                codes = [p.exitcode for p in ps]
                for p in ps:
                    p.kill()
                raise RuntimeError(f"a render process failed: exit codes {codes}") from None
    return shas


def run_multiprocess(w: int, h: int, runs: int, procs: int, scene: str,
                     device: str) -> "list[RunResult]":
    import multiprocessing as mp
    ctx = mp.get_context("spawn")  # a fresh CUDA context per child
    results = []
    for _ in range(runs):
        q = ctx.Queue()
        ps = [ctx.Process(target=_mp_worker, args=(q, w, h, scene, device))
              for _ in range(max(1, procs))]
        t0 = time.perf_counter()
        for p in ps:
            p.start()
        try:
            shas = _collect(q, ps)  # drain the queue before joining its writers
        finally:
            for p in ps:
                p.join()
        dt = (time.perf_counter() - t0) * 1000.0
        if len(set(shas)) != 1:
            raise AssertionError(f"Non-deterministic across processes: {shas}")
        results.append(RunResult(shas[0], dt))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--processes", type=int, default=0,
                    help=">0 enables multi-process check")
    ap.add_argument("--png", action="store_true", help="also write PNG to --out-dir")
    ap.add_argument("--out-dir", default="determinism_torch_artifacts")
    ap.add_argument("--scene", choices=("triangle", "terrain"),
                    default="triangle",
                    help="what to hash (terrain covers the full DEM pipeline)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)

    if args.processes > 0:
        results = run_multiprocess(args.width, args.height, args.runs,
                                   args.processes, args.scene, args.device)
    else:
        results = run_sequential(args.width, args.height, args.runs, args.scene,
                                 args.device)

    shas = [r.sha256 for r in results]
    unique = sorted(set(shas))
    report = {
        "width": args.width,
        "height": args.height,
        "runs": args.runs,
        "processes": args.processes,
        "hashes": shas,
        "unique": unique,
        "all_equal": len(unique) == 1,
        "avg_ms": sum(r.millis for r in results) / max(1, len(results)),
    }
    if args.scene != "triangle":
        report["scene"] = args.scene

    if args.png:
        try:
            r = Renderer(args.width, args.height, device=args.device)
            r.render_triangle_png(os.path.join(args.out_dir, "triangle.png"))
            report["png"] = "triangle.png"
        except Exception as e:
            report["png_error"] = str(e)

    rep_path = os.path.join(args.out_dir, "determinism_report.json")
    with open(rep_path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))

    if not report["all_equal"]:
        raise SystemExit("Determinism check FAILED: differing hashes")
    print("Determinism check OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
