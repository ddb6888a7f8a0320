"""Performance sanity harness on the port (twin of
``python/tools/perf_sanity.py``).

Measures cold init (constructor + first render; on the card it includes
loading the kernel library) and steady-state triangle render timings, with
``torch.cuda.synchronize()`` around each call on a card; the original's
JSON schema and enforcement:
  - default: report-only, never fails;
  - VF_ENFORCE_PERF=1 + --baseline: exit 2 if steady p95 > baseline p95 +
    --regress-pct percent;
  - VF_ENFORCE_PERF=1, no baseline: budget_ms = 40 * (W*H)/(512*512), exit 2
    if steady p95 > budget_ms * --budget-mult.

    python -m vulkan_forge_torch.tools.perf_sanity --width 800 --height 600
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
import statistics as stats
import time
from typing import Any, Dict, List

import torch

from vulkan_forge_torch import Renderer


def percentile(values: List[float], p: float) -> float:
    if not values:
        return float("nan")
    k = (len(values) - 1) * (p / 100.0)
    f = math.floor(k)
    c = math.ceil(k)
    if f == c:
        return values[int(k)]
    return values[f] * (c - k) + values[c] * (k - f)


def budget_ms(width: int, height: int) -> float:
    """The reference's triangle budget, scaled by the frame's pixels."""
    return 40.0 * (width * height) / (512.0 * 512.0)


def measure(width: int, height: int, runs: int, warmups: int,
            device: str) -> Dict[str, Any]:
    t0 = time.perf_counter()
    r = Renderer(width, height, device=device)

    def sync():
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)

    r.render_triangle_rgba()  # cold render
    sync()
    init_ms = (time.perf_counter() - t0) * 1000.0

    for _ in range(max(0, warmups)):
        r.render_triangle_rgba()

    steady = []
    for _ in range(runs):
        sync()
        t = time.perf_counter()
        r.render_triangle_rgba()
        sync()
        steady.append((time.perf_counter() - t) * 1000.0)

    steady_sorted = sorted(steady)
    return {
        "width": width, "height": height,
        "runs": runs, "warmups": warmups,
        "device": str(r.device),
        "init_ms": init_ms,
        "steady": {
            "samples_ms": steady,
            "mean_ms": stats.fmean(steady) if steady else float("nan"),
            "median_ms": stats.median(steady) if steady else float("nan"),
            "p95_ms": percentile(steady_sorted, 95.0) if steady else float("nan"),
            "stdev_ms": stats.pstdev(steady) if len(steady) > 1 else 0.0,
            "min_ms": min(steady) if steady else float("nan"),
            "max_ms": max(steady) if steady else float("nan"),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--warmups", type=int, default=3)
    ap.add_argument("--json", default="perf_report_torch.json")
    ap.add_argument("--csv", default="")
    ap.add_argument("--baseline", default="")
    ap.add_argument("--regress-pct", type=float, default=50.0)
    ap.add_argument("--budget-mult", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    rep = measure(args.width, args.height, args.runs, args.warmups, args.device)

    if args.csv:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        with open(args.csv, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["iter", "ms"])
            for i, ms in enumerate(rep["steady"]["samples_ms"]):
                w.writerow([i, f"{ms:.4f}"])

    with open(args.json, "w", encoding="utf-8") as f:
        json.dump(rep, f, indent=2)
    print(json.dumps(rep, indent=2))

    if os.environ.get("VF_ENFORCE_PERF", "").strip() == "1":
        p95 = rep["steady"]["p95_ms"]
        if args.baseline:
            try:
                with open(args.baseline, "r", encoding="utf-8") as f:
                    base = json.load(f)
                base_p95 = float(base["steady"]["p95_ms"])
                limit = base_p95 * (1.0 + args.regress_pct / 100.0)
                if p95 > limit:
                    print(f"FAIL: p95 {p95:.3f}ms > baseline {base_p95:.3f}ms"
                          f" * (1 + {args.regress_pct:.1f}%) = {limit:.3f}ms")
                    return 2
            except Exception as e:
                print(f"WARNING: failed to read baseline '{args.baseline}': {e}")
        else:
            budget = budget_ms(args.width, args.height)
            limit = budget * args.budget_mult
            if p95 > limit:
                print(f"FAIL: p95 {p95:.3f}ms > scaled budget {limit:.3f}ms "
                      f"(budget {budget:.3f} * mult {args.budget_mult:.2f})")
                return 2

    print("Performance sanity OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
