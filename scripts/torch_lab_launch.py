#!/usr/bin/env python3
"""Times the lab's launch path of two or more checkouts of the PyTorch/CUDA
port on one card, in turns.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_lab_launch.py OTHER_ROOT [OTHER_ROOT ...]

First builds every checkout's lab library, one process per checkout, started
together. Then runs each OTHER in the order given, THIS twice, and each
OTHER again in reverse order (one OTHER: OTHER, THIS, THIS, OTHER; THIS:
the checkout that holds this script), each in a process of its own that
imports the package and ``chip_smoke.py`` of its checkout. Each run prints
one JSON line with the card's name and power limit (nvidia-smi) and:

  - ``profile``: cProfile over CALLS calls of the checkout's own
    ``slab_transpose`` at (8, 128) (no synchronize between calls) and over
    STEP_CALLS calls of its ``step_loop`` (body c_scalar, 128 steps,
    exp_loop_floor's input and a zero scratch; a synchronize after each
    call): per call, the ns each function takes itself (``own``) and with
    what it calls (``with_callees``), for the functions that take 1% of the
    call or more. A ctypes call is no function to cProfile: its time (the
    launch and cudaGetLastError) is its caller's own. cProfile adds a cost
    to every function it sees, so compare these runs with one another, not
    with chip_smoke's "lab_launch_split";
  - ``rows``: each lab row's per-call ms (CUDA events), device ms, plain ms
    and library call's ms, as the checkout's own chip_smoke phase 7 times
    them (its ``lab_*_checks``: fs_ops, slab_copy, slab_transpose,
    onehot_dot, lane_ops with E2).
"""
from __future__ import annotations

import cProfile
import json
import os
import pstats
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 2000
STEP_CALLS = 200
# chip_smoke's lab checks whose records this script reads, in phase 7's order.
CHECKS = ("lab_fs_ops_checks", "lab_slab_copy_checks", "lab_slab_transpose_checks",
          "lab_onehot_dot_checks", "lab_lane_ops_checks")
TIMES = ("ms", "device_ms", "plain_ms", "library_ms")


def profiled(fn, calls: int) -> dict:
    """{function: {"own": ns, "with_callees": ns}} per call of fn over
    ``calls`` calls under cProfile, for the functions whose time with their
    callees is 1% of a call or more."""
    fn()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = {}
    for (path, line, name), (_, _, own, cum, _) in stats.items():
        label = name if path == "~" else f"{os.path.basename(path)}:{line}({name})"
        rows[label] = {"own": own / calls * 1e9, "with_callees": cum / calls * 1e9}
    top = max(r["with_callees"] for r in rows.values())
    return dict(sorted(((k, r) for k, r in rows.items() if r["with_callees"] >= 0.01 * top),
                       key=lambda kv: -kv[1]["with_callees"]))


def times(rec):
    """The timing records of a chip_smoke check's result: every dict with an
    "ms" key, by its path of keys."""
    out = {}
    if isinstance(rec, dict):
        if "ms" in rec:
            return {"": {k: rec.get(k) for k in TIMES}}
        for key, val in rec.items():
            for path, got in times(val).items():
                out[f"{key}/{path}".rstrip("/")] = got
    elif isinstance(rec, (tuple, list)):
        for i, val in enumerate(rec):
            for path, got in times(val).items():
                out[f"{i}/{path}".rstrip("/")] = got
    return out


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    if os.path.dirname(os.path.abspath(cs.__file__)) != os.path.abspath(root):
        raise SystemExit(f"imported {cs.__file__}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    lab, bodies = cs.lab_kernels, cs.lab_bodies
    lab.load()
    src = torch.rand(8, 128, device=dev)
    big = bodies.script_big("exp_loop_floor", dev)
    scratch = torch.zeros((bodies.SCRIPTS["exp_loop_floor"]["scratch"], bodies.LANES),
                          device=dev)

    def step():
        lab.step_loop("c_scalar", big, 128, scratch)
        torch.cuda.synchronize()

    profile = {"slab_transpose": profiled(lambda: lab.slab_transpose(src), CALLS),
               "step_loop": profiled(step, STEP_CALLS)}
    torch.cuda.synchronize()
    rows = {name: times(getattr(cs, name)(dev)) for name in CHECKS}
    return {"root": root, "card": card(),
            "calls": CALLS, "step_calls": STEP_CALLS, "profile": profile, "rows": rows}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def build(root: str) -> subprocess.Popen:
    """Starts a process that builds the lab library of the checkout at ``root``."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from vulkan_forge_torch.lab import _kernels; _kernels.build()")
    return subprocess.Popen([sys.executable, "-c", code, root], cwd=root)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    others = [os.path.abspath(a) for a in sys.argv[1:]]
    if not others or any(a.startswith("-") for a in sys.argv[1:]):
        raise SystemExit(__doc__)
    if any(p.wait() for p in [build(r) for r in others + [HERE]]):
        raise SystemExit("a checkout's lab library did not build")
    for root in others + [HERE, HERE] + others[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root],
                       cwd=root, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
