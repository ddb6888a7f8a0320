"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 -m vfbench.control --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each seed of ``--seeds`` the program serves the cell's first
``check_calls`` requests (after its warm-up, as a run does), and the
reference judges them: the lower readings. For each seed of
``--control-seeds`` the control, the reference with its vertex transforms
in TF32, serves the same requests in the program's place: the upper
readings. One JSON line per seed, then one with the largest program
reading and the smallest control reading of each number. Everything in
one process, so that the set-up is paid once.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import check, generator, run, spec


def control_frames(driver, inp: dict) -> np.ndarray:
    """The control's frames of one request: the reference with its
    vertex transforms in TF32, in the program's place."""
    return driver.reference(inp, driver.device, tf32=True)


def readings(driver, calls: int, control: bool) -> dict:
    """``check.NUMBERS`` over the first ``calls`` requests of the window:
    the program's frames (or the control's) against the reference's."""
    pairs = []
    for k in range(calls):
        inp = driver.inputs(k)
        got = control_frames(driver, inp) if control else driver.call(inp)
        pairs.append((got, driver.reference(inp, driver.device)))
    return check.compare(pairs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m vfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    args = p.parse_args(argv)
    root = run.ROOT
    bench = spec.benchmark(root)
    cell = spec.cell(bench, args.workload)
    devices = [f"cuda:{i}" for i in range(cell["chips"])]
    config = spec.config(root, bench, cell["config"])
    mix = spec.traffic(root, cell["traffic"])
    run.cache_dirs(root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    lower, upper = {}, {}
    for role, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            driver = generator.build(config, mix, seed, devices)
            driver.setup()
            if role == "program":
                for k in range(mix["warmup_calls"]):
                    driver.call(driver.inputs(k, stream=1))
            got = readings(driver, mix["check_calls"], role == "control")
            driver.close()
            into, pick = (lower, max) if role == "program" else (upper, min)
            for name, value in got.items():
                into[name] = pick(into.get(name, value), value)
            print(json.dumps({"cell": cell["name"], "role": role, "seed": seed, **got}),
                  flush=True)
    print(json.dumps({"cell": cell["name"], "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
