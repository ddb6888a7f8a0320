"""What the lab twins share: the device argument, the header line that
names the card, kernel timing with CUDA events, and the loop scripts'
twin."""
from __future__ import annotations

import argparse
import statistics

import torch

from .._device import resolve_device


def parse(description: str, argv, extra=None):
    """(args, device) from ``--device`` (default cuda: no card raises) and
    the flags ``extra(parser)`` adds."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    return args, resolve_device(args.device)


def card(device) -> str:
    """The card's nvidia-smi name and power limit, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    from ..bench import card_line
    return card_line()


def header(device) -> str:
    return f"device: {device.type} ({card(device)})" if device.type == "cuda" else \
        "device: cpu (plain versions; no kernel)"


def launch_ns(fn, steps: int, reps: int = 3) -> float:
    """Median nanoseconds per step of one launch of fn() that runs ``steps``
    steps on the card: CUDA events around each of ``reps`` launches, after
    one warm-up launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e6 / steps)
    return statistics.median(times)


def loop_args(description: str, argv):
    """(args, device) of a loop twin: ``--device`` and ``--nstep`` (steps a
    launch: the script's NSTEP on the card, 8 on the CPU if not given)."""
    return parse(description, argv, lambda ap: ap.add_argument(
        "--nstep", type=int, default=None,
        help="steps per launch (default: the script's NSTEP on the card, 8 on the CPU)"))


def loop_lines(script: str, device, nstep=None) -> None:
    """Each body of ``scripts/<script>.py`` in its order: one launch of
    ``step_loop`` at ``nstep`` steps on the script's input, zero scratch;
    one line each, as the script prints it. On the CPU the plain bodies run
    and no time is measured."""
    from . import _bodies, _kernels

    nstep = nstep or (_bodies.SCRIPTS[script]["nstep"] if device.type == "cuda" else 8)
    big = _bodies.script_big(script, device)
    for body in _bodies.BODIES:
        if body.script != script:
            continue
        run = lambda body=body: _kernels.step_loop(body.name, big, nstep)
        if device.type != "cuda":
            out = run()[0]
            print(f"{body.label}: not measured (no card); plain, {nstep} steps: "
                  f"max |out| {float(out.abs().max()):.6g}")
            continue
        ns = launch_ns(run, nstep)
        if script == "exp_loop_floor":
            print(f"{body.label}: {ns:.0f} ns/logical-step ({ns * body.unroll:.0f} ns/iter)")
        elif body.name == "e5":
            print(f"{body.label}: {ns:.0f} ns/step ({ns * nstep / 1e6:.2f} ms / {nstep})")
        else:
            print(f"{body.label}: {ns:.0f} ns/step")
    if device.type == "cuda":
        print(f"({nstep} steps a launch, CUDA events, median of 3 after a warm-up; "
              f"{card(device)})")


def loop_twin(description: str, script: str, argv) -> int:
    """The twin of a loop script: its bodies' lines (``loop_lines``)."""
    args, device = loop_args(description, argv)
    print(header(device))
    loop_lines(script, device, args.nstep)
    return 0


def cuda_ms(fn, reps: int = 5, inner: int = 20, warmup: int = 2) -> float:
    """Median milliseconds per call of fn() on the card: CUDA events around
    ``inner`` back-to-back calls, ``reps`` times, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)
