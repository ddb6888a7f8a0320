"""What the lab twins share: the device argument, the header line that
names the card, and kernel timing with CUDA events."""
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
