"""Twin of ``scripts/exp_transpose.py``: can the slab be transposed on
chip, and at what cost per iteration?

    python -m vulkan_forge_torch.lab.slab_transpose [--device cuda|cpu]

``vf_lab_slab_transpose`` with ``iters=0`` is the script's ``k_correct``: a
(32, 128) -> (128, 32) transpose through shared memory, 32x32 tiles padded
against bank conflicts. With ``iters=4096`` it is ``k_loop``: iteration i
sums the (32, 128) slab at row 32*(i % 4) of a (128, 128) source over its
rows, through the padded transpose or without one. Prints the script's
lines: the transpose's check, then, on the card, the loop's nanoseconds per
iteration without and with the transpose (CUDA events around one launch,
median of 3, after a warm-up), with the card's name and power limit.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cli, _kernels

ITERS = 4096                    # scripts/exp_transpose.py:64


def correctness(device) -> bool:
    """scripts/exp_transpose.py:29-46."""
    src = torch.arange(32 * 128, dtype=torch.float32, device=device).reshape(32, 128)
    got = _kernels.slab_transpose(src).cpu().numpy()
    ok = bool(np.array_equal(got, src.cpu().numpy().T))
    print("in-kernel (32,128) transpose:", "OK" if ok else "WRONG")
    return ok


def loop_source(device="cpu") -> torch.Tensor:
    """scripts/exp_transpose.py:66: arange(4 * 32 * 128) as (128, 128)."""
    return torch.arange(4 * 32 * 128, dtype=torch.float32, device=device).reshape(128, 128)


def loop_ns(device, transpose: bool, iters: int = ITERS) -> float:
    """Nanoseconds per iteration of one k_loop launch on the card."""
    src = loop_source(device)
    return _cli.launch_ns(lambda: _kernels.slab_transpose(src, iters, transpose), iters)


def main(argv=None) -> int:
    _, device = _cli.parse(__doc__.splitlines()[0], argv)
    print(_cli.header(device))
    if not correctness(device):
        return 1
    for transpose in (False, True):
        what = f"loop {'with' if transpose else 'without'} transpose:"
        if device.type == "cuda":
            print(f"{what} {loop_ns(device, transpose):8.1f} ns/iter  ({_cli.card(device)})")
        else:
            print(f"{what} not measured (no card)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
