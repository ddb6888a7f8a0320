"""Twin of ``scripts/exp_loop_floor.py``: the per-iteration floor of a
loop body on one SM.

    python -m vulkan_forge_torch.lab.loop_floor [--device cuda|cpu] [--nstep N]

Each body (a scalar carry; a dynamic (32, 128) read; read-modify-writes at
a fixed and at a dynamic offset, by ``%`` and by ``&``; that step unrolled
x4 and x8; the 4-slot evaluation unrolled x1, x4 and x8) runs 4,096
logical steps in ``vf_lab_step_loop`` on the script's input (seed 2, (512,
128)) from a zero scratch of (768, 128). Prints the script's lines, ``name:
N ns/logical-step (M ns/iter)`` (CUDA events around one launch, median of
3 after a warm-up), with the card's name and power limit. The floor bounds
what a dependent step of the segment kernels' row loop can cost.
"""
from __future__ import annotations

from . import _cli


def main(argv=None) -> int:
    return _cli.loop_twin(__doc__.splitlines()[0], "exp_loop_floor", argv)


if __name__ == "__main__":
    raise SystemExit(main())
