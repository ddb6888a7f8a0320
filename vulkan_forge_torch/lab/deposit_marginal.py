"""Twin of ``scripts/exp_deposit2.py``: the marginal cost of each deposit
component on loop-variant operands, one component at a time, on one SM.

    python -m vulkan_forge_torch.lab.deposit_marginal [--device cuda|cpu] [--nstep N]

Each body (``b_base`` .. ``b_full``) runs 4,096 steps in
``vf_lab_step_loop`` on the script's input (seed 2, (512, 128)) from a zero
scratch of (768, 128). ``b_full``'s gather-back at ``exp_deposit2.py:207``
contracts an (8, 1) with a (128, 128) and does not trace; this one takes
the stand-in its comment names, ``py * 0.001`` broadcast to (8, 128), times
``P.T`` (``_bodies``). Prints the script's lines, ``name: N ns/step``
(CUDA events around one launch, median of 3 after a warm-up), with the
card's name and power limit.
"""
from __future__ import annotations

from . import _cli


def main(argv=None) -> int:
    return _cli.loop_twin(__doc__.splitlines()[0], "exp_deposit2", argv)


if __name__ == "__main__":
    raise SystemExit(main())
