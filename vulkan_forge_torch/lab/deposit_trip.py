"""Twin of ``scripts/exp_deposit3.py``: the deposit trip's real costs per
step, over 65,536 steps, on one SM.

    python -m vulkan_forge_torch.lab.deposit_trip [--device cuda|cpu] [--nstep N]

Each body (``d_base``: the dynamic slice and read-modify-write floor;
``d_strips``: a strips visit, 8 triangles at a tile row; ``d_eval4``: the
4-slot evaluation; ``d_mm``: the products; ``d_full``: the whole trip) runs
in ``vf_lab_step_loop`` on the script's input (seed 2, (1024, 128) x 0.1)
from a zero scratch of (768, 128). Prints the script's lines, ``name: N
ns/step`` (CUDA events around one launch, median of 3 after a warm-up),
with the card's name and power limit.
"""
from __future__ import annotations

from . import _cli


def main(argv=None) -> int:
    return _cli.loop_twin(__doc__.splitlines()[0], "exp_deposit3", argv)


if __name__ == "__main__":
    raise SystemExit(main())
