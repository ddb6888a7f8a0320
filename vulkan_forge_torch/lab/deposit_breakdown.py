"""Twin of ``scripts/exp_deposit_breakdown.py``: the deposit step taken
apart on one SM, and whether a product with a one-hot operand keeps f32
bits.

    python -m vulkan_forge_torch.lab.deposit_breakdown [--device cuda|cpu] [--nstep N]

Each body of the script (``v_eval`` .. ``v_full``: evaluation, the one-hot
build, the products, the gather-back, a transpose, the whole step) runs
4,096 steps in ``vf_lab_step_loop`` on the script's ``recs`` (seed 2, (32,
128)) from a zero scratch of (1024, 128): the script's lines, ``name: N
ns/step`` (CUDA events around one launch, median of 3 after a warm-up),
with the card's name and power limit. Then E_exact: the script's (80, 128)
values (seed 0, magnitudes e**-20..e**20) times a (128, 128) permutation
through ``vf_lab_onehot_dot`` in each mode: ``ffma`` (full float32, the
counterpart of HIGHEST), ``tf32`` (one tensor-core pass) and ``tf32x3``
(three); is every column bit-equal to its one contributor?
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cli, _kernels


def exact_inputs(device="cpu"):
    """exp_deposit_breakdown.py:199-204: vals (80, 128) float32 and a
    permutation P (128, 128) float32."""
    rng = np.random.default_rng(0)
    m, k, n = 80, 128, 128
    vals = (rng.standard_normal((m, k)) * np.exp(rng.uniform(-20, 20, (m, k)))).astype(np.float32)
    p = np.zeros((k, n), np.float32)
    p[np.arange(k), rng.permutation(k)] = 1.0
    return torch.from_numpy(vals).to(device), torch.from_numpy(p).to(device)


def single_contrib_mismatches(out: torch.Tensor, vals: torch.Tensor, p: torch.Tensor) -> int:
    """Elements of out's columns that differ from their one contributor's
    column of vals, bit for bit (P a permutation)."""
    got = out[:, p.argmax(dim=1)]
    return int((got.view(torch.int32) != vals.view(torch.int32)).sum())


def e_exact(device) -> dict:
    vals, p = exact_inputs(device)
    result = {}
    for mode in _kernels.DOT_MODES:
        bad = single_contrib_mismatches(_kernels.onehot_dot(vals, p, mode), vals, p)
        result[mode] = bad
        name = "HIGHEST" if mode == "ffma" else mode
        extra = "" if bad == 0 else f"  ({bad} of {vals.numel()} differ)"
        print(f"E_exact {name} single-contrib bitexact={bad == 0}{extra}")
    return result


def main(argv=None) -> int:
    args, device = _cli.loop_args(__doc__.splitlines()[0], argv)
    print(_cli.header(device))
    _cli.loop_lines("exp_deposit_breakdown", device, args.nstep)
    e_exact(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
