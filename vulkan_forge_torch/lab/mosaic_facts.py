"""Twin of ``scripts/exp_mosaic_facts.py``: the deposit kernel's five
hardware facts, asked of Hopper.

    python -m vulkan_forge_torch.lab.mosaic_facts [--device cuda|cpu] [--nstep N]

  - E1: (96, 128) @ (128, 128) with a random one-hot right operand (lanes
    collide) and a row 0 of powers of two, through ``vf_lab_onehot_dot`` in
    each mode (``ffma``: full float32; ``tf32``: one tensor-core pass, the
    counterpart of the default precision; ``tf32x3``: three). Is every
    single-contributor column bit-exact, and the bitmask row's sums exact?
  - E2: (1, 128), (8, 128) and (32, 128) transposed on the card
    (``vf_lab_slab_transpose``, iters 0).
  - E3: an (8, 128) lane roll by 5 (``vf_lab_lane_ops``), against np.roll.
  - E4: the exponent bits of (8, 128) sums of distinct powers of two
    (``vf_lab_lane_ops``), against floor(log2).
  - E5: the full deposit step, 2,048 steps in ``vf_lab_step_loop``.

Prints the script's lines with each time on the card (per call: CUDA
events over 5 x 20 calls after 2; E5: one launch, median of 3 after a
warm-up), with the card's name and power limit. E2's and E3's inputs are
seeded here (the script draws them from numpy's global state).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cli, _kernels

SCRIPT = "exp_mosaic_facts"
ROLL = 5                                  # exp_mosaic_facts.py:124


def e1_inputs(device="cpu"):
    """exp_mosaic_facts.py:46-56: vals (96, 128) float32, row 0 the powers
    2**rel, and a one-hot P (128, 128) with random (colliding) lanes."""
    rng = np.random.default_rng(0)
    m, k, n = 96, 128, 128
    vals = rng.standard_normal((m, k)).astype(np.float32) * np.exp(
        rng.uniform(-20, 20, (m, k))).astype(np.float32)
    rels = rng.integers(0, 24, k)
    vals[0, :] = (2.0 ** rels).astype(np.float32)
    p = np.zeros((k, n), np.float32)
    p[np.arange(k), rng.integers(0, n, k)] = 1.0
    return torch.from_numpy(vals).to(device), torch.from_numpy(p).to(device)


def e1_facts(out: torch.Tensor, vals: torch.Tensor, p: torch.Tensor) -> dict:
    """exp_mosaic_facts.py:70-89: single-contributor columns bit-exact; the
    bitmask row equal to its sums taken in float64, rounded once."""
    vals_np, p_np, out_np = (t.cpu().numpy() for t in (vals, p, out))
    lanes = p_np.argmax(axis=1)
    counts = p_np.sum(axis=0)
    single = [n for n in range(p_np.shape[1]) if counts[n] == 1]
    bad = sum(int((out_np[:, n].view(np.uint32)
                   != vals_np[:, int(np.argmax(p_np[:, n]))].view(np.uint32)).sum())
              for n in single)
    bm_ref = np.zeros(p_np.shape[1])
    for k, n in enumerate(lanes):
        bm_ref[n] += float(vals_np[0, k])
    bm_bad = int((out_np[0] != bm_ref.astype(np.float32)).sum())
    return {"single_columns": len(single), "single_mismatches": bad,
            "bitmask_mismatches": bm_bad}


def e4_inputs(device="cpu") -> torch.Tensor:
    """exp_mosaic_facts.py:161-167: (8, 128) sums of 1-4 distinct powers
    2**0 .. 2**23."""
    rng = np.random.default_rng(1)
    masks = np.zeros((8, 128), np.float32)
    for i in range(8):
        for j in range(128):
            nbits = rng.integers(1, 5)
            rels = rng.choice(24, nbits, replace=False)
            masks[i, j] = np.sum(2.0 ** rels)
    return torch.from_numpy(masks).to(device)


def _us(device, fn) -> str:
    if device.type != "cuda":
        return "not measured (no card)"
    return f"{_cli.cuda_ms(fn) * 1e3:.1f} us/call"


def main(argv=None) -> int:
    args, device = _cli.loop_args(__doc__.splitlines()[0], argv)
    print(_cli.header(device))
    vals, p = e1_inputs(device)
    for mode in _kernels.DOT_MODES:
        f = e1_facts(_kernels.onehot_dot(vals, p, mode), vals, p)
        print(f"E1 dot(96,128)@(128,128) {mode}: "
              f"{_us(device, lambda mode=mode: _kernels.onehot_dot(vals, p, mode))}, "
              f"single-contrib bitexact={f['single_mismatches'] == 0}, "
              f"bitmask exact={f['bitmask_mismatches'] == 0}  "
              f"({f['single_mismatches']} mismatches in {f['single_columns']} single columns, "
              f"{f['bitmask_mismatches']} in the bitmask row)")
    rng = np.random.default_rng(3)
    for shape in [(1, 128), (8, 128), (32, 128)]:
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)
        ok = bool(torch.equal(_kernels.slab_transpose(x), x.T))
        print(f"E2 transpose {shape}: {_us(device, lambda x=x: _kernels.slab_transpose(x))}, "
              f"correct={ok}")
    x = torch.from_numpy(np.random.default_rng(4).random((8, 128), dtype=np.float32)).to(device)
    ok = np.array_equal(_kernels.lane_ops(x, "roll", ROLL).cpu().numpy(),
                        np.roll(x.cpu().numpy(), ROLL, axis=1))
    print(f"E3 lane roll: {_us(device, lambda: _kernels.lane_ops(x, 'roll', ROLL))}, "
          f"correct={ok}")
    masks = e4_inputs(device)
    ref = np.floor(np.log2(masks.cpu().numpy())).astype(np.float32)
    ok = np.array_equal(_kernels.lane_ops(masks, "exponent").cpu().numpy(), ref)
    print(f"E4 exponent extract: {_us(device, lambda: _kernels.lane_ops(masks, 'exponent'))}, "
          f"correct={ok}")
    _cli.loop_lines(SCRIPT, device, args.nstep)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
