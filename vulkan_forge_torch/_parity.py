"""The parity contract between the port and the JAX reference (ROADMAP
queue 3), as checks shared by the tests and ``chip_smoke.py``.

  - Coverage masks must be identical.
  - G-buffer varyings: |a - b| <= 1e-5 * max(1, |b|). XLA:CPU contracts
    multiply-adds the port computes with two roundings.
  - u8 images, the FS policy (tests/test_resident.py:32-42): every
    differing byte is off by exactly 1, on at most 1e-4 of the bytes;
    sin, cos and pow differ by ulps between math libraries.
"""
from __future__ import annotations

import numpy as np
import torch

VARYING_RTOL = 1e-5
FS_MAX_FRACTION = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x))


def assert_fs_policy(img_a, img_b, label: str = "image"):
    """Images byte-equal up to the FS rounding policy.

    Accepts (H, W, 4) uint8 or (..., H, W) uint32 words (numpy or torch).
    Returns (max byte delta, fraction of differing bytes).
    """
    a = _np(img_a).view(np.uint8).astype(np.int32)
    b = _np(img_b).view(np.uint8).astype(np.int32)
    if a.shape != b.shape:
        raise AssertionError(f"{label}: shapes {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    worst = int(d.max(initial=0))
    frac = float((d > 0).mean()) if d.size else 0.0
    if worst > 1:
        raise AssertionError(f"{label}: byte delta {worst} exceeds the 1-u8 FS policy")
    if frac > FS_MAX_FRACTION:
        raise AssertionError(f"{label}: {frac:.2e} of bytes differ "
                             f"(policy bound {FS_MAX_FRACTION})")
    return worst, frac


def assert_gbuffer_close(got, want, label: str = "gbuffer") -> float:
    """(v0, v1, v2, mask) against a reference g-buffer: masks identical,
    varyings within VARYING_RTOL. Returns the max |difference|."""
    mask_a, mask_b = _np(got[3]).astype(bool), _np(want[3]).astype(bool)
    if mask_a.shape != mask_b.shape:
        raise AssertionError(f"{label}: mask shapes {mask_a.shape} vs {mask_b.shape}")
    if not np.array_equal(mask_a, mask_b):
        n = int((mask_a != mask_b).sum())
        raise AssertionError(f"{label}: {n} coverage pixels differ")
    worst = 0.0
    for k, (a, b) in enumerate(zip(got[:3], want[:3])):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        d = np.abs(a - b)
        bound = VARYING_RTOL * np.maximum(1.0, np.abs(b))
        if not np.all(d <= bound):
            raise AssertionError(f"{label}: varying {k} differs by {d.max()} "
                                 f"(bound {VARYING_RTOL}*max(1,|x|))")
        worst = max(worst, float(d.max(initial=0.0)))
    return worst
