"""Twin of ``scripts/exp_lane_dma.py``: can a kernel copy a 128-column slab
of a wide row-major array into on-chip memory asynchronously?

    python -m vulkan_forge_torch.lab.slab_copy [--device cuda|cpu]

``vf_lab_slab_copy`` gives block i the slab ``src[:, 128i:128i+128]``, which
it copies into shared memory with ``cp.async`` 16-byte copies, one commit
group and a wait (the script's ``make_async_copy`` + ``start``/``wait``),
then writes ``slab * 2`` to output rows ``[i*rows, (i+1)*rows)``. Prints the
script's line (the output against its ``want``), then, on the card, the
kernel's and the plain version's milliseconds at the script's shape.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cli, _kernels

ROWS, NLANES = 32, 1024          # scripts/exp_lane_dma.py:34


def source(rows: int = ROWS, nlanes: int = NLANES, device="cpu") -> torch.Tensor:
    """The script's src: arange(rows * nlanes) as (rows, nlanes) float32."""
    return torch.arange(rows * nlanes, dtype=torch.float32, device=device).reshape(rows, nlanes)


def want(src: np.ndarray) -> np.ndarray:
    """scripts/exp_lane_dma.py:53-54."""
    rows, nlanes = src.shape
    return src.reshape(rows, nlanes // 128, 128).transpose(1, 0, 2).reshape(-1, 128) * 2.0


def main(argv=None) -> int:
    _, device = _cli.parse(__doc__.splitlines()[0], argv)
    print(_cli.header(device))
    src = source(device=device)
    got = _kernels.slab_copy(src).cpu().numpy()
    match = bool(np.array_equal(got, want(src.cpu().numpy())))
    print("lane-sliced DMA OK, match:", match)
    if device.type == "cuda":
        ms = _cli.cuda_ms(lambda: _kernels.slab_copy(src))
        plain = _cli.cuda_ms(lambda: _kernels.slab_copy_plain(src))
        print(f"slab copy ({ROWS}, {NLANES}): kernel {ms:.6f} ms, plain {plain:.6f} ms per call "
              f"(CUDA events, median of 5 x 20 calls; {_cli.card(device)})")
    else:
        print(f"slab copy ({ROWS}, {NLANES}): times not measured (no card)")
    return 0 if match else 1


if __name__ == "__main__":
    raise SystemExit(main())
