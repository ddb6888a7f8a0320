"""Twin of ``scripts/exp_fs_ops.py``: the shipped shader's transcendental
ops on the card, bit for bit against the plain versions and against f64.

    python -m vulkan_forge_torch.lab.fs_ops [--device cuda|cpu]

Each op of ``OPS`` runs on the script's inputs (``make_inputs``: 32,768
values, seed 7) through ``vf_lab_fs_ops`` and through its plain version
(``_kernels.fs_ops_plain``) on the same device. One line per op: the
kernel's mismatches and largest ulp distance against the plain version (as
the script compares its Pallas kernel with XLA), then the largest ulp
distance of each from the f64 result rounded to float32. On the card the
kernel must stay within the CUDA C++ Programming Guide's maximum ulp error
for the function it ends in (``GUIDE``); the line says so.

The f64 reference takes the op's last function in float64 on the float32
argument the op hands it (the products ``t * 1.3f`` and ``u * -3.0f`` are
correctly rounded float32 on both sides), rounded to float32. For
``exp_log_pow`` that argument holds the side's own ``logf`` (its ``log`` op
on ``max(u, 1e-30)``), which is held to ``logf``'s row on its own. ulp
distances are taken on the ordered integers of the float32 bits, so a
distance across zero counts the floats between.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cli, _kernels
from ._kernels import OPS

ROWS, LANES = 256, 128
N = ROWS * LANES

# The CUDA C++ Programming Guide, "Mathematical Functions", the table of
# single-precision standard library functions with their maximum ulp error:
# op -> (ulp, the row it rests on). nvcc's defaults (-prec-div=true,
# -prec-sqrt=true, no fast math) give x/y and sqrtf 0 ulp, so 1.0f / sqrtf
# is correctly rounded twice and must equal f32(1 / f32(sqrt(p))).
GUIDE = {
    "sin": (2, "sinf(x): 2"),
    "cos": (2, "cosf(x): 2"),
    "sqrt": (0, "sqrtf(x): 0 (-prec-sqrt=true)"),
    "inv_sqrt": (0, "x/y: 0 (-prec-div=true), on sqrtf(x): 0"),
    "rsqrt": (2, "rsqrtf(x): 2"),
    "pow_srgb": (4, "powf(x,y): 4"),
    "exp": (2, "expf(x): 2"),
    "log": (1, "logf(x): 1"),
    "exp_log_pow": (2, "expf(x): 2, on its own logf(x): 1"),
}


def make_inputs():
    """scripts/exp_fs_ops.py:33-42: (t, u, p), each (256, 128) float32."""
    rng = np.random.default_rng(7)
    # sin/cos args: world x,z up to +-16 scaled by 1.3 -> +-21
    trig = rng.uniform(-21.0, 21.0, N).astype(np.float32)
    # pow/sqrt args: linear rgb values and 1+slope^2 terms
    unit = rng.uniform(0.0, 1.0, N).astype(np.float32)
    unit[:8] = [0.0, 1.0, 0.0031308, 0.0031309, 0.5, 0.25, 1e-6, 0.99999]
    pos = (1.0 + rng.uniform(0.0, 4.0, N) ** 2).astype(np.float32)
    return (trig.reshape(ROWS, LANES), unit.reshape(ROWS, LANES),
            pos.reshape(ROWS, LANES))


def ulp(a, b) -> np.ndarray:
    """|a - b| in float32 ulps (int64), over the ordered integers of the bits."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def f64_reference(op: str, t, u, p, inner=None) -> np.ndarray:
    """The op's last function in float64 on its float32 argument, rounded to
    float32; ``inner`` is the side's own log of max(u, 1e-30) (exp_log_pow)."""
    f32, f64 = np.float32, np.float64
    g = f32(1.0 / 2.4)
    if op in ("sin", "cos"):
        x = (t * f32(1.3)).astype(f64)
        out = np.sin(x) if op == "sin" else np.cos(x)
    elif op == "sqrt":
        out = np.sqrt(p.astype(f64))
    elif op == "inv_sqrt":
        out = 1.0 / np.sqrt(p.astype(f64)).astype(f32).astype(f64)
    elif op == "rsqrt":
        out = 1.0 / np.sqrt(p.astype(f64))
    elif op == "pow_srgb":
        out = np.power(u.astype(f64), f64(g))
    elif op == "exp":
        out = np.exp((u * f32(-3.0)).astype(f64))
    elif op == "log":
        out = np.log(p.astype(f64))
    elif op == "exp_log_pow":
        out = np.exp((np.asarray(inner, f32) * g).astype(f64))
    else:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    return out.astype(f32)


def measure(device) -> list:
    """One dict per op on the script's inputs: the kernel (the wrapper on
    ``device``) against the plain version on the same device, and each
    against f64."""
    t, u, p = make_inputs()
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tt, ut, pt = dev(t), dev(u), dev(p)
    m = np.maximum(u, np.float32(1e-30))        # exp_log_pow's log argument
    host = lambda a: a.cpu().numpy()
    rows = []
    for op in OPS:
        got = host(_kernels.fs_ops(tt, ut, pt, op))
        plain = host(_kernels.fs_ops_plain(tt, ut, pt, op))
        d = ulp(got, plain)
        row = {"op": op, "n": int(got.size), "mismatches": int((d != 0).sum()),
               "max_ulp": int(d.max())}
        if op == "exp_log_pow":
            inner_got = host(_kernels.fs_ops(tt, ut, dev(m), "log"))
            inner_plain = host(_kernels.fs_ops_plain(tt, ut, dev(m), "log"))
            ref_log = f64_reference("log", t, u, m)
            row["inner_log_kernel_vs_f64"] = int(ulp(inner_got, ref_log).max())
            row["inner_log_plain_vs_f64"] = int(ulp(inner_plain, ref_log).max())
            ref_got = f64_reference(op, t, u, p, inner_got)
            ref_plain = f64_reference(op, t, u, p, inner_plain)
        else:
            ref_got = ref_plain = f64_reference(op, t, u, p)
        kd, pd = ulp(got, ref_got), ulp(plain, ref_plain)
        row.update(kernel_vs_f64=int(kd.max()), kernel_vs_f64_misses=int((kd != 0).sum()),
                   plain_vs_f64=int(pd.max()), plain_vs_f64_misses=int((pd != 0).sum()),
                   guide_ulp=GUIDE[op][0], guide_row=GUIDE[op][1])
        rows.append(row)
    return rows


def within_guide(row) -> bool:
    """The kernel's op (and exp_log_pow's inner logf) within the guide's bound."""
    ok = row["kernel_vs_f64"] <= row["guide_ulp"]
    if "inner_log_kernel_vs_f64" in row:
        ok = ok and row["inner_log_kernel_vs_f64"] <= GUIDE["log"][0]
    return ok


def line(row, on_card: bool) -> str:
    """The script's line for one op, then the f64 comparison."""
    s = (f"{row['op']:12s} mismatches={row['mismatches']:7d}/{row['n']}  "
         f"max_ulp={row['max_ulp']}" + ("  BIT-EXACT" if row["mismatches"] == 0 else ""))
    s += (f"  | vs f64: kernel max_ulp={row['kernel_vs_f64']} "
          f"({row['kernel_vs_f64_misses']} differ), plain max_ulp={row['plain_vs_f64']} "
          f"({row['plain_vs_f64_misses']} differ)")
    if "inner_log_kernel_vs_f64" in row:
        s += (f"; its logf: kernel {row['inner_log_kernel_vs_f64']}, "
              f"plain {row['inner_log_plain_vs_f64']}")
    if on_card:
        s += (f"  | guide {row['guide_row']}: "
              + ("within" if within_guide(row) else "EXCEEDED"))
    return s


def main(argv=None) -> int:
    _, device = _cli.parse(__doc__.splitlines()[0], argv)
    print(_cli.header(device))
    for row in measure(device):
        print(line(row, device.type == "cuda"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
