"""Build, binding, plain versions and wrappers of the lab kernels.

``csrc/lab.cu`` holds seven kernels, each the counterpart of TPU kernels
that a probe in ``scripts/`` launches (see the note at the top of that file):

  - ``fs_ops`` -> ``vf_lab_fs_ops``: ``scripts/exp_fs_ops.py:66-70``;
  - ``fs_chain`` -> ``vf_lab_fs_chain``: ``scripts/exp_fs_mosaic_ops.py:73-100``;
  - ``slab_copy`` -> ``vf_lab_slab_copy``: ``scripts/exp_lane_dma.py:24-30``;
  - ``slab_transpose`` -> ``vf_lab_slab_transpose``:
    ``scripts/exp_transpose.py:25-26`` (``iters=0``) and ``:48-61``; also
    ``exp_mosaic_facts.py``'s E2 (``:96-102``);
  - ``step_loop`` -> ``vf_lab_step_loop``: the loops of
    ``exp_deposit_breakdown.py:56``, ``exp_deposit3.py:46``,
    ``exp_deposit2.py:54``, ``exp_loop_floor.py:42`` and
    ``exp_mosaic_facts.py:228`` (E5), one body each (``_bodies.BODIES``);
  - ``onehot_dot`` -> ``vf_lab_onehot_dot``: ``exp_deposit_breakdown.py:221``
    (E_exact) and ``exp_mosaic_facts.py:61`` (E1);
  - ``lane_ops`` -> ``vf_lab_lane_ops``: ``exp_mosaic_facts.py:130`` (E3,
    ``roll``) and ``:155`` (E4, ``exponent``).

The source is compiled on first use with ``nvcc`` and the raster kernels'
flags (``kernels.NVCC_FLAGS``: ``-fmad=false``, no fast math) into a library
of its own, ``build/vulkan_forge_torch/libvf_lab_<hash>.so``, keyed by a hash
of ``lab.cu``, the header it includes and the flags; ``_build.py`` builds,
loads and binds it. A failed build raises.

Each wrapper takes a CPU tensor to its plain PyTorch version (``*_plain``
below) and launches the kernel for a CUDA tensor, or raises; it counts its
kernel launches in ``<wrapper>.launches``. Every launch goes through
``_build.launch``, the port's one launch path; the kernels that may take
more than 48 KB of shared memory are opted into it once per device
(``vf_lab_prepare``, ``_prepare``), before its first launch. So a small
kernel's call costs little more than its output's allocation and the
launch itself. Outputs are allocated with ``torch.empty``'s variants
that take the dtype and device from an input (``new_empty``,
``empty_like``): the same allocation, with less argument parsing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .._formats import pack_rgba_u32, srgb_encode
from .._raster import kernels
from . import _bodies

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCE = _CSRC / "lab.cu"
_HEADERS = (_CSRC / "raster_common.cuh",)

# scripts/exp_fs_ops.py:45-56, in its order (the kernel's op index).
OPS = ("sin", "cos", "sqrt", "inv_sqrt", "rsqrt", "pow_srgb", "exp", "log", "exp_log_pow")
# The rows of fs_chain's output: scripts/exp_fs_mosaic_ops.py:45-46's
# intermediates, then shade_shipped's word (as its bits).
CHAIN_NAMES = ("t", "xf", "frac", "c0", "c1", "lin", "dhdx", "dhdz", "inv_len", "lambert",
               "shade", "v", "s", "u8f")
CHAIN_ROWS = len(CHAIN_NAMES) + 1
SLAB = 128                      # the slab width: the TPU's 128 lanes
# An H100 block's shared memory (227 KB), which bounds the slabs' rows.
MAX_SMEM = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vf_lab_ops": [],
    "vf_lab_chain_rows": [],
    "vf_lab_fs_ops": [_P, _P, _P, ctypes.c_longlong, _I, _P, _P],
    "vf_lab_fs_chain": [_P, _P, _P, _P, _I, _P, _P, _P, _P],
    "vf_lab_slab_copy": [_P, _I, _I, _P, _P],
    "vf_lab_slab_transpose": [_P, _I, _I, _I, _I, _P, _P],
    "vf_lab_bodies": [],
    "vf_lab_step_loop": [_P, _P, _I, _I, _I, _P, _P],
    "vf_lab_onehot_dot": [_P, _P, _I, _I, _I, _P, _P],
    "vf_lab_lane_ops": [_P, _I, _I, _I, _I, _P, _P],
    "vf_lab_prepare": [],
}

BODIES = tuple(b.name for b in _bodies.BODIES)


def _contract():
    """What load() holds the built library to: (C getter, its source under
    csrc/, the Python constant it must equal, that constant's value)."""
    return (("vf_lab_ops", "lab.cu", "len(OPS)", len(OPS)),
            ("vf_lab_chain_rows", "lab.cu", "CHAIN_ROWS", CHAIN_ROWS),
            ("vf_lab_bodies", "lab.cu", "len(BODIES)", len(BODIES)))


_lib = None
_prepared = set()   # the device indices vf_lab_prepare has run on


def library_path() -> Path:
    return _build.library_path("lab", (_SOURCE,) + _HEADERS, kernels.NVCC_FLAGS)


def build() -> Path:
    """Compile csrc/lab.cu into its shared library unless it is already
    built; the ``-Xptxas -v`` report is kept as ``<library>.log``."""
    return _build.build(library_path(), (_SOURCE,), kernels.NVCC_FLAGS)


def load():
    """Build (if needed) and load the lab library; returns the CDLL."""
    global _lib
    if _lib is None:
        _lib = _build.load(build(), _SIGNATURES, "the lab kernels", _contract())
    return _lib


def _prepare(index: int) -> int:
    """Before device ``index``'s first launch (the current device), the
    kernels' shared-memory opt-ins; the CUDA error, 0 if none."""
    if index in _prepared:
        return 0
    err = _lib.vf_lab_prepare()
    if err == 0:
        _prepared.add(index)
    return err


def _check(name: str, t: torch.Tensor, dtype, dim: int, like=None) -> None:
    """Raise unless t is a contiguous ``dim``-D ``dtype`` tensor on the CPU
    or a CUDA device (the device of ``like``, if given)."""
    if t.dtype is not dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D {dtype}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not (t.is_cuda or t.is_cpu):
        raise ValueError(f"unsupported device {t.device}")
    if like is not None and t.get_device() != like.get_device():
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")


# ---------------- fs_ops ----------------

def fs_ops_plain(t: torch.Tensor, u: torch.Tensor, p: torch.Tensor, op: str) -> torch.Tensor:
    """The op of scripts/exp_fs_ops.py:45-56 named ``op`` in eager torch."""
    if op == "sin":
        return torch.sin(t * 1.3)
    if op == "cos":
        return torch.cos(t * 1.3)
    if op == "sqrt":
        return torch.sqrt(p)
    if op == "inv_sqrt":
        return 1.0 / torch.sqrt(p)
    if op == "rsqrt":
        return torch.rsqrt(p)
    if op == "pow_srgb":
        return torch.pow(u, 1.0 / 2.4)
    if op == "exp":
        return torch.exp(u * -3.0)
    if op == "log":
        return torch.log(p)
    if op == "exp_log_pow":
        return torch.exp(torch.log(torch.clamp_min(u, 1e-30)) * (1.0 / 2.4))
    raise ValueError(f"op must be one of {OPS}, got {op!r}")


def fs_ops(t: torch.Tensor, u: torch.Tensor, p: torch.Tensor, op: str) -> torch.Tensor:
    """One of the shader's transcendental ops, elementwise (exp_fs_ops.py's
    OPS): t, u, p contiguous float32 of one shape on one device.

    CPU tensors: ``fs_ops_plain``. CUDA tensors: ``vf_lab_fs_ops``.
    """
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    for name, a in (("t", t), ("u", u), ("p", p)):
        _check(name, a, torch.float32, a.dim(), t)
        if a.shape != t.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, t {tuple(t.shape)}")
    if not t.is_cuda:
        return fs_ops_plain(t, u, p, op)
    out = torch.empty_like(t)
    if t.numel():
        _build.launch(fs_ops, load().vf_lab_fs_ops, t, t.data_ptr(), u.data_ptr(), p.data_ptr(),
                      t.numel(), OPS.index(op), out.data_ptr(), prepare=_prepare)
    return out


fs_ops.launches = 0


# ---------------- fs_chain ----------------

def fs_chain_plain(hh, xx, zz, channel, lut, par) -> torch.Tensor:
    """The shipped shader's chain in eager torch, in the op order and the
    shapes of ``fragment.terrain_fs`` (per-pixel ops over (P,), per-channel
    ops over (P, 3)), each channel's row gathered at ``channel``. Returns
    (CHAIN_ROWS, P) float32; the last row is ``terrain_fs``'s word for the
    pixel, as its bits."""
    hr2, exposure, l0, l1, l2 = par
    t = torch.clamp(0.5 + hh / hr2, 0.0, 1.0)
    xf = t * 256.0 - 0.5
    x0 = torch.floor(xf)
    frac = xf - x0
    i0 = torch.clamp(x0, 0, 255).to(torch.long)
    i1 = torch.clamp(x0 + 1.0, 0, 255).to(torch.long)
    c0, c1 = lut[i0], lut[i1]
    lin = c0 * (1.0 - frac[:, None]) + c1 * frac[:, None]
    dhdx = 1.3 * torch.cos(xx * 1.3) * 0.25
    dhdz = -1.1 * torch.sin(zz * 1.1) * 0.25
    inv_len = 1.0 / torch.sqrt(dhdx * dhdx + 1.0 + dhdz * dhdz)
    lambert = torch.clamp((-dhdx * l0 + l1 - dhdz * l2) * inv_len, 0.0, 1.0)
    shade = 0.15 + 0.85 * lambert
    rgb = lin * exposure * shade[:, None]
    v = torch.clamp(rgb, 0.0, 1.0)
    s = srgb_encode(rgb)
    u8f = torch.floor(torch.clamp(s, 0.0, 1.0) * 255.0 + 0.5)
    one = torch.ones_like(s[:, 0])
    word = pack_rgba_u32(s[:, 0], s[:, 1], s[:, 2], one).view(torch.int32)
    pick = lambda a: a.gather(1, channel.to(torch.long)[:, None])[:, 0]
    rows = [t, xf, frac, pick(c0), pick(c1), pick(lin), dhdx, dhdz, inv_len, lambert,
            shade, pick(v), pick(s), pick(u8f), word.view(torch.float32)]
    return torch.stack(rows)


def fs_chain(hh: torch.Tensor, xx: torch.Tensor, zz: torch.Tensor, channel: torch.Tensor,
             lut: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """The shipped shader's intermediates at P pixels: hh, xx, zz (P,)
    float32 varyings, channel (P,) int32 in 0..2 (the LUT channel each row
    follows), lut (256, 3) float32 linear, par (5,) from ``kernels.shading_params``.
    Returns (CHAIN_ROWS, P) float32: the rows of CHAIN_NAMES, then the
    pixel's packed RGBA word as its bits.

    CPU tensors: ``fs_chain_plain``. CUDA tensors: ``vf_lab_fs_chain``, whose
    last row is ``vf::shade_shipped``'s own word.
    """
    for name, a in (("hh", hh), ("xx", xx), ("zz", zz)):
        _check(name, a, torch.float32, 1, hh)
        if a.shape != hh.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, hh {tuple(hh.shape)}")
    _check("channel", channel, torch.int32, 1, hh)
    if channel.shape != hh.shape:
        raise ValueError(f"channel has shape {tuple(channel.shape)}, hh {tuple(hh.shape)}")
    _check("lut", lut, torch.float32, 2, hh)
    if lut.shape != (256, 3):
        raise ValueError(f"lut must be (256, 3), got {tuple(lut.shape)}")
    _check("par", par, torch.float32, 1, hh)
    if par.shape != (5,):
        raise ValueError(f"par must be (5,) [hr2, exposure, l0, l1, l2], got {tuple(par.shape)}")
    if channel.numel() and (int(channel.min()) < 0 or int(channel.max()) > 2):
        raise ValueError("channel must lie in 0..2")
    if hh.numel() >= 2**31:
        raise ValueError("at most 2**31 - 1 pixels")
    if not hh.is_cuda:
        return fs_chain_plain(hh, xx, zz, channel, lut, par)
    out = hh.new_empty((CHAIN_ROWS, hh.numel()))
    if hh.numel():
        _build.launch(fs_chain, load().vf_lab_fs_chain, hh, hh.data_ptr(), xx.data_ptr(),
                      zz.data_ptr(), channel.data_ptr(), hh.numel(), lut.data_ptr(),
                      par.data_ptr(), out.data_ptr(), prepare=_prepare)
    return out


fs_chain.launches = 0


# ---------------- slab_copy ----------------

def slab_copy_plain(src: torch.Tensor) -> torch.Tensor:
    """scripts/exp_lane_dma.py:53-54's ``want`` in torch: the 128-column
    slabs of src stacked, times 2."""
    return src.unflatten(1, (-1, SLAB)).transpose(0, 1).reshape(-1, SLAB) * 2.0


def slab_copy(src: torch.Tensor) -> torch.Tensor:
    """(rows, N) float32, N a multiple of 128 -> (rows * N / 128, 128): slab
    i of src (columns 128i..128i+127) times 2 at rows [i*rows, (i+1)*rows).

    CPU tensors: ``slab_copy_plain``. CUDA tensors: ``vf_lab_slab_copy`` (a
    slab's rows * 512 bytes must fit a block's shared memory).
    """
    _check("src", src, torch.float32, 2)
    rows, cols = src.shape
    if cols % SLAB:
        raise ValueError(f"src has {cols} columns, not a multiple of {SLAB}")
    if not src.is_cuda:
        return slab_copy_plain(src)
    if rows * SLAB * 4 > MAX_SMEM:
        raise ValueError(f"a slab of {rows} rows exceeds a block's {MAX_SMEM} bytes of "
                         "shared memory")
    if src.data_ptr() % 16:
        raise ValueError("src must start on a 16-byte boundary (cp.async copies 16 bytes)")
    out = src.new_empty((rows * cols // SLAB, SLAB))
    if out.numel():
        _build.launch(slab_copy, load().vf_lab_slab_copy, src, src.data_ptr(), rows, cols,
                      out.data_ptr(), prepare=_prepare)
    return out


slab_copy.launches = 0


# ---------------- slab_transpose ----------------

def slab_transpose_plain(src: torch.Tensor, iters: int = 0,
                         transpose: bool = True) -> torch.Tensor:
    """k_correct (iters = 0: src.T) and k_loop (iters > 0) of
    scripts/exp_transpose.py in eager torch."""
    if iters == 0:
        return src.T.contiguous()
    S = src.shape[0] // 4
    acc = torch.zeros((1, src.shape[1]), dtype=torch.float32, device=src.device)
    for i in range(iters):
        v = src[S * (i % 4):S * (i % 4 + 1)]
        acc = acc + (v.T.sum(dim=1) if transpose else v.sum(dim=0)).reshape(1, -1)
    return acc


def slab_transpose(src: torch.Tensor, iters: int = 0, transpose: bool = True) -> torch.Tensor:
    """iters = 0: (rows, cols) float32 -> src.T (cols, rows), through 32x32
    tiles in shared memory. iters > 0: rows a multiple of 4, cols <= 1024;
    iteration i sums the (rows/4, cols) slab at row (rows/4)*(i % 4) over its
    rows, after a transpose in shared memory (``transpose``) or without one,
    into a (1, cols) float32 accumulator.

    CPU tensors: ``slab_transpose_plain``. CUDA tensors:
    ``vf_lab_slab_transpose``.
    """
    _check("src", src, torch.float32, 2)
    rows, cols = src.shape
    if iters < 0 or iters >= 2**31:
        raise ValueError(f"iters must lie in [0, 2**31), got {iters}")
    if iters:
        if rows % 4 or rows == 0:
            raise ValueError(f"the loop takes 4 slabs: rows must be a positive multiple "
                             f"of 4, got {rows}")
        if cols > 1024:
            raise ValueError(f"the loop takes one thread per column: at most 1024, got {cols}")
    if not src.is_cuda:
        return slab_transpose_plain(src, iters, transpose)
    if iters and (rows * cols + cols * (rows // 4 + 1)) * 4 > MAX_SMEM:
        raise ValueError(f"a ({rows}, {cols}) source and its slab's tile exceed a block's "
                         f"{MAX_SMEM} bytes of shared memory")
    shape = (1, cols) if iters else (cols, rows)
    out = src.new_empty(shape)
    if src.numel():
        _build.launch(slab_transpose, load().vf_lab_slab_transpose, src, src.data_ptr(), rows,
                      cols, iters, 1 if transpose else 0, out.data_ptr(), prepare=_prepare)
    return out


slab_transpose.launches = 0


# ---------------- step_loop ----------------

def _step_checks(body: str, big: torch.Tensor, nstep: int, scratch):
    if body not in _bodies.BY_NAME:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    spec = _bodies.BY_NAME[body]
    script = _bodies.SCRIPTS[spec.script]
    _check("big", big, torch.float32, 2)
    if big.shape != (script["big"], _bodies.LANES):
        raise ValueError(f"{body} takes big of ({script['big']}, 128) as "
                         f"scripts/{spec.script}.py does, got {tuple(big.shape)}")
    if nstep < 0 or nstep >= 2**31 or nstep % spec.unroll:
        raise ValueError(f"nstep must be a multiple of {spec.unroll} in [0, 2**31), got {nstep}")
    shape = (script["scratch"], _bodies.LANES)
    if scratch is None:
        return torch.zeros(shape, dtype=torch.float32, device=big.device)
    _check("scratch", scratch, torch.float32, 2, big)
    if scratch.shape != shape:
        raise ValueError(f"{body}'s scratch is {shape}, got {tuple(scratch.shape)}")
    return scratch.clone()


def step_loop_plain(body: str, big: torch.Tensor, nstep: int, scratch=None):
    """``_bodies.run`` on a copy of the scratch (zeros if None): (out (8,
    128), final scratch)."""
    acc = _step_checks(body, big, nstep, scratch)
    return _bodies.run(body, big, nstep, acc), acc


def step_loop(body: str, big: torch.Tensor, nstep: int, scratch=None):
    """nstep steps of one deposit-probe body (``BODIES``: the scripts' names)
    over big, float32 (rows, 128) with the script's rows
    (``_bodies.SCRIPTS``), from a copy of ``scratch`` (the script's (rows,
    128) float32; zeros if None). Returns (out (8, 128), final scratch).
    nstep must be a multiple of the body's unroll (c_u4: 4).

    CPU tensors: ``step_loop_plain``. CUDA tensors: ``vf_lab_step_loop``, one
    block on one SM.
    """
    acc = _step_checks(body, big, nstep, scratch)
    if not big.is_cuda:
        return _bodies.run(body, big, nstep, acc), acc
    out = big.new_empty((_bodies.TILE, _bodies.LANES))
    _build.launch(step_loop, load().vf_lab_step_loop, big, big.data_ptr(), acc.data_ptr(),
                  acc.shape[0], BODIES.index(body), nstep // _bodies.BY_NAME[body].unroll,
                  out.data_ptr(), prepare=_prepare)
    return out, acc


step_loop.launches = 0


# ---------------- onehot_dot ----------------

DOT_MODES = ("ffma", "tf32", "tf32x3")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 in torch: x to 10 mantissa bits, to nearest, ties
    away from zero (add half of the 13 dropped bits' unit to the magnitude's
    bits, then drop them)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_parts(x: torch.Tensor):
    """x as hi + mid + lo, each on the tf32 grid (the kernel's split): each
    part rounds what the ones before left; the three cover 24 bits."""
    hi = tf32_round(x)
    mid = tf32_round(x - hi)
    return hi, mid, tf32_round((x - hi) - mid)


def onehot_dot_plain(a: torch.Tensor, b: torch.Tensor, mode: str = "ffma") -> torch.Tensor:
    """The kernel's products in eager torch, summed in k order from the k =
    0 product (``_bodies.mm``): ffma on the operands; tf32 on both rounded
    to tf32; tf32x3 on a's three parts and b rounded, the three results
    added (hi + mid) + lo. The tensor cores sum a k = 8 step in an order of
    their own; where a column sums more than one nonzero term, the kernel
    is held to this within its tolerance (``DOT_TOLERANCE``)."""
    if mode == "ffma":
        return _bodies.mm(a, b)
    bt = tf32_round(b)
    if mode == "tf32":
        return _bodies.mm(tf32_round(a), bt)
    hi, mid, lo = tf32_parts(a)
    return (_bodies.mm(hi, bt) + _bodies.mm(mid, bt)) + _bodies.mm(lo, bt)


# |kernel - plain| <= DOT_TOLERANCE * sum_k |a_ik| |b_kj| (tf32 modes; ffma: 0).
DOT_TOLERANCE = 1e-5


def onehot_dot(a: torch.Tensor, b: torch.Tensor, mode: str = "ffma") -> torch.Tensor:
    """a (m, 128) @ b (128, n), float32, 1 <= m, n <= 128: ``ffma`` (CUDA
    cores, full float32: HIGHEST), ``tf32`` (one TF32 ``mma.sync`` pass: the
    default precision) or ``tf32x3`` (a split into three tf32 parts, three
    passes added in float32).

    CPU tensors: ``onehot_dot_plain``. CUDA tensors: ``vf_lab_onehot_dot``,
    spread over the card (ffma: a thread per output; tf32 modes: a warp per
    16 x 8 output tile).
    """
    if mode not in DOT_MODES:
        raise ValueError(f"mode must be one of {DOT_MODES}, got {mode!r}")
    _check("a", a, torch.float32, 2)
    _check("b", b, torch.float32, 2, a)
    m, k = a.shape
    n = b.shape[1]
    if k != 128 or b.shape[0] != 128 or not (1 <= m <= 128 and 1 <= n <= 128):
        raise ValueError(f"takes (m, 128) @ (128, n) with 1 <= m, n <= 128, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if not a.is_cuda:
        return onehot_dot_plain(a, b, mode)
    out = a.new_empty((m, n))
    _build.launch(onehot_dot, load().vf_lab_onehot_dot, a, a.data_ptr(), b.data_ptr(), m, n,
                  DOT_MODES.index(mode), out.data_ptr(), prepare=_prepare)
    return out


onehot_dot.launches = 0


# ---------------- lane_ops ----------------

LANE_OPS = ("roll", "exponent")


def lane_ops_plain(x: torch.Tensor, op: str, shift: int = 0) -> torch.Tensor:
    """roll: ``torch.roll(x, shift, 1)`` (np.roll's rule); exponent:
    ``((bits >> 23) & 0xFF) - 127`` of each element, as float32."""
    if op == "roll":
        return torch.roll(x, shift, 1)
    return _bodies.exponent(x)


def lane_ops(x: torch.Tensor, op: str, shift: int = 0) -> torch.Tensor:
    """E3 and E4 of exp_mosaic_facts.py over the rows of x, (rows, cols)
    float32, cols <= 1024: ``roll`` x's columns by ``shift``
    (``out[:, (c + shift) % cols] = x[:, c]``) or take each element's
    ``exponent``.

    CPU tensors: ``lane_ops_plain``. CUDA tensors: ``vf_lab_lane_ops``, one
    block per row.
    """
    if op not in LANE_OPS:
        raise ValueError(f"op must be one of {LANE_OPS}, got {op!r}")
    _check("x", x, torch.float32, 2)
    rows, cols = x.shape
    if cols > 1024:
        raise ValueError(f"one thread per column: at most 1024, got {cols}")
    if not x.is_cuda:
        return lane_ops_plain(x, op, shift)
    out = torch.empty_like(x)
    if x.numel():
        _build.launch(lane_ops, load().vf_lab_lane_ops, x, x.data_ptr(), rows, cols,
                      LANE_OPS.index(op), shift % cols, out.data_ptr(), prepare=_prepare)
    return out


lane_ops.launches = 0

LAUNCHED = (fs_ops, fs_chain, slab_copy, slab_transpose, step_loop, onehot_dot, lane_ops)
