"""The loop bodies of the TPU deposit probes, in plain PyTorch: one step
function per body of ``scripts/exp_deposit_breakdown.py``,
``exp_deposit3.py``, ``exp_deposit2.py``, ``exp_loop_floor.py`` and
``exp_mosaic_facts.py`` (E5), each the counterpart of a case of
``vf_lab_step_loop`` in ``csrc/lab.cu``, in the same order (``BODIES``).

Each script runs its body NSTEP times inside one Pallas kernel over an
input ``big`` (the scripts' ``recs``/``big``, float32 (rows, 128)) and a
float32 scratch of (rows, 128), carrying an (8, 128) tile (breakdown) or a
float32 scalar (the others), and writes an (8, 128) output. Here a step is
a function of the loop state ``_State`` and the step index; the ops are the
scripts' own, in their order, each rounded once in float32, so that the
kernel, built with ``-fmad=false``, gives these values bit for bit:

  - the products (``hi_dot``: ``precision=HIGHEST``; E5's default
    precision) are full float32 sums of products taken in ``k`` order from
    the ``k = 0`` product (``mm``), the order of the kernel's loop;
  - rows of a product that the body never reads are not computed: they
    cannot change a result;
  - ``jnp.exp2(rel)`` of the integer ``rel`` in 0..23 is the exact power
    2**rel, built from its bits (XLA:CPU's exp2 misses 2**13, 2**15, ...,
    2**23, by up to 3.5 at 2**23);
  - a slice of the scratch that runs past its last row starts at the last
    row that fits (XLA's dynamic-slice clamp, what the scripts do in
    Pallas's interpret mode; the TPU checks no bound and writes past the
    scratch's end), for reads and writes alike: ``exp_deposit3.py:134``
    (``d_strips``) and ``:205`` (``d_full``), ``exp_deposit2.py:218``
    (``b_full``);
  - the scratch starts as the caller's tensor, zeros by default: on the TPU
    it starts as whatever VMEM held;
  - ``exp_deposit2.py:207`` (``b_full``) contracts an (8, 1) with a (128,
    128) and does not trace; this ``b_full`` takes the (8, 128) stand-in its
    comment names, ``py * 0.001`` broadcast to (8, 128), times ``P.T``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

LANES = 128
TILE = 8                        # the rows of the working tile


# ---------------- the shared helpers ----------------

@dataclass
class _State:
    big: torch.Tensor           # (rows, 128) float32, read only
    acc: torch.Tensor           # the scratch, (rows, 128) float32, updated in place
    tile: torch.Tensor          # breakdown's (8, 128) carry
    scalar: torch.Tensor        # the other scripts' scalar carry (0-d float32)
    dy: torch.Tensor            # (8, 1) float32 iota
    xio: torch.Tensor           # (128,) float32 iota
    grp: torch.Tensor           # (128,) int64: lane // 24
    pw: torch.Tensor            # (128,) float32: 2**(lane - 24*grp)
    mm: Callable                # the product: ``mm`` (or ``mm_magnitude``)


def new_state(big: torch.Tensor, acc: torch.Tensor, product: Callable = None) -> _State:
    """The loop state over big and the scratch acc; ``product`` is
    ``mm`` unless given."""
    dev = big.device
    lane = torch.arange(LANES, device=dev)
    grp = lane // 24
    rel = (lane - grp * 24).to(torch.int32)
    return _State(big=big, acc=acc,
                  tile=torch.zeros((TILE, LANES), dtype=torch.float32, device=dev),
                  scalar=torch.zeros((), dtype=torch.float32, device=dev),
                  dy=torch.arange(TILE, dtype=torch.float32, device=dev)[:, None],
                  xio=lane.to(torch.float32), grp=grp,
                  pw=((rel + 127) << 23).view(torch.float32), mm=product or mm)


def rows(st: _State, start: int, n: int = TILE) -> slice:
    """The scratch rows [start, start + n), the start clamped to the last
    that fits (XLA's dynamic-slice rule)."""
    start = min(start, st.acc.shape[0] - n)
    return slice(start, start + n)


def recs_of(st: _State, i: int) -> torch.Tensor:
    """``big[(i % 8) * 32 : +32]``: the step's 32 record rows."""
    off = (i % 8) * 32
    return st.big[off:off + 32]


def py_of(st: _State, i: int):
    """(py, ty): the tile row's pixel centres (8, 1) and ``i % 64``."""
    ty = i % 64
    return st.dy + float(ty * 8) + 0.5, ty


def eval_slot(recs: torch.Tensor, py: torch.Tensor, s: int, kind: str):
    """(cov, a0, a1, a2, aw) of slot s, each (8, 128). ``kind``: "edges"
    (breakdown, E5: three edge tests), "aw" (deposit2, loop_floor: and
    ``az >= 0, aw > 0, aw - az >= 0``) or "asum" (deposit3: and ``az >= 0,
    aw > 0, asum - az >= 0``)."""
    def col(k):
        return recs[k]
    px = col(25) + (s + 0.5)
    f0 = col(2) * (px - col(0)) - col(3) * (py - col(1))
    f1 = col(6) * (px - col(4)) - col(7) * (py - col(5))
    f2 = col(10) * (px - col(8)) - col(11) * (py - col(9))
    aw = f0 * col(21) + f1 * col(22) + f2 * col(23)
    cov = (f0 >= 0.) & (f1 >= 0.) & (f2 >= 0.)
    if kind != "edges":
        az = f0 * col(25) + f1 * col(26) + f2 * col(27)
        last = aw - az if kind == "aw" else (f0 * col(28) + f1 * col(29) + f2 * col(30)) - az
        cov = cov & (az >= 0.) & (aw > 0.) & (last >= 0.)
    a0 = f0 * col(12) + f1 * col(13) + f2 * col(14)
    a1 = f0 * col(15) + f1 * col(16) + f2 * col(17)
    a2 = f0 * col(18) + f1 * col(19) + f2 * col(20)
    return cov.to(torch.float32), a0, a1, a2, aw


def onehot(st: _State, col: torch.Tensor, s: float = 0.0) -> torch.Tensor:
    """``((colT + s) == xio)`` as float32 (128, 128): row k is one at lane
    ``col[k] + s``."""
    return ((col[:, None] + s) == st.xio[None, :]).to(torch.float32)


def exponent(x: torch.Tensor) -> torch.Tensor:
    """``((bits >> 23) & 0xFF) - 127`` of x's float32 bits, as float32."""
    return (((x.view(torch.int32) >> 23) & 0xFF) - 127).to(torch.float32)


def winner(st: _State, wa: torch.Tensor, init: float) -> torch.Tensor:
    """The winning lane of each pixel from the 6 bitmask groups of wa (48,
    128): the exponent of the last group's sum that is above zero, plus
    24 * group; ``init`` where none is."""
    win = torch.full((TILE, LANES), init, dtype=torch.float32, device=wa.device)
    for g in range(6):
        gm = wa[g * 8:(g + 1) * 8]
        win = torch.where(gm > 0, exponent(gm) + g * 24.0, win)
    return win


def bitmask_rows(st: _State, cov: torch.Tensor, g: int) -> torch.Tensor:
    """``cov * pw * (grp == g)``: group g's rows of the bitmask LHS."""
    return (cov * st.pw) * (st.grp == g).to(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) in full float32: every product rounded,
    then summed in k order from the k = 0 product (the kernel's order)."""
    prods = a.unsqueeze(-1) * b.unsqueeze(-3)
    out = prods[..., 0, :]
    for k in range(1, a.shape[-1]):
        out = out + prods[..., k, :]
    return out


def mm_magnitude(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k |a_ik| |b_kj|: the scale of mm's rounding, for its tolerance."""
    return mm(a.abs(), b.abs())


# ---------------- exp_deposit_breakdown.py (main, :92-195) ----------------

def v_eval(st, i):
    py, _ = py_of(st, i)
    tot = st.tile
    for s in range(4):
        cov, a0, a1, a2, aw = eval_slot(st.big, py, s, "edges")
        tot = tot + cov * a0 + a1 + a2 * aw
    st.tile = tot


def v_pbuild(st, i):
    tot = st.tile
    for s in range(4):
        tot = tot + onehot(st, st.big[25, :TILE], float(s))
    st.tile = tot


def v_tr(st, i):
    st.tile = st.tile + (st.big[25, :TILE] + float(i))[:, None]


def v_mm4(st, i):
    tot = st.tile
    for s in range(4):
        tot = tot + st.mm(st.acc[0:TILE], st.acc[128 + 128 * s:256 + 128 * s])
    st.tile = tot


def v_mm1(st, i):
    # (lhsT (512, M)).T @ acc[0:512]; rows 0..7 are read: the same for M = 80 and 48.
    st.tile = st.tile + st.mm(st.acc[0:512, 0:TILE].T, st.acc[0:512])


v_mm48 = v_mm1


def v_gb(st, i):
    pt = st.acc[0:128]
    w = st.mm(st.acc[0:TILE], pt)
    for _ in range(3):
        w = st.mm(w, pt)
    st.tile = st.tile + w


def v_full(st, i):
    py, ty = py_of(st, i)
    acc, col = st.acc, st.big[25]
    for s in range(4):
        cov, a0, a1, a2, aw = eval_slot(st.big, py, s, "edges")
        for g in range(6):
            r = 150 + s * 48 + g * 8
            acc[r:r + 8] = bitmask_rows(st, cov, g)
        acc[350:478] = onehot(st, col, float(s))
    pa = acc[350:478]
    win = winner(st, st.mm(acc[150:198], pa), 0.0)
    kill = torch.zeros_like(win)
    for _ in range(4):
        kill = kill + st.mm(win, pa)
    wb = st.mm(acc[150:158], pa)
    sl = rows(st, ty * 8)
    cur = acc[sl]
    acc[sl] = torch.where(win > cur, win, cur)
    st.tile = st.tile + wb + kill


# ---------------- exp_deposit3.py (:62-177) ----------------

def d_base(st, i):
    recs = recs_of(st, i)
    py, ty = py_of(st, i)
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + recs[0:TILE] + py


def d_strips(st, i):
    rec = recs_of(st, i)[0:TILE]                 # 8 triangles' records

    def col(k):
        return rec[:, k].reshape(1, TILE, 1)
    py, ty = py_of(st, i)
    px = st.xio.reshape(1, 1, LANES) + 0.5
    py3 = py.reshape(TILE, 1, 1)
    f0 = col(2) * (px - col(0)) - col(3) * (py3 - col(1))
    f1 = col(6) * (px - col(4)) - col(7) * (py3 - col(5))
    f2 = col(10) * (px - col(8)) - col(11) * (py3 - col(9))
    a0 = f0 * col(12) + f1 * col(13) + f2 * col(14)
    a1 = f0 * col(15) + f1 * col(16) + f2 * col(17)
    a2 = f0 * col(18) + f1 * col(19) + f2 * col(20)
    aw = f0 * col(21) + f1 * col(22) + f2 * col(23)
    az = f0 * col(25) + f1 * col(26) + f2 * col(27)
    asum = f0 * col(28) + f1 * col(29) + f2 * col(30)
    cov = ((f0 >= 0.) & (f1 >= 0.) & (f2 >= 0.) & (az >= 0.)
           & (aw > 0.) & (asum - az >= 0.))
    ids = torch.arange(TILE, dtype=torch.float32, device=rec.device).reshape(1, TILE, 1)
    cids = torch.where(cov, ids, -1.0)
    wid = cids.amax(dim=1, keepdim=True)
    sel = ((cids == wid) & cov).to(torch.float32)
    sums = []
    for a in (a0, a1, a2, aw):                   # over the 8 triangles, in order
        prod = a * sel
        c = torch.zeros((TILE, LANES), dtype=torch.float32, device=rec.device)
        for t in range(TILE):
            c = c + prod[:, t]
        sums.append(c)
    cid = wid[:, 0, :]
    acc = st.acc
    sl = rows(st, ty * 8)
    better = cid > acc[sl]
    acc[sl] = torch.where(better, cid, acc[sl])
    for k, c in enumerate(sums):
        s2 = rows(st, ty * 8 + 128 * (k + 1))
        acc[s2] = torch.where(better, c, acc[s2])


def _eval4(st, recs, py, kind):
    tot = torch.zeros((TILE, LANES), dtype=torch.float32, device=recs.device)
    for s in range(4):
        cov, a0, a1, a2, aw = eval_slot(recs, py, s, kind)
        tot = tot + cov * a0 + a1 * a2 + aw
    return tot


def d_eval4(st, i):
    recs = recs_of(st, i)
    py, ty = py_of(st, i)
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + _eval4(st, recs, py, "asum")


def d_mm(st, i):
    py, ty = py_of(st, i)
    off = (i % 4) * 128
    lhs = st.big[off:off + TILE]                 # lhsA[0:8] == lhsB[0:8]
    wa = wb = gb = torch.zeros((TILE, LANES), dtype=torch.float32, device=lhs.device)
    for s in range(4):
        p = st.big[off + s:off + s + 128]
        wa = wa + st.mm(lhs, p)
        wb = wb + st.mm(lhs, p)
        gb = gb + st.mm(wa, p)
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + wa + wb + gb


def _full(st, i, kind):
    """d_full (kind "asum") and b_full (kind "aw"): the whole deposit trip."""
    recs = recs_of(st, i)
    py, ty = py_of(st, i)
    acc, col = st.acc, recs[25]
    dev = recs.device
    wa = torch.zeros((48, LANES), dtype=torch.float32, device=dev)
    wb = kill = torch.zeros((TILE, LANES), dtype=torch.float32, device=dev)
    for s in range(4):
        cov, a0, a1, a2, aw = eval_slot(recs, py, s, kind)
        for g in range(6):
            acc[96 + g * 8:104 + g * 8] = bitmask_rows(st, cov, g)
        p = onehot(st, col, float(s))
        wa = wa + st.mm(acc[96:144], p)
        acc[160:168] = cov * a0
        acc[168:176] = cov * a1
        acc[176:184] = cov * a2
        acc[184:192] = cov * aw
        wb = wb + st.mm(acc[160:168], p)
        if kind == "asum":
            kill = kill + st.mm(wa[0:TILE], p)
        else:                                    # the stand-in of exp_deposit2.py:207
            kill = kill + st.mm((py * 0.001).expand(TILE, LANES), p.T)
    win = winner(st, wa, -1.0)
    sl = rows(st, ty * 8)
    cur = acc[sl]
    if kind == "asum":
        better = win + kill * 0 > cur
        acc[sl] = torch.where(better, win, cur)
    else:
        better = win > cur
        acc[sl] = torch.where(better, win + kill * 0, cur)
    s2 = rows(st, ty * 8 + 512)
    acc[s2] = torch.where(better, wb, acc[s2])


def d_full(st, i):
    _full(st, i, "asum")


# ---------------- exp_deposit2.py (:85-222) ----------------

b_base = d_base


def b_eval1(st, i):
    recs = recs_of(st, i)
    py, ty = py_of(st, i)
    cov, a0, a1, a2, aw = eval_slot(recs, py, 0, "aw")
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + cov * a0 + a1 * a2 + aw


def b_eval4(st, i):
    recs = recs_of(st, i)
    py, ty = py_of(st, i)
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + _eval4(st, recs, py, "aw")


def b_bm(st, i):
    recs = recs_of(st, i)
    py, ty = py_of(st, i)
    acc = st.acc
    for s in range(4):
        cov = eval_slot(recs, py, s, "aw")[0]
        for g in range(6):
            acc[64 + g * 8:72 + g * 8] = bitmask_rows(st, cov, g)
    sl = rows(st, ty * 8)
    acc[sl] = acc[sl] + acc[64:72]


def b_tr(st, i):
    recs = recs_of(st, i)
    py, ty = py_of(st, i)
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + recs[25, :TILE, None] + py


def b_p1(st, i):
    recs = recs_of(st, i)
    py, ty = py_of(st, i)
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + onehot(st, recs[25, :TILE]) + py


def b_mma(st, i):
    py, ty = py_of(st, i)
    off = (i % 4) * 128
    w = st.mm(st.big[off:off + TILE], st.big[off:off + 128])
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + w + py


def b_full(st, i):
    _full(st, i, "aw")


# ---------------- exp_loop_floor.py (:73-125) ----------------

def c_scalar(st, i):
    st.scalar = st.scalar + float(i % 64)


def c_slice(st, i):
    st.scalar = st.scalar + st.big[(i % 8) * 32, 0]


def c_rmwf(st, i):
    st.acc[0:TILE] = st.acc[0:TILE] + recs_of(st, i)[0:TILE]


def c_rmwd(st, i):
    sl = rows(st, (i % 64) * 8)
    st.acc[sl] = st.acc[sl] + recs_of(st, i)[0:TILE]


def c_rmwd_and(st, i):
    off = (i & 7) * 32
    sl = rows(st, (i & 63) * 8)
    st.acc[sl] = st.acc[sl] + st.big[off:off + TILE]


def c_eval4(st, i):
    recs = recs_of(st, i)
    py, ty = py_of(st, i)
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + _eval4(st, recs, py, "aw")


# ---------------- exp_mosaic_facts.py E5 (:186-211) ----------------

def e5(st, i):
    py, ty = py_of(st, i)
    col = st.big[25]
    lhs, ps = [], []
    for s in range(4):
        cov, a0, a1, a2, aw = eval_slot(st.big, py, s, "edges")
        lhs.append(cov * a0)                     # LHS rows 0..7 == rows 40..47
        ps.append(onehot(st, col, float(s)))
    w = st.mm(torch.stack(lhs), torch.stack(ps))  # the four slots' W[0:8], side by side
    total = torch.zeros((TILE, LANES), dtype=torch.float32, device=col.device)
    for s in range(4):
        total = total + w[s] + w[s]
    sl = rows(st, ty * 8)
    st.acc[sl] = st.acc[sl] + total


# ---------------- the table ----------------

@dataclass(frozen=True)
class Body:
    name: str                   # the script's name for it
    script: str                 # scripts/<script>.py
    label: str                  # what the script prints before ": N ns/step"
    step: Callable
    unroll: int = 1             # logical steps per loop iteration


# Per script: its NSTEP, its scratch rows, its carry ("tile", "scalar" or
# "none": E5 writes the scratch's rows 0..7) and the rows of its input.
SCRIPTS = {
    "exp_deposit_breakdown": {"nstep": 4096, "scratch": 1024, "carry": "tile", "big": 32},
    "exp_deposit3": {"nstep": 65536, "scratch": 768, "carry": "scalar", "big": 1024},
    "exp_deposit2": {"nstep": 4096, "scratch": 768, "carry": "scalar", "big": 512},
    "exp_loop_floor": {"nstep": 4096, "scratch": 768, "carry": "scalar", "big": 512},
    "exp_mosaic_facts": {"nstep": 2048, "scratch": 512, "carry": "none", "big": 32},
}

_BD, _D3, _D2, _LF = "exp_deposit_breakdown", "exp_deposit3", "exp_deposit2", "exp_loop_floor"
# In csrc/lab.cu's order (enum Body).
BODIES = (
    Body("v_eval", _BD, "v_eval   (4 slots eval only)", v_eval),
    Body("v_pbuild", _BD, "v_pbuild (4x onehot build + T)", v_pbuild),
    Body("v_tr", _BD, "v_tr     ((1,128)->(128,1) transpose)", v_tr),
    Body("v_mm4", _BD, "v_mm4    (4x (80,128)@(128,128))", v_mm4),
    Body("v_mm1", _BD, "v_mm1    ((80,512)T@(512,128))", v_mm1),
    Body("v_mm48", _BD, "v_mm48   ((48,512)T@(512,128))", v_mm48),
    Body("v_gb", _BD, "v_gb     (4x (8,128)@(128,128))", v_gb),
    Body("v_full", _BD, "v_full   (eval+P+A+GB+B+extract+merge)", v_full),
    Body("d_base", _D3, "d_base  ", d_base),
    Body("d_strips", _D3, "d_strips", d_strips),
    Body("d_eval4", _D3, "d_eval4 ", d_eval4),
    Body("d_mm", _D3, "d_mm    ", d_mm),
    Body("d_full", _D3, "d_full  ", d_full),
    Body("b_base", _D2, "b_base  (dyn slice + dyn RMW)", b_base),
    Body("b_eval1", _D2, "b_eval1 (+1-slot eval)", b_eval1),
    Body("b_eval4", _D2, "b_eval4 (+4-slot eval)", b_eval4),
    Body("b_bm", _D2, "b_bm    (eval4 + 24 bitmask stores)", b_bm),
    Body("b_tr", _D2, "b_tr    (+transpose (1,128)->(128,1))", b_tr),
    Body("b_p1", _D2, "b_p1    (+transpose + 1 P build)", b_p1),
    Body("b_mmA", _D2, "b_mmA   (+(48,128)@(128,128) mm)", b_mma),
    Body("b_full", _D2, "b_full  (everything, 12 mm)", b_full),
    Body("c_scalar", _LF, "c_scalar  ", c_scalar),
    Body("c_slice", _LF, "c_slice   ", c_slice),
    Body("c_rmwf", _LF, "c_rmwf    ", c_rmwf),
    Body("c_rmwd", _LF, "c_rmwd    ", c_rmwd),
    Body("c_rmwd_and", _LF, "c_rmwd_and", c_rmwd_and),
    Body("c_u4", _LF, "c_u4      ", c_rmwd, 4),
    Body("c_u8", _LF, "c_u8      ", c_rmwd, 8),
    Body("c_eval4_u1", _LF, "c_eval4_u1", c_eval4, 1),
    Body("c_eval4_u4", _LF, "c_eval4_u4", c_eval4, 4),
    Body("c_eval4_u8", _LF, "c_eval4_u8", c_eval4, 8),
    Body("e5", "exp_mosaic_facts", "E5 deposit step (128tri x 4slot x 8dy + 4 matmuls)", e5),
)
BY_NAME = {b.name: b for b in BODIES}


def script_big(script: str, device="cpu") -> torch.Tensor:
    """The script's input, from its seed: ``default_rng(2)``'s standard
    normals as float32 (rows, 128) (times 0.1 in exp_deposit3.py), row 25
    the integers 0..123 the one-hot builds read (exp_deposit3.py:43-45,
    exp_deposit2.py:51-53, exp_loop_floor.py:39-41, the ``recs`` of
    exp_deposit_breakdown.py:53-55 and exp_mosaic_facts.py:224-226)."""
    rng = np.random.default_rng(2)
    big = rng.standard_normal((SCRIPTS[script]["big"], LANES)).astype(np.float32)
    if script == "exp_deposit3":
        big = big * 0.1
    big[25] = rng.integers(0, 124, LANES).astype(np.float32)
    return torch.from_numpy(big).to(device)
# The bodies whose products sum float32 values that round: their results
# depend on the order of the sums, and are held to another order within
# 1e-5 of each element's scale (``run(..., product=mm_magnitude)``). The
# other products (v_full, d_full, b_full: bitmasks of distinct powers of
# two, small integers, one contributor) are exact in any order, except
# rows 512.. of d_full's and b_full's scratch (WB) where lanes collide.
SCALED = frozenset({"v_mm4", "v_mm1", "v_mm48", "v_gb", "d_mm", "b_mmA", "e5"})


def run(name: str, big: torch.Tensor, nstep: int, scratch: torch.Tensor,
        product: Callable = mm):
    """nstep logical steps of body ``name`` (nstep // unroll iterations of
    ``unroll`` steps), the scratch updated in place. Returns the (8, 128)
    output: carry + scratch rows 0..7 (breakdown), scratch rows 0..7 +
    carry (the scalar carries) or scratch rows 0..7 (E5).

    ``product=mm_magnitude`` (from the scratch's magnitudes) gives each
    element's scale for the bodies of ``SCALED``: every product replaced by
    the sum of its terms' magnitudes."""
    body = BY_NAME[name]
    st = new_state(big, scratch, product)
    for it in range(nstep // body.unroll):
        for j in range(body.unroll):
            body.step(st, it * body.unroll + j)
    carry = SCRIPTS[body.script]["carry"]
    if carry == "tile":
        return st.tile + st.acc[0:TILE]
    if carry == "scalar":
        return st.acc[0:TILE] + st.scalar
    return st.acc[0:TILE].clone()
