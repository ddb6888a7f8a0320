"""The lab twins (``vulkan_forge_torch/lab``) against the TPU probe scripts
they port (``scripts/exp_fs_ops.py``, ``exp_fs_mosaic_ops.py``,
``exp_lane_dma.py``, ``exp_transpose.py``), run here on the CPU: the plain
versions with numpy inputs from the scripts' seeds, the scripts' JAX code
on the CPU (the Pallas kernel of exp_fs_mosaic_ops in interpret mode), and
the four CLIs. The cases marked ``gpu`` hold each kernel to its plain
version on the card; they skip without one. jax is imported inside the
tests that use it, so that ``python3 -m pytest -m gpu
tests/test_torch_lab.py`` runs on the card host, which has none.
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import io
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from vulkan_forge_torch import _build, _colormap
from vulkan_forge_torch._raster import fragment, kernels
from vulkan_forge_torch.lab import _kernels, fs_chain, fs_ops, slab_copy, slab_transpose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    """Load scripts/<name>.py as a module, from its path."""
    spec = importlib.util.spec_from_file_location(f"_lab_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lab kernels have no CPU mode")
    return torch.device("cuda")


# ---------------- inputs ----------------

def test_inputs_equal_the_scripts():
    ops = _script("exp_fs_ops")
    for a, b in zip(fs_ops.make_inputs(), ops.make_inputs()):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (256, 128)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert fs_ops.OPS == tuple(ops.OPS)
    chain = _script("exp_fs_mosaic_ops")
    assert fs_chain.PIXELS == chain.PIXELS


def test_chain_inputs_equal_the_script():
    import jax.numpy as jnp
    from vulkan_forge import _colormap as ref_colormap
    lut, lut_rgb, par = fs_chain.script_inputs("cpu")
    want = np.asarray(ref_colormap.build_lut("terrain")[0], np.float32)
    np.testing.assert_array_equal(lut.numpy().view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(lut_rgb.numpy(), want[:, :3])
    # exp_fs_mosaic_ops.py:40-42, in jnp.
    sun = jnp.asarray([0.35, 0.9, 0.2], jnp.float32)
    hr2 = 2.0 * jnp.maximum(jnp.float32(1.0), 1e-8)
    l = sun / jnp.sqrt(jnp.sum(sun * sun))
    script = np.array([hr2, 1.1, *np.asarray(l)], np.float32)
    np.testing.assert_array_equal(par.numpy().view(np.uint32), script.view(np.uint32))


# ---------------- fs_ops ----------------

# Largest ulp distance between the plain op on torch-CPU and jax.jit of the
# script's op on jax-CPU, on the script's 32,768 inputs, as measured with
# torch 2.13.0+cpu and jax 0.9.0.
JAX_ULP = {"sin": 1, "cos": 1, "sqrt": 1, "inv_sqrt": 2, "rsqrt": 2, "pow_srgb": 1, "exp": 1,
           "log": 1, "exp_log_pow": 3}


@pytest.mark.parametrize("op", fs_ops.OPS)
def test_fs_ops_plain_matches_jax(op):
    import jax
    script = _script("exp_fs_ops")
    t, u, p = fs_ops.make_inputs()
    want = np.asarray(jax.jit(script.OPS[op])(t, u, p))
    got = _kernels.fs_ops(*(torch.from_numpy(a) for a in (t, u, p)), op).numpy()
    assert got.shape == want.shape == (256, 128) and got.dtype == np.float32
    assert int(fs_ops.ulp(got, want).max()) <= JAX_ULP[op]


def test_torch_cpu_sqrt_is_not_correctly_rounded():
    # The f64 square root rounded to f32 is the correctly rounded result.
    # jax-CPU's sqrt gives it on every input of exp_fs_ops.py; torch-CPU's
    # vectorised sqrt misses it by 1 ulp on 210 (torch 2.13.0+cpu).
    import jax.numpy as jnp
    _, _, p = fs_ops.make_inputs()
    exact = np.sqrt(p.astype(np.float64)).astype(np.float32)
    torch_miss = fs_ops.ulp(torch.sqrt(torch.from_numpy(p)).numpy(), exact)
    jax_miss = fs_ops.ulp(np.asarray(jnp.sqrt(p)), exact)
    assert int(jax_miss.max()) == 0
    assert (int((torch_miss != 0).sum()), int(torch_miss.max())) == (210, 1), \
        f"torch {torch.__version__}: {int((torch_miss != 0).sum())} misses"


def test_fs_ops_reference_and_table():
    rows = fs_ops.measure(torch.device("cpu"))
    assert [r["op"] for r in rows] == list(fs_ops.OPS)
    for r in rows:
        # On the CPU the wrapper is the plain version.
        assert r["mismatches"] == 0 and r["max_ulp"] == 0 and r["n"] == 256 * 128
        assert r["kernel_vs_f64"] == r["plain_vs_f64"] <= 2
    by = {r["op"]: r for r in rows}
    assert by["sqrt"]["plain_vs_f64_misses"] == 210
    assert by["exp_log_pow"]["inner_log_plain_vs_f64"] <= 1
    # The reference is correctly rounded where the op is: numpy's f32 sqrt.
    _, _, p = fs_ops.make_inputs()
    np.testing.assert_array_equal(fs_ops.f64_reference("sqrt", None, None, p), np.sqrt(p))
    np.testing.assert_array_equal(fs_ops.f64_reference("inv_sqrt", None, None, p),
                                  np.float32(1.0) / np.sqrt(p))
    assert fs_ops.ulp(np.float32(-0.0), np.float32(0.0)).max() == 0
    assert fs_ops.ulp(np.float32(-1e-45), np.float32(1e-45)).max() == 2


# ---------------- fs_chain ----------------

@pytest.fixture(scope="module")
def script_chain_bits():
    """{pixel: {row: (mosaic bits, xla bits)}} as exp_fs_mosaic_ops.main()
    prints them on the CPU, its Pallas kernel in interpret mode (~15 s)."""
    from jax.experimental import pallas as pl
    script = _script("exp_fs_mosaic_ops")
    orig = pl.pallas_call
    pl.pallas_call = lambda *a, **k: orig(*a, interpret=True, **k)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            script.main()
    finally:
        pl.pallas_call = orig
    bits, cur = {}, None
    for ln in out.getvalue().splitlines():
        if ln.startswith("pixel "):
            cur = bits.setdefault(ln.split()[1], {})
            continue
        m = re.match(r"\s+(\w+)\s+mosaic=\S+ (0x[0-9a-f]+)\s+xla=\S+ (0x[0-9a-f]+)", ln)
        cur[m.group(1)] = (int(m.group(2), 16), int(m.group(3), 16))
    return bits


# ulps between the plain chain (torch-CPU, two pixels) and the script's xla=
# and mosaic= bits, as measured. t..c1 are exact ops. lin: XLA:CPU fuses
# c0*(1-frac) + c1*frac into a multiply-add (xla= 1 ulp at A, mosaic= 0);
# inv_len: the script's lax.rsqrt against 1/sqrt (1 ulp at A), which lambert,
# v and s carry (1 ulp at A); shade: XLA fuses 0.15 + 0.85*lambert (2 ulp
# at A with lambert's, 1 at B).
CHAIN_ULP = {"t": 0, "xf": 0, "frac": 0, "c0": 0, "c1": 0, "lin": 1, "dhdx": 0, "dhdz": 0,
             "inv_len": 1, "lambert": 1, "shade": 2, "v": 1, "s": 1, "u8f": 0}


@pytest.mark.parametrize("k,label", [(0, "A"), (1, "B")])
def test_fs_chain_plain_matches_script(script_chain_bits, k, label):
    assert set(CHAIN_ULP) == set(_kernels.CHAIN_NAMES)
    _, lut_rgb, par = fs_chain.script_inputs("cpu")
    cols = [np.array([p[i] for p in fs_chain.PIXELS], np.float32 if i < 3 else np.int32)
            for i in range(4)]
    got = _kernels.fs_chain(*(torch.from_numpy(a) for a in cols), lut_rgb, par).numpy()
    assert got.shape == (_kernels.CHAIN_ROWS, 2)
    for i, name in enumerate(_kernels.CHAIN_NAMES):
        for which, want in zip(("mosaic", "xla"), script_chain_bits[label][name]):
            d = int(fs_ops.ulp(got[i, k], np.array(want, np.uint32).view(np.float32)).max())
            assert d <= CHAIN_ULP[name], f"pixel {label} {name} vs {which}: {d} ulp"
    byte = fs_chain.word_byte(got[-1, k], int(cols[3][k]))
    assert byte == got[_kernels.CHAIN_NAMES.index("u8f"), k]


def test_fs_chain_plain_equals_terrain_fs():
    rng = np.random.default_rng(11)
    P = 4096
    hh = rng.uniform(-0.7, 0.7, P).astype(np.float32)
    xx = rng.uniform(-16.0, 16.0, P).astype(np.float32)
    zz = rng.uniform(-16.0, 16.0, P).astype(np.float32)
    ch = rng.integers(0, 3, P).astype(np.int32)
    lut = torch.from_numpy(np.asarray(_colormap.build_lut("viridis")[0], np.float32))
    h_range, exposure = torch.tensor(0.8), torch.tensor(1.3)
    sun = torch.tensor([-0.3, 0.8, 0.5])
    par = kernels.shading_params(h_range, exposure, sun)
    t = [torch.from_numpy(a) for a in (hh, xx, zz, ch)]
    chain = _kernels.fs_chain(*t, lut[:, :3].contiguous(), par).numpy()
    words = fragment.terrain_fs(t[0], t[1], t[2], torch.ones(P, dtype=torch.bool), lut,
                                h_range, exposure, sun).view(torch.int32).numpy()
    want = (words.view(np.uint32) >> (8 * ch.astype(np.uint32))) & 0xFF
    np.testing.assert_array_equal(chain[_kernels.CHAIN_NAMES.index("u8f")], want)
    np.testing.assert_array_equal(chain[-1].view(np.int32), words)


def test_fs_chain_checks():
    _, lut_rgb, par = fs_chain.script_inputs("cpu")
    f = torch.zeros(3)
    ch = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="lut"):
        _kernels.fs_chain(f, f, f, ch, torch.zeros(256, 4), par)
    with pytest.raises(ValueError, match="0..2"):
        _kernels.fs_chain(f, f, f, ch + 3, lut_rgb, par)
    with pytest.raises(ValueError, match="channel"):
        _kernels.fs_chain(f, f, f, ch.long(), lut_rgb, par)
    with pytest.raises(ValueError, match="op must be"):
        _kernels.fs_ops(f, f, f, "tan")


# ---------------- slab copy and transpose ----------------

def _script_want(src):
    """exp_lane_dma.py:53-54, as the script writes it."""
    rows, nlanes = src.shape
    return np.asarray(src).reshape(rows, nlanes // 128, 128) \
        .transpose(1, 0, 2).reshape(-1, 128) * 2.0


@pytest.mark.parametrize("shape", [(32, 1024), (8, 384)])
def test_slab_copy_plain_equals_script(shape):
    src = slab_copy.source(*shape)
    got = _kernels.slab_copy(src).numpy()
    assert got.shape == (shape[0] * shape[1] // 128, 128)
    np.testing.assert_array_equal(got, _script_want(src.numpy()))
    np.testing.assert_array_equal(slab_copy.want(src.numpy()), _script_want(src.numpy()))


def test_slab_copy_ragged_raises():
    with pytest.raises(ValueError, match="multiple of 128"):
        _kernels.slab_copy(torch.zeros(8, 1000))
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.slab_copy(torch.zeros(256, 8).T)


@pytest.mark.parametrize("shape", [(32, 128), (8, 384)])
def test_slab_transpose_plain_equals_script(shape):
    src = torch.arange(shape[0] * shape[1], dtype=torch.float32).reshape(shape)
    got = _kernels.slab_transpose(src).numpy()
    np.testing.assert_array_equal(got, np.asarray(src).T)   # exp_transpose.py:39


def _loop_want(src: np.ndarray, iters: int) -> np.ndarray:
    """k_loop's accumulator in numpy: each iteration adds its slab's column
    sums (exact here: integers below 2**24) in iteration order, in f32."""
    S = src.shape[0] // 4
    sums = [src[S * j:S * (j + 1)].astype(np.float64).sum(0).astype(np.float32)
            for j in range(4)]
    acc = np.zeros(src.shape[1], np.float32)
    for i in range(iters):
        acc = (acc + sums[i % 4]).astype(np.float32)
    return acc[None]


@pytest.mark.parametrize("transpose", [False, True])
def test_slab_loop_plain(transpose):
    src = slab_transpose.loop_source()
    got = _kernels.slab_transpose(src, slab_transpose.ITERS, transpose).numpy()
    np.testing.assert_array_equal(got, _loop_want(src.numpy(), slab_transpose.ITERS))
    with pytest.raises(ValueError, match="multiple of 4"):
        _kernels.slab_transpose(torch.zeros(6, 8), 3, transpose)


# ---------------- the launch path ----------------

@pytest.mark.parametrize("module", [kernels, _kernels], ids=["raster", "lab"])
def test_bound_table_covers_every_signature(module):
    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self):
            self.looked_up = []

        def __getattr__(self, name):
            self.looked_up.append(name)
            fn = Fn()
            setattr(self, name, fn)
            return fn

    lib = Lib()
    assert _build.bind(lib, module._SIGNATURES) is lib
    assert sorted(lib.looked_up) == sorted(module._SIGNATURES)
    for name, argtypes in module._SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.argtypes == argtypes and fn.restype is ctypes.c_int
    # Every function the module calls is in its table, every entry of the
    # table is called or checked at load, and every C entry of its sources
    # is bound.
    called = set(re.findall(r'[."](vf_\w+)\b', open(module.__file__).read()))
    checked = {row[0] for row in module._contract()}
    sources = module._SOURCES if module is kernels else (module._SOURCE,)
    entries = {name for src in sources
               for name in re.findall(r"^int (vf_\w+)\(", src.read_text(), re.M)}
    assert called <= set(module._SIGNATURES) == called | checked == entries
    if module is _kernels:
        launched = set(re.findall(r"_build\.launch\(\w+, load\(\)\.(vf_lab_\w+)",
                                  open(module.__file__).read()))
        assert len(launched) == len(_kernels.LAUNCHED)


def _fn(calls, name, err=0):
    """A stand-in for the library function ``name`` that records its calls
    and returns ``err``."""
    def call(*args):
        calls.append((name, args))
        return err
    call.__name__ = name
    return call


class _OnDevice0:
    def get_device(self):
        return 0


# A launch of each library's path: (the wrapper counted, the function
# launched; the lab's per-device step in front of it).
FAKE_LAUNCHES = {"lab": (_kernels.lane_ops, "vf_lab_ops", _kernels._prepare),
                 "raster": (kernels.vs_fields, "vf_vs_fields", None)}


def _fake_launch(monkeypatch, library, prepare_error=0, error=0):
    """The launch path over stand-in functions that record their calls, on
    a current device 0 whose raw stream handle is 100: (calls, launch())."""
    wrapper, name, prepare = FAKE_LAUNCHES[library]
    calls = []
    monkeypatch.setattr(_kernels, "_lib",
                        types.SimpleNamespace(vf_lab_prepare=_fn(calls, "prepare", prepare_error)))
    monkeypatch.setattr(_kernels, "_prepared", set())
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 100 + index)
    monkeypatch.setattr(wrapper, "launches", 0)
    fn = _fn(calls, name, error)
    return calls, lambda: _build.launch(wrapper, fn, _OnDevice0(), 7, prepare=prepare)


@pytest.mark.parametrize("library", sorted(FAKE_LAUNCHES))
def test_launch_prepares_each_device_once(monkeypatch, library):
    calls, launch = _fake_launch(monkeypatch, library)
    for _ in range(3):
        launch()
    wrapper, name, prepare = FAKE_LAUNCHES[library]
    assert calls == [("prepare", ())] * (prepare is not None) + [(name, (7, 100))] * 3
    assert wrapper.launches == 3
    assert _kernels._prepared == ({0} if prepare else set())


@pytest.mark.parametrize("library", sorted(FAKE_LAUNCHES))
def test_launch_raises_when_prepare_fails(monkeypatch, library):
    """A failing step in front of the launch (the lab's), or a failing
    launch (a render wrapper's), raises with the function's name and counts
    nothing."""
    wrapper, name, prepare = FAKE_LAUNCHES[library]
    calls, launch = _fake_launch(monkeypatch, library, prepare_error=1, error=int(not prepare))
    with pytest.raises(RuntimeError, match=f"{name} launch failed with CUDA error 1"):
        launch()
    assert calls == ([("prepare", ())] if prepare else [(name, (7, 100))])
    assert wrapper.launches == 0 and not _kernels._prepared


def _meta(*shape):
    return torch.zeros(shape, device="meta")


_F = torch.float32
# Each wrapper's refusals on the CPU, with the messages the wrappers gave
# before their launches were bound once.
REFUSALS = [
    (lambda: _kernels.fs_ops(torch.zeros(4), torch.zeros(4), torch.zeros(4), "tan"),
     "op must be one of " + str(_kernels.OPS) + ", got 'tan'"),
    (lambda: _kernels.fs_ops(torch.zeros(4, dtype=torch.float64), torch.zeros(4), torch.zeros(4),
                             "sin"),
     "t must be a contiguous 1-D torch.float32, got torch.float64 (4,)"),
    (lambda: _kernels.fs_ops(torch.zeros(4), torch.zeros(5), torch.zeros(4), "sin"),
     "u has shape (5,), t (4,)"),
    (lambda: _kernels.fs_ops(torch.zeros(4), torch.zeros(4, 2)[:, 0], torch.zeros(4), "sin"),
     "u must be a contiguous 1-D torch.float32, got torch.float32 (4,)"),
    (lambda: _kernels.fs_ops(_meta(4), _meta(4), _meta(4), "sin"), "unsupported device meta"),
    (lambda: _kernels.fs_chain(torch.zeros(3), torch.zeros(3), torch.zeros(3),
                               torch.zeros(3, dtype=torch.int32), torch.zeros(256, 4),
                               torch.zeros(5)),
     "lut must be (256, 3), got (256, 4)"),
    (lambda: _kernels.fs_chain(torch.zeros(3), torch.zeros(3), torch.zeros(3),
                               torch.zeros(3, dtype=torch.int32), torch.zeros(256, 3),
                               torch.zeros(4)),
     "par must be (5,) [hr2, exposure, l0, l1, l2], got (4,)"),
    (lambda: _kernels.fs_chain(torch.zeros(3), torch.zeros(3), torch.zeros(3),
                               torch.full((3,), 3, dtype=torch.int32), torch.zeros(256, 3),
                               torch.zeros(5)),
     "channel must lie in 0..2"),
    (lambda: _kernels.fs_chain(torch.zeros(3), torch.zeros(3), torch.zeros(3),
                               torch.zeros(3), torch.zeros(256, 3), torch.zeros(5)),
     "channel must be a contiguous 1-D torch.int32, got torch.float32 (3,)"),
    (lambda: _kernels.slab_copy(torch.zeros(8, 1000)),
     "src has 1000 columns, not a multiple of 128"),
    (lambda: _kernels.slab_copy(_meta(8, 128)), "unsupported device meta"),
    (lambda: _kernels.slab_transpose(torch.zeros(8, 128), -1),
     "iters must lie in [0, 2**31), got -1"),
    (lambda: _kernels.slab_transpose(torch.zeros(6, 8), 3),
     "the loop takes 4 slabs: rows must be a positive multiple of 4, got 6"),
    (lambda: _kernels.slab_transpose(torch.zeros(8, 2048), 3),
     "the loop takes one thread per column: at most 1024, got 2048"),
    (lambda: _kernels.slab_transpose(torch.zeros(8, 128).T), "src must be a contiguous 2-D "
     "torch.float32, got torch.float32 (128, 8)"),
    (lambda: _kernels.step_loop("c_none", torch.zeros(512, 128), 8),
     f"body must be one of {_kernels.BODIES}, got 'c_none'"),
    (lambda: _kernels.step_loop("c_scalar", torch.zeros(256, 128), 8),
     "c_scalar takes big of (512, 128) as scripts/exp_loop_floor.py does, got (256, 128)"),
    (lambda: _kernels.step_loop("c_u4", torch.zeros(512, 128), 6),
     "nstep must be a multiple of 4 in [0, 2**31), got 6"),
    (lambda: _kernels.step_loop("c_scalar", torch.zeros(512, 128), 8, torch.zeros(512, 128)),
     "c_scalar's scratch is (768, 128), got (512, 128)"),
    (lambda: _kernels.onehot_dot(torch.zeros(8, 128), torch.zeros(128, 8), "bf16"),
     "mode must be one of ('ffma', 'tf32', 'tf32x3'), got 'bf16'"),
    (lambda: _kernels.onehot_dot(torch.zeros(8, 64), torch.zeros(64, 8)),
     "takes (m, 128) @ (128, n) with 1 <= m, n <= 128, got (8, 64) @ (64, 8)"),
    (lambda: _kernels.onehot_dot(torch.zeros(129, 128), torch.zeros(128, 8)),
     "takes (m, 128) @ (128, n) with 1 <= m, n <= 128, got (129, 128) @ (128, 8)"),
    (lambda: _kernels.onehot_dot(torch.zeros(8, 128), torch.zeros(128, 8, dtype=torch.int32)),
     "b must be a contiguous 2-D torch.float32, got torch.int32 (128, 8)"),
    (lambda: _kernels.lane_ops(torch.zeros(2, 8), "rotate"),
     "op must be one of ('roll', 'exponent'), got 'rotate'"),
    (lambda: _kernels.lane_ops(torch.zeros(2, 2048), "roll", 1),
     "one thread per column: at most 1024, got 2048"),
    (lambda: _kernels.lane_ops(torch.zeros(2, 8, 1), "roll", 1),
     "x must be a contiguous 2-D torch.float32, got torch.float32 (2, 8, 1)"),
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_wrappers_refuse_as_before(case):
    call, message = REFUSALS[case]
    with pytest.raises(ValueError) as err:
        call()
    assert str(err.value) == message


def _vertex_stage(xyuv):
    """``kernels.vs_fields`` of the vertices xyuv (N, 4) over a 4x4 height
    field, seen through identity matrices."""
    dev = xyuv.device
    eye, one = torch.eye(4, device=dev)[None], torch.ones((), device=dev)
    heights = torch.arange(16.0, device=dev).view(4, 4)
    return kernels.vs_fields(xyuv, heights, eye, eye, one, one, 16, 16)


# A launch of each library's wrappers on the card: (the wrapper counted, its
# call on x, x's shape).
CARD_LAUNCHES = {"lab": (_kernels.lane_ops, lambda x: _kernels.lane_ops(x, "exponent"), (8, 128)),
                 "raster": (kernels.vs_fields, _vertex_stage, (8, 4))}


@pytest.mark.gpu
@pytest.mark.parametrize("library", sorted(CARD_LAUNCHES))
def test_launch_lands_on_the_current_stream(cuda, library):
    # The kernel reads x after a fill queued on s behind a ~30 ms spin: on
    # any other stream it would read the zeros.
    wrapper, call, shape = CARD_LAUNCHES[library]
    x = torch.zeros(shape, device=cuda)
    stale = call(x)                       # builds and loads the library first
    want = call(torch.ones(shape, device=cuda))
    torch.cuda.synchronize()
    assert not torch.equal(stale, want)
    s = torch.cuda.Stream()
    n = wrapper.launches
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        x.fill_(1.0)
        out = call(x)
        assert not s.query()
    s.synchronize()
    assert wrapper.launches == n + 1
    assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("library", sorted(CARD_LAUNCHES))
def test_launch_lands_on_the_tensors_device(cuda, library):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    _, call, shape = CARD_LAUNCHES[library]
    x = torch.rand(shape, device="cuda:1")
    want = call(x.to("cuda:0"))
    with torch.cuda.device(0):
        out = call(x)
        assert torch.cuda.current_device() == 0
    assert out.device == x.device
    assert torch.equal(out.cpu(), want.cpu())


# ---------------- the CLIs ----------------

def _cli(name, *args, **env):
    return subprocess.run([sys.executable, "-m", f"vulkan_forge_torch.lab.{name}", *args],
                          cwd=REPO, timeout=300, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO, **env))


CLI_LINES = {
    "fs_ops": [r"^device: cpu", *(rf"^{op} +mismatches= +0/32768  max_ulp=0  BIT-EXACT"
                                   for op in fs_ops.OPS)],
    "fs_chain": [r"^device: cpu", r"^pixel A ch0:", r"^  u8f +cpu=45\.0+ 0x42340000  cpu=",
                 r"^pixel B ch1:", r"^  u8f +cpu=158\.0+ 0x431e0000  cpu="],
    "slab_copy": [r"^lane-sliced DMA OK, match: True$"],
    "slab_transpose": [r"^in-kernel \(32,128\) transpose: OK$",
                       r"^loop without transpose: not measured", r"^loop with transpose: "],
}


@pytest.mark.parametrize("name", sorted(CLI_LINES))
def test_cli_runs_on_cpu(name):
    r = _cli(name, "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    for pattern in CLI_LINES[name]:
        assert re.search(pattern, r.stdout, re.M), f"{pattern!r} not in\n{r.stdout}"


@pytest.mark.parametrize("name", sorted(CLI_LINES))
def test_cli_needs_a_card(name):
    r = _cli(name, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "cuda" in (r.stdout + r.stderr)


# ---------------- on the card ----------------

@pytest.mark.gpu
def test_fs_ops_kernel_within_guide(cuda):
    for row in fs_ops.measure(cuda):
        assert fs_ops.within_guide(row), row


@pytest.mark.gpu
def test_fs_chain_kernel_matches_plain(cuda):
    rng = np.random.default_rng(5)
    P = 4096
    cols = [rng.uniform(-0.7, 0.7, P), rng.uniform(-16, 16, P), rng.uniform(-16, 16, P)]
    cols = [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in cols]
    ch = torch.from_numpy(rng.integers(0, 3, P).astype(np.int32)).to(cuda)
    _, lut_rgb, par = fs_chain.script_inputs(cuda)
    n = _kernels.fs_chain.launches
    got = _kernels.fs_chain(*cols, ch, lut_rgb, par)
    torch.cuda.synchronize()
    assert _kernels.fs_chain.launches == n + 1
    want = _kernels.fs_chain_plain(*cols, ch, lut_rgb, par)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  want.cpu().numpy().view(np.uint32))
    u8f = got[_kernels.CHAIN_NAMES.index("u8f")].cpu().numpy()
    word = got[-1].cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(u8f, (word >> (8 * ch.cpu().numpy().astype(np.uint32))) & 0xFF)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 1024), (8, 384), (300, 4096)])
def test_slab_copy_kernel_matches_plain(cuda, shape):
    src = slab_copy.source(*shape, device=cuda)
    np.testing.assert_array_equal(_kernels.slab_copy(src).cpu().numpy(),
                                  _kernels.slab_copy_plain(src).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,iters,transpose", [((32, 128), 0, True), ((8, 384), 0, True),
                                                   ((100, 70), 0, True), ((128, 128), 4096, True),
                                                   ((128, 128), 4096, False), ((16, 40), 9, True)])
def test_slab_transpose_kernel_matches_plain(cuda, shape, iters, transpose):
    src = torch.arange(shape[0] * shape[1], dtype=torch.float32, device=cuda).reshape(shape)
    got = _kernels.slab_transpose(src, iters, transpose).cpu().numpy()
    np.testing.assert_array_equal(got, _kernels.slab_transpose_plain(src, iters, transpose)
                                  .cpu().numpy())
