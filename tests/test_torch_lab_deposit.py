"""The deposit probes' twins (``vulkan_forge_torch/lab``: ``_bodies``,
``step_loop``, ``onehot_dot``, ``lane_ops`` and the five CLIs) against the
TPU scripts they port: ``scripts/exp_deposit_breakdown.py``,
``exp_deposit3.py``, ``exp_deposit2.py``, ``exp_loop_floor.py`` and
``exp_mosaic_facts.py``.

The scripts' own kernels run once, in a subprocess (``reference``), in
Pallas's interpret mode on the CPU with XLA's multiply-add contraction off
(``XLA_FLAGS=--xla_cpu_max_isa=AVX``): ``pl.pallas_call`` is patched so
that each loop kernel is caught and run again from a seeded scratch (the
TPU leaves its scratch as VMEM held it; interpret mode fills it with NaN)
that comes back as an extra output, at 128 steps (E5 at its fixed 2,048).
``jnp.exp2`` there gives the exact powers 2**rel the scripts mean: XLA:CPU's
exp2 misses 2**13, 2**15, ..., 2**23 (by 3.5 at 2**23), which moves the
bitmask winners. ``exp_deposit2.py:207`` does not trace (the test holds
that); its ``b_full`` runs from the test's own copy of the script with that
line's stand-in broadcast to (8, 128).

Tolerances: bodies whose sums do not round (masks, winners, the one-hot
products of powers of two and integers) equal to the script's; the others
(``_bodies.SCALED``) within 1e-5 of each element's scale, the plain run
with every product's terms taken by magnitude. The cases marked ``gpu``
hold each kernel to its plain version on the card; they skip without one.
"""
from __future__ import annotations

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:                      # run as a script: the reference
    sys.path.insert(0, REPO)

from vulkan_forge_torch.lab import (_bodies, _kernels, deposit_breakdown,  # noqa: E402
                                    mosaic_facts, slab_transpose)

NSTEP = 128
E5_NSTEP = 2048                               # exp_mosaic_facts.py:191
SCRATCH_SEED = 17
LOOP_SCRIPTS = ("exp_deposit3", "exp_deposit2", "exp_loop_floor")


def _scratch(script: str) -> np.ndarray:
    rows = _bodies.SCRIPTS[script]["scratch"]
    return np.random.default_rng(SCRATCH_SEED).standard_normal((rows, 128)).astype(np.float32)


# ---------------- the reference, in a subprocess ----------------

def _reference_main(out_path: str) -> None:
    """Run every body of the five scripts in interpret mode and save the
    outputs, final scratches and captured inputs to out_path (npz)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    jnp.exp2 = lambda x: jax.lax.bitcast_convert_type(
        (jnp.asarray(x).astype(jnp.int32) + 127) << 23, jnp.float32)
    orig = pl.pallas_call
    caught = []

    def catch(kernel, **kw):
        def f(*args):
            jax.debug.callback(lambda *a: caught.append((kernel, kw, [np.asarray(x) for x in a])),
                               *args)
            return jnp.zeros(kw["out_shape"].shape, jnp.float32)
        return f

    def first_call(fn):
        caught.clear()
        with contextlib.redirect_stdout(io.StringIO()):
            fn()
        jax.effects_barrier()
        return caught[0]

    def with_scratch(kernel, out_shape, inputs, inits):
        """The kernel with each scratch ref an output that starts as init."""
        n_in, n_s = len(inputs), len(inits)

        def k2(*refs):
            outs = refs[n_in + n_s + 1:]
            for acc, init in zip(outs, refs[n_in:n_in + n_s]):
                acc[...] = init[...]
            kernel(*refs[:n_in], refs[n_in + n_s], *outs)
        shapes = (out_shape,) + tuple(jax.ShapeDtypeStruct(i.shape, jnp.float32) for i in inits)
        f = jax.jit(orig(k2, out_shape=shapes, interpret=True))
        return [np.asarray(x) for x in f(*inputs, *inits)]

    def load(name, src=None):
        path = os.path.join(REPO, "scripts", f"{name}.py")
        mod = type(sys)(f"_ref_{name}")
        mod.__file__ = path
        exec(compile(src or open(path).read(), path, "exec"), mod.__dict__)
        return mod

    res = {}
    pl.pallas_call = catch
    for script in LOOP_SCRIPTS:
        mod = load(script)
        mod.NSTEP = NSTEP
        for body in _bodies.BODIES:
            if body.script != script or body.name == "b_full":
                continue
            if script == "exp_loop_floor" and body.name.startswith(("c_u", "c_eval4")):
                k = body.unroll
                fn = mod.make_u(k) if body.name.startswith("c_u") else mod.make_eval4_u(k)
                kernel, kw, args = first_call(lambda: mod.run(fn, body.name, steps_per_iter=k,
                                                              n=1))
            else:
                kernel, kw, args = first_call(lambda: mod.run(getattr(mod, body.name),
                                                              body.name, n=1))
            res[f"big/{script}"] = args[0]
            res[f"{body.name}/out"], res[f"{body.name}/acc"] = with_scratch(
                kernel, kw["out_shape"], args, [_scratch(script)])
    # exp_deposit2.b_full: the script's own does not trace; the stand-in does.
    mod = load("exp_deposit2")
    mod.NSTEP = NSTEP
    pl.pallas_call = lambda kernel, **kw: orig(kernel, interpret=True, **kw)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mod.run(mod.b_full, "b_full", n=1)
    except TypeError as e:
        res["b_full/error"] = np.array(str(e))
    pl.pallas_call = catch
    lines = open(mod.__file__).read().splitlines(keepends=True)
    lines[206] = lines[206].replace("hi_dot(py * 0.001, P.T)",
                                    "hi_dot(jnp.broadcast_to(py * 0.001, (8, 128)), P.T)")
    mod = load("exp_deposit2", "".join(lines))
    mod.NSTEP = NSTEP
    kernel, kw, args = first_call(lambda: mod.run(mod.b_full, "b_full", n=1))
    res["b_full/out"], res["b_full/acc"] = with_scratch(kernel, kw["out_shape"], args,
                                                        [_scratch("exp_deposit2")])
    # breakdown: the bodies are closures of main(); run_kernel catches them.
    mod = load("exp_deposit_breakdown")
    bodies = {}
    run_kernel = mod.run_kernel
    mod.run_kernel = lambda body, name, **kw: bodies.setdefault(name.split()[0], body)
    kernel, kw, args = first_call(mod.main)
    res["e_exact/a"], res["e_exact/b"] = args
    res["e_exact/out"] = np.asarray(jax.jit(orig(kernel, out_shape=kw["out_shape"],
                                                 interpret=True))(*args))
    recs = first_call(lambda: run_kernel(lambda r, i, a, c: c, "inputs", nstep=1, n=1))[2]
    res["big/exp_deposit_breakdown"] = recs[0]

    def breakdown_kernel(body):               # run_kernel's kernel (:44-50) at NSTEP
        def kernel(rt_ref, o_ref, acc_ref):
            rt = rt_ref[...]
            out = jax.lax.fori_loop(0, NSTEP, lambda i, c: body(rt, i, acc_ref, c),
                                    jnp.zeros((8, 128), jnp.float32))
            o_ref[...] = out + acc_ref[0:8, :]
        return kernel
    for name, body in bodies.items():
        res[f"{name}/out"], res[f"{name}/acc"] = with_scratch(
            breakdown_kernel(body), jax.ShapeDtypeStruct((8, 128), jnp.float32), recs,
            [_scratch("exp_deposit_breakdown")])
    # mosaic_facts: E1, E3, E4 and E5.
    mod = load("exp_mosaic_facts")
    for name, fn in (("e1", mod.e1), ("e3", mod.e3), ("e4", mod.e4)):
        kernel, kw, args = first_call(fn)
        for k, a in enumerate(args):
            res[f"{name}/in{k}"] = a
        res[f"{name}/out"] = np.asarray(jax.jit(orig(kernel, out_shape=kw["out_shape"],
                                                     interpret=True))(*args))
    kernel, kw, args = first_call(mod.e5)
    res["big/exp_mosaic_facts"] = args[0]
    res["e5/out"], res["e5/acc"], _ = with_scratch(
        kernel, kw["out_shape"], args,
        [_scratch("exp_mosaic_facts"), np.zeros((512, 128), np.float32)])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The scripts' outputs and inputs (``_reference_main``), ~20 s."""
    out = tmp_path_factory.mktemp("deposit") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO, VF_NO_CACHE="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lab kernels have no CPU mode")
    return torch.device("cuda")


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------- inputs ----------------

@pytest.mark.parametrize("script", sorted(_bodies.SCRIPTS))
def test_loop_inputs_equal_the_scripts(reference, script):
    np.testing.assert_array_equal(_bits(_bodies.script_big(script)),
                                  _bits(reference[f"big/{script}"]))


def test_product_inputs_equal_the_scripts(reference):
    for name, (a, b) in (("e_exact", deposit_breakdown.exact_inputs()),
                         ("e1", mosaic_facts.e1_inputs())):
        got = (reference[f"{name}/a"], reference[f"{name}/b"]) if name == "e_exact" else \
            (reference["e1/in0"], reference["e1/in1"])
        np.testing.assert_array_equal(_bits(a), _bits(got[0]))
        np.testing.assert_array_equal(_bits(b), _bits(got[1]))
    np.testing.assert_array_equal(_bits(mosaic_facts.e4_inputs()), _bits(reference["e4/in0"]))


# ---------------- the loop bodies ----------------

@pytest.mark.parametrize("name", [b.name for b in _bodies.BODIES])
def test_plain_body_matches_script(reference, name):
    body = _bodies.BY_NAME[name]
    big = _bodies.script_big(body.script)
    nstep = E5_NSTEP if name == "e5" else NSTEP
    out, acc = _kernels.step_loop(name, big, nstep, torch.from_numpy(_scratch(body.script)))
    want_out, want_acc = reference[f"{name}/out"], reference[f"{name}/acc"]
    assert out.shape == (8, 128) and acc.shape == want_acc.shape
    if name not in _bodies.SCALED:
        np.testing.assert_array_equal(out.numpy(), want_out)
        np.testing.assert_array_equal(acc.numpy(), want_acc)
        return
    mag_acc = torch.from_numpy(_scratch(body.script)).abs()
    mag = _bodies.run(name, big, nstep, mag_acc, product=_bodies.mm_magnitude)
    for got, want, scale in ((out, want_out, mag), (acc, want_acc, mag_acc)):
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert (err <= 1e-5 * scale.numpy()).all(), f"{name}: {float((err / scale.numpy()).max())}"


def test_b_full_script_does_not_trace(reference):
    # exp_deposit2.py:207 contracts py (8, 1) with P.T (128, 128).
    assert "dot_general requires contracting dimensions to have the same shape" in \
        str(reference["b_full/error"])


def test_step_loop_scratch_and_checks():
    big = _bodies.script_big("exp_deposit3")
    init = torch.from_numpy(_scratch("exp_deposit3"))
    keep = init.clone()
    out, acc = _kernels.step_loop("d_full", big, 8, init)
    assert torch.equal(init, keep), "the caller's scratch changed"
    zero = _kernels.step_loop("d_full", big, 8)
    explicit = _kernels.step_loop("d_full", big, 8, torch.zeros(768, 128))
    assert all(torch.equal(a, b) for a, b in zip(zero, explicit))
    assert not torch.equal(out, zero[0])
    with pytest.raises(ValueError, match="body must be"):
        _kernels.step_loop("d_none", big, 8)
    with pytest.raises(ValueError, match=r"\(1024, 128\)"):
        _kernels.step_loop("d_full", big[:512].contiguous(), 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        _kernels.step_loop("c_u4", _bodies.script_big("exp_loop_floor"), 6)
    with pytest.raises(ValueError, match="scratch"):
        _kernels.step_loop("d_full", big, 8, torch.zeros(512, 128))


def test_clamped_rows_are_the_last_that_fit():
    # d_strips' rows ty*8 + 128*(k+1) pass 767 from ty = 32 (k = 3): they
    # land on rows 760..767, as XLA's dynamic slice does.
    st = _bodies.new_state(_bodies.script_big("exp_deposit3"), torch.zeros(768, 128))
    assert _bodies.rows(st, 63 * 8 + 512) == slice(760, 768)
    assert _bodies.rows(st, 31 * 8 + 512) == slice(760, 768)
    assert _bodies.rows(st, 30 * 8 + 512) == slice(752, 760)


# ---------------- onehot_dot ----------------

@pytest.mark.parametrize("name", ["e_exact", "e1"])
def test_onehot_dot_ffma_plain_equals_script(reference, name):
    a = reference["e_exact/a" if name == "e_exact" else "e1/in0"]
    b = reference["e_exact/b" if name == "e_exact" else "e1/in1"]
    got = _kernels.onehot_dot(torch.from_numpy(a), torch.from_numpy(b), "ffma").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(reference[f"{name}/out"]))


def test_onehot_dot_modes_on_the_scripts_facts():
    vals, p = deposit_breakdown.exact_inputs()
    bad = {mode: deposit_breakdown.single_contrib_mismatches(_kernels.onehot_dot(vals, p, mode),
                                                             vals, p)
           for mode in _kernels.DOT_MODES}
    assert bad["ffma"] == bad["tf32x3"] == 0 and bad["tf32"] > 0
    a, b = mosaic_facts.e1_inputs()
    for mode in _kernels.DOT_MODES:
        facts = mosaic_facts.e1_facts(_kernels.onehot_dot(a, b, mode), a, b)
        assert facts["bitmask_mismatches"] == 0, mode
        assert (facts["single_mismatches"] == 0) == (mode != "tf32"), (mode, facts)
    with pytest.raises(ValueError, match="mode must be"):
        _kernels.onehot_dot(a, b, "bf16")
    with pytest.raises(ValueError, match=r"\(m, 128\)"):
        _kernels.onehot_dot(a[:, :64].contiguous(), b)


def test_tf32_round_and_parts():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-30, 30, 4096))).astype(np.float32)
    x[:4] = [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12, 0.0]
    t = torch.from_numpy(x)
    r = _kernels.tf32_round(t).numpy()
    assert not (r.view(np.uint32) & 0x1FFF).any()
    # Ties go away from zero; otherwise to the nearer of the two grid points.
    assert r[0] == 1.0 + 2.0 ** -10 and r[1] == -(1.0 + 2.0 ** -10) and r[2] == 1.0 + 2.0 ** -10
    ulp = np.abs(x.astype(np.float64)) * 2.0 ** -10
    assert (np.abs(r.astype(np.float64) - x) <= ulp / 2 * (1 + 2.0 ** -9)).all()
    hi, mid, lo = (a.numpy().astype(np.float64) for a in _kernels.tf32_parts(t))
    np.testing.assert_array_equal(hi + mid + lo, x.astype(np.float64))


# ---------------- E2, E3, E4 ----------------

def test_e2_transposes():
    rng = np.random.default_rng(3)
    for shape in [(1, 128), (8, 128), (32, 128)]:
        x = torch.from_numpy(rng.random(shape, dtype=np.float32))
        assert torch.equal(_kernels.slab_transpose(x), x.T)
    assert slab_transpose.loop_source().shape == (128, 128)


def test_lane_ops_plain_equal_the_scripts(reference):
    x = torch.from_numpy(reference["e3/in0"])
    np.testing.assert_array_equal(_kernels.lane_ops(x, "roll", mosaic_facts.ROLL).numpy(),
                                  reference["e3/out"])
    np.testing.assert_array_equal(_kernels.lane_ops(x, "roll", mosaic_facts.ROLL).numpy(),
                                  np.roll(reference["e3/in0"], 5, axis=1))
    masks = mosaic_facts.e4_inputs()
    got = _kernels.lane_ops(masks, "exponent").numpy()
    np.testing.assert_array_equal(got, reference["e4/out"])
    np.testing.assert_array_equal(got, np.floor(np.log2(masks.numpy())).astype(np.float32))
    with pytest.raises(ValueError, match="op must be"):
        _kernels.lane_ops(x, "rotate")
    with pytest.raises(ValueError, match="1024"):
        _kernels.lane_ops(torch.zeros(2, 2048), "roll", 1)


# ---------------- the CLIs ----------------

def _cli(name, *args, **env):
    return subprocess.run([sys.executable, "-m", f"vulkan_forge_torch.lab.{name}", *args],
                          cwd=REPO, timeout=300, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO, **env))


CLI_LINES = {
    "deposit_breakdown": [r"^device: cpu", r"^v_full   \(eval\+P\+A\+GB\+B\+extract\+merge\): "
                          r"not measured \(no card\)",
                          r"^E_exact HIGHEST single-contrib bitexact=True$",
                          r"^E_exact tf32 single-contrib bitexact=False",
                          r"^E_exact tf32x3 single-contrib bitexact=True$"],
    "deposit_trip": [r"^d_base  : not measured \(no card\)", r"^d_full  : not measured"],
    "deposit_marginal": [r"^b_full  \(everything, 12 mm\): not measured \(no card\)"],
    "loop_floor": [r"^c_scalar  : not measured", r"^c_eval4_u8: not measured"],
    "mosaic_facts": [r"^E1 dot\(96,128\)@\(128,128\) ffma: not measured \(no card\), "
                     r"single-contrib bitexact=True, bitmask exact=True",
                     r"^E1 dot\(96,128\)@\(128,128\) tf32: .*single-contrib bitexact=False, "
                     r"bitmask exact=True",
                     r"^E2 transpose \(32, 128\): not measured \(no card\), correct=True$",
                     r"^E3 lane roll: not measured \(no card\), correct=True$",
                     r"^E4 exponent extract: not measured \(no card\), correct=True$",
                     r"^E5 deposit step .*: not measured \(no card\)"],
}


@pytest.mark.parametrize("name", sorted(CLI_LINES))
def test_cli_runs_on_cpu(name):
    r = _cli(name, "--device", "cpu", "--nstep", "8")
    assert r.returncode == 0, r.stdout + r.stderr
    for pattern in CLI_LINES[name]:
        assert re.search(pattern, r.stdout, re.M), f"{pattern!r} not in\n{r.stdout}"
    script = {"deposit_breakdown": "exp_deposit_breakdown", "deposit_trip": "exp_deposit3",
              "deposit_marginal": "exp_deposit2", "loop_floor": "exp_loop_floor",
              "mosaic_facts": "exp_mosaic_facts"}[name]
    labels = [b.label for b in _bodies.BODIES if b.script == script]
    assert [ln.split(":")[0] for ln in r.stdout.splitlines() if "not measured" in ln
            and not ln.startswith(("E1", "E2", "E3", "E4"))] == labels


@pytest.mark.parametrize("name", sorted(CLI_LINES))
def test_cli_needs_a_card(name):
    r = _cli(name, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "cuda" in (r.stdout + r.stderr)


# ---------------- on the card ----------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", [b.name for b in _bodies.BODIES])
def test_step_loop_kernel_matches_plain(cuda, name):
    body = _bodies.BY_NAME[name]
    big = _bodies.script_big(body.script, cuda)
    init = torch.from_numpy(_scratch(body.script)).to(cuda)
    n = _kernels.step_loop.launches
    got = _kernels.step_loop(name, big, NSTEP, init)
    torch.cuda.synchronize()
    assert _kernels.step_loop.launches == n + 1
    want = _kernels.step_loop_plain(name, big, NSTEP, init)
    if name in _bodies.SCALED:
        mag_acc = init.abs()
        mag = _bodies.run(name, big, NSTEP, mag_acc, product=_bodies.mm_magnitude)
        for g, w, scale in zip(got, want, (mag, mag_acc)):
            assert bool(((g - w).abs() <= 1e-5 * scale).all()), name
    else:
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.gpu
@pytest.mark.parametrize("mode", _kernels.DOT_MODES)
def test_onehot_dot_kernel_matches_plain(cuda, mode):
    for a, b in (deposit_breakdown.exact_inputs(cuda), mosaic_facts.e1_inputs(cuda)):
        got = _kernels.onehot_dot(a, b, mode)
        want = _kernels.onehot_dot_plain(a, b, mode)
        scale = _kernels.onehot_dot_plain(a.abs(), b.abs(), "ffma")
        assert bool(((got - want).abs() <= _kernels.DOT_TOLERANCE * scale).all())
        if mode == "ffma":
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    vals, p = deposit_breakdown.exact_inputs(cuda)
    bad = deposit_breakdown.single_contrib_mismatches(_kernels.onehot_dot(vals, p, mode), vals, p)
    assert (bad == 0) == (mode != "tf32")


DOT_SIZES = (1, 7, 16, 17, 80, 96, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", _kernels.DOT_MODES)
@pytest.mark.parametrize("m", DOT_SIZES)
def test_onehot_dot_kernel_edges(cuda, mode, m):
    # Rows and columns past a 16 x 8 tile's edge, and one-hot columns that
    # collide, at every n: ffma bit for bit, the tf32 modes within
    # DOT_TOLERANCE of sum |a||b|.
    rng = np.random.default_rng(100 + m)
    for n in DOT_SIZES:
        a = (rng.standard_normal((m, 128)) * np.exp(rng.uniform(-20, 20, (m, 128))))
        a = torch.from_numpy(a.astype(np.float32)).to(cuda)
        b = np.zeros((128, n), np.float32)
        b[np.arange(128), rng.integers(0, n, 128)] = 1.0
        b = torch.from_numpy(b).to(cuda)
        got = _kernels.onehot_dot(a, b, mode)
        want = _kernels.onehot_dot_plain(a, b, mode)
        assert got.shape == (m, n)
        if mode == "ffma":
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (m, n)
        else:
            scale = _kernels.onehot_dot_plain(a.abs(), b.abs(), "ffma")
            assert bool(((got - want).abs() <= _kernels.DOT_TOLERANCE * scale).all()), (m, n)


@pytest.mark.gpu
@pytest.mark.parametrize("op", _kernels.LANE_OPS)
def test_lane_ops_kernel_matches_plain(cuda, op):
    x = mosaic_facts.e4_inputs(cuda) if op == "exponent" else torch.rand(8, 128, device=cuda)
    assert torch.equal(_kernels.lane_ops(x, op, 5), _kernels.lane_ops_plain(x, op, 5))


if __name__ == "__main__":
    _reference_main(sys.argv[1])
