"""The port's CLI twins (``python -m vulkan_forge_torch.tools.<name>``) on
``--device cpu``, under the contract of ``tests/test_tools.py``: the same
report keys and exit codes as the originals in ``python/tools/``, at small
sizes. Where a result can be compared with the JAX package's (the
triangle's bytes, the fill-rule report), it is. Without ``--device cpu`` on
a host with no visible card, every twin but ``device_diagnostics`` exits
non-zero.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=180, **env):
    return subprocess.run([sys.executable, "-m", f"vulkan_forge_torch.tools.{args[0]}",
                           *args[1:]], cwd=REPO, timeout=timeout, capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=REPO, **env))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_device_diagnostics_cli(tmp_path, device):
    out = tmp_path / "diag.json"
    r = _run(["device_diagnostics", "--device", device, "--json", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(out.read_text())
    assert "adapters" in rep and "probes" in rep
    assert all(p["status"] in ("ok", "unsupported", "error") for p in rep["probes"])
    assert any(p["status"] == "ok" for p in rep["probes"])
    want = ["CPU"] if device == "cpu" else ["CUDA", "CPU"]
    assert [p["backend_request"] for p in rep["probes"]] == want
    assert any(a["backend"] == "CPU" for a in rep["adapters"])


def test_device_diagnostics_all_unsupported_exits_0(tmp_path):
    r = _run(["device_diagnostics", "--backends", "VULKAN", "TPU",
              "--json", str(tmp_path / "d.json")])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads((tmp_path / "d.json").read_text())
    assert [p["status"] for p in rep["probes"]] == ["unsupported", "unsupported"]


def test_determinism_harness_cli(tmp_path):
    r = _run(["determinism_harness", "--device", "cpu", "--width", "48", "--height", "32",
              "--runs", "2", "--png", "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads((tmp_path / "determinism_report.json").read_text())
    assert {"width", "height", "runs", "processes", "hashes", "unique",
            "all_equal", "avg_ms"} <= set(rep)
    assert rep["all_equal"] is True
    assert len(rep["hashes"]) == 2 and len(rep["unique"]) == 1
    assert rep["png"] == "triangle.png" and (tmp_path / "triangle.png").exists()
    # The triangle's bytes are the JAX package's.
    import vulkan_forge as vf
    want = hashlib.sha256(vf.Renderer(48, 32).render_triangle_rgba().tobytes()).hexdigest()
    assert rep["unique"] == [want]


def test_determinism_harness_terrain_mode(tmp_path):
    r = _run(["determinism_harness", "--device", "cpu", "--width", "96", "--height", "72",
              "--runs", "2", "--scene", "terrain", "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads((tmp_path / "determinism_report.json").read_text())
    assert rep["all_equal"] is True and rep["scene"] == "terrain"


def test_determinism_harness_spawned_processes(tmp_path):
    r = _run(["determinism_harness", "--device", "cpu", "--width", "48", "--height", "32",
              "--runs", "1", "--processes", "2", "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads((tmp_path / "determinism_report.json").read_text())
    assert rep["all_equal"] is True and rep["processes"] == 2


def test_perf_sanity_failure_exits_2(tmp_path):
    out = tmp_path / "perf.json"
    r = _run(["perf_sanity", "--device", "cpu", "--width", "64", "--height", "64",
              "--runs", "2", "--warmups", "0", "--budget-mult", "1e-9", "--json", str(out)],
             VF_ENFORCE_PERF="1")
    assert r.returncode == 2, r.stdout + r.stderr
    assert "FAIL" in r.stdout


def test_perf_sanity_cli(tmp_path):
    out, csv = tmp_path / "perf.json", tmp_path / "perf.csv"
    r = _run(["perf_sanity", "--device", "cpu", "--width", "64", "--height", "64",
              "--runs", "5", "--warmups", "1", "--json", str(out), "--csv", str(csv)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(out.read_text())
    assert {"width", "height", "init_ms", "steady"} <= set(rep)
    assert {"mean_ms", "median_ms", "p95_ms"} <= set(rep["steady"])
    assert len(rep["steady"]["samples_ms"]) == 5 and rep["device"] == "cpu"
    assert len(csv.read_text().splitlines()) == 6
    # Under enforcement, a baseline the run cannot meet fails with exit 2.
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"steady": {"p95_ms": 1e-9}}))
    r = _run(["perf_sanity", "--device", "cpu", "--width", "32", "--height", "32",
              "--runs", "2", "--warmups", "0", "--baseline", str(base), "--json", str(out)],
             VF_ENFORCE_PERF="1")
    assert r.returncode == 2 and "baseline" in r.stdout, r.stdout + r.stderr


def test_backends_runner_cli(tmp_path):
    r = _run(["backends_runner", "--device", "cpu", "--backends", "TORCH_CUDA", "TORCH_CPU",
              "--width", "48", "--height", "32", "--runs", "1", "--require-same", "--png",
              "--out-dir", str(tmp_path)], timeout=300, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads((tmp_path / "backends_report.json").read_text())
    assert rep["at_least_one_ok"] and rep["cross_backend_equal"]
    assert rep["backends"] == ["TORCH_CUDA", "TORCH_CPU"]
    # No card is visible to the children: the CUDA one answers unsupported.
    assert rep["per_backend"]["TORCH_CUDA"]["status"] == "unsupported"
    cpu = rep["per_backend"]["TORCH_CPU"]
    assert cpu["status"] == "ok" and (tmp_path / cpu["png"]).exists()
    import vulkan_forge as vf
    assert cpu["sha256"] == hashlib.sha256(
        vf.Renderer(48, 32).render_triangle_rgba().tobytes()).hexdigest()


def test_terrain_spike_cli(tmp_path):
    from vulkan_forge_torch import TerrainSpike, _io
    out = tmp_path / "spike.png"
    r = _run(["terrain_spike", "--device", "cpu", "--width", "64", "--height", "48",
              "--grid", "16", "--colormap", "magma", "--out", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"wrote {out}" in r.stdout
    frame = TerrainSpike(64, 48, 16, "magma", device="cpu").render_rgba()
    assert out.read_bytes() == _io.png_encode_rgba(frame)


def _jax_parity_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_report", os.path.join(REPO, "python", "tools", "parity_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parity_report_cli_matches_reference(tmp_path):
    """The fill-rule report at grid 8 (both rules) field for field equal to
    the original tool's on the same configs."""
    out = tmp_path / "parity.json"
    r = _run(["parity_report", "--device", "cpu", "--grids", "8", "--json", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(out.read_text())
    assert rep["all_interior_exact"] is True and rep["hw_coverage_exact"] is True
    ref = _jax_parity_tool()
    want = {"configs": []}
    clip, varyings, indices = ref.spike_config(8, 160, 120)
    for rule in ("shipped", "hw"):
        ref.run_config("spike_g8_160x120", clip, varyings, indices, 160, 120, want, rule=rule)
    assert rep["configs"] == want["configs"]


@pytest.mark.parametrize("tool,args", [
    ("terrain_spike", ["--out", "{tmp}/s.png"]),
    ("determinism_harness", ["--runs", "1", "--out-dir", "{tmp}"]),
    ("determinism_harness", ["--runs", "1", "--processes", "2", "--out-dir", "{tmp}"]),
    ("perf_sanity", ["--runs", "1", "--json", "{tmp}/p.json"]),
    ("backends_runner", ["--runs", "1", "--out-dir", "{tmp}"]),
    ("parity_report", ["--grids", "4", "--json", "{tmp}/p.json"])])
def test_twins_without_card_exit_nonzero(tmp_path, tool, args):
    """The default device is the card: with none visible, a twin fails
    instead of rendering on the CPU (spawned render processes included)."""
    r = _run([tool, *(a.format(tmp=tmp_path) for a in args)], CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0, r.stdout + r.stderr
    assert not (tmp_path / "s.png").exists()


def test_default_paths_are_the_twins_own():
    """No twin's default output is an original's."""
    import argparse
    from vulkan_forge_torch.tools import (backends_runner, determinism_harness,
                                         device_diagnostics, parity_report, perf_sanity,
                                         terrain_spike)
    originals = {"diag_out/device_diagnostics.json", "determinism_artifacts",
                 "backends_artifacts", "perf_report.json", "parity_report.json",
                 "terrain_spike.png"}
    seen = {}

    def capture(self, args=None, namespace=None):
        seen.update({a.dest: a.default for a in self._actions})
        raise SystemExit(0)

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", capture)
    try:
        for mod in (backends_runner, determinism_harness, device_diagnostics, parity_report,
                    perf_sanity, terrain_spike):
            with pytest.raises(SystemExit):
                mod.main([])
            paths = {seen.get(k) for k in ("json", "out_dir", "out")} - {None}
            assert paths and not paths & originals, (mod.__name__, paths)
            assert all("torch" in p for p in paths), paths
            assert seen["device"] == "cuda"
            seen.clear()
    finally:
        mp.undo()
