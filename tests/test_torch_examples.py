"""The five example twins (``python -m vulkan_forge_torch.examples.<name>``)
on ``--device cpu``, each in a directory of its own: exit 0, the original's
printed lines (``python/examples/*.py``), and PNGs that decode to the frame
the port's public API renders for the scene. The triangles' frames are the
JAX package's byte for byte; ``add_terrain``'s output is the original's,
numbers and all. Without ``--device cpu`` and a visible card, every twin
exits non-zero.
"""
from __future__ import annotations

import ast
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import vulkan_forge as vf

import vulkan_forge_torch as vt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("triangle", "two_triangles", "terrain", "add_terrain", "terrain_normals_flip")
# The originals' printed lines, numbers and hashes as <n>.
LINES = {
    "triangle": ["rendered (<n>, <n>, <n>) uint<n>", "wrote triangle_torch.png"],
    "two_triangles": ["hash A: <n>", "hash B: <n>", "deterministic: OK"],
    "terrain": ["wrote terrain_demo_torch.png", "metrics: {'render_ms': <n>, "
                "'readback_ms': <n>, 'total_ms': <n>, 'bytes': <n>, 'width': <n>, "
                "'height': <n>}"],
    "add_terrain": ["stats (min, max, mean, std): (<n>, <n>, <n>, <n>)",
                    "after minmax: (<n>, <n>, <n>, <n>)", "height patch:"]
                   + [" " * (i > 0) + " [" * (i == 0) + "[<n> <n> <n> <n>]" + "]" * (i == 3)
                      for i in range(4)],
    "terrain_normals_flip": ["wrote bump_east_torch.png", "wrote bump_west_torch.png"],
}
PNGS = {"triangle": ["triangle_torch.png"], "terrain": ["terrain_demo_torch.png"],
        "terrain_normals_flip": ["bump_east_torch.png", "bump_west_torch.png"]}


def _run(name, cwd, *args, **env):
    return subprocess.run([sys.executable, "-m", f"vulkan_forge_torch.examples.{name}", *args],
                          cwd=cwd, timeout=180, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each twin once on the CPU, in a directory of its own."""
    out = {}
    for name in NAMES:
        d = tmp_path_factory.mktemp(name)
        out[name] = (_run(name, d, "--device", "cpu"), d)
    return out


def _png(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def _numbers_out(line):
    return re.sub(r"[0-9a-f]{64}|-?\d[\d.e+-]*", "<n>", line)


@pytest.mark.parametrize("name", NAMES)
def test_twin_prints_the_originals_lines(runs, name):
    r, d = runs[name]
    assert r.returncode == 0, r.stdout + r.stderr
    assert [_numbers_out(line) for line in r.stdout.splitlines()] == LINES[name]
    assert sorted(p.name for p in d.iterdir()) == sorted(PNGS.get(name, []))


def test_triangle_png_is_the_api_frame_and_the_jax_packages(runs):
    _, d = runs["triangle"]
    got = _png(d / "triangle_torch.png")
    np.testing.assert_array_equal(got, vt.render_triangle_rgba(512, 512, device="cpu"))
    np.testing.assert_array_equal(got, vf.render_triangle_rgba(512, 512))
    assert "rendered (512, 512, 4) uint8" in runs["triangle"][0].stdout


def test_two_triangles_hash_is_the_jax_packages(runs):
    r, _ = runs["two_triangles"]
    want = hashlib.sha256(vf.render_triangle_rgba(256, 256).tobytes()).hexdigest()
    assert r.stdout.splitlines()[:2] == [f"hash A: {want}", f"hash B: {want}"]


def test_terrain_png_is_the_api_frame(runs):
    r, d = runs["terrain"]
    ren = vt.Renderer(800, 600, device="cpu")
    x = np.linspace(-4, 4, 512, dtype=np.float32)
    dem = ((np.sin(x[None, :]) * np.cos(x[:, None]) + 1.0) * 60.0).astype(np.float32)
    ren.add_terrain(dem, spacing=(20.0, 20.0), exaggeration=1.5, colormap="viridis")
    ren.set_sun(elevation_deg=35.0, azimuth_deg=120.0)
    ren.set_exposure(1.1)
    np.testing.assert_array_equal(_png(d / "terrain_demo_torch.png"), ren.render_rgba())
    metrics = ast.literal_eval(r.stdout.splitlines()[1].split("metrics: ", 1)[1])
    assert metrics["bytes"] == 800 * 600 * 4 and metrics["render_ms"] > 0


def test_normals_flip_pngs_are_the_api_frames_and_differ(runs):
    _, d = runs["terrain_normals_flip"]
    yy, xx = np.mgrid[0:256, 0:256]
    c = 255 / 2.0
    bump = (50.0 * np.exp(-(((xx - c) ** 2 + (yy - c) ** 2) / 256 ** 2)
                          / (2 * 0.18 ** 2))).astype(np.float32)
    frames = {}
    for name, az in (("east", 90.0), ("west", 270.0)):
        ren = vt.Renderer(400, 400, device="cpu")
        ren.add_terrain(bump, spacing=(10.0, 10.0), exaggeration=1.0, colormap="viridis")
        ren.set_sun(elevation_deg=45.0, azimuth_deg=az)
        frames[name] = _png(d / f"bump_{name}_torch.png")
        np.testing.assert_array_equal(frames[name], ren.render_rgba())
    assert not np.array_equal(frames["east"], frames["west"])


def test_add_terrain_prints_what_the_original_prints(runs, tmp_path):
    r, _ = runs["add_terrain"]
    orig = subprocess.run([sys.executable, os.path.join(REPO, "python", "examples",
                                                        "add_terrain.py")],
                          cwd=tmp_path, timeout=180, capture_output=True, text=True,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert orig.returncode == 0, orig.stdout + orig.stderr
    assert r.stdout == orig.stdout


@pytest.mark.parametrize("name", NAMES)
def test_twin_without_card_exits_nonzero(tmp_path, name):
    """The default device is the card: with none visible a twin fails
    instead of rendering on the CPU, and writes nothing."""
    r = _run(name, tmp_path, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0, r.stdout + r.stderr
    assert list(tmp_path.iterdir()) == []
