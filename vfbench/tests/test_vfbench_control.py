"""The comparison that decides ``correct`` fails where it should: the
control (the reference with TF32 vertex transforms) fails each cell's
limits, and a run whose timed path is broken underneath reads ``correct``
false, once for each fault a cell can have: an answer altered where it is
produced, half of the batch left out, and a step that leaves the
program's state unchanged. The CPU cases run at a small size; the gpu
case at the cells' own size."""
from __future__ import annotations

import json

import numpy as np
import pytest

import vulkan_forge_torch as vt
from vfbench import check, control, generator, run, spec
from vfbench.tests.conftest import REPO, VIEWS, make_root, runnable

CELLS = [c["name"] for c in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
RUNNABLE = runnable(json.loads((REPO / "BENCHMARK.json").read_text()))


def driver_of(root, cell, seed, device):
    bench = spec.benchmark(root)
    entry = spec.cell(bench, cell)
    mix = spec.traffic(root, entry["traffic"])
    d = generator.build(spec.config(root, bench, entry["config"]), mix, seed, [device])
    d.setup()
    return d, mix, spec.limits(root, cell)


def over(numbers, limits):
    return [n for n in check.NUMBERS if numbers[n] > limits[n]]


@pytest.mark.parametrize("cell", RUNNABLE)
def test_control_fails_and_the_program_passes_at_a_small_size(tmp_path, cell):
    root = make_root(tmp_path, width=200, height=150, grid=64, dem=129)
    d, mix, limits = driver_of(root, cell, 3000000041, "cpu")
    assert not over(control.readings(d, mix["check_calls"], control=False), limits)
    assert over(control.readings(d, mix["check_calls"], control=True), limits)


@pytest.mark.parametrize("cell", RUNNABLE)
def test_the_control_in_the_programs_place_reads_incorrect(tmp_path, capsys, monkeypatch,
                                                           cell):
    """The whole run, with the control serving each call in the program's
    place: ``run.main``'s last line reads ``correct`` false."""
    root = make_root(tmp_path, width=200, height=150, grid=64, dem=129)
    mix = spec.traffic(root, spec.cell(spec.benchmark(root), cell)["traffic"])
    entry = generator.driver_class(mix["entry"])
    monkeypatch.setattr(entry, "call", control.control_frames)
    rc = run.main(["--workload", cell, "--seed", "3000000053", "--seconds", "0.3"],
                  root=root, device="cpu")
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, err
    assert line["failed"] == 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cuda_device, cell):
    d, mix, limits = driver_of(REPO, cell, 3000000043, cuda_device)
    assert over(control.readings(d, mix["check_calls"], control=True), limits)


def alter_one_byte(frames):
    frames = frames.copy()
    frames[0, 7, 5, 1] ^= 0x80
    return frames


def _spike_altered(real):
    return lambda *a, **k: alter_one_byte(real(*a, **k))


def _spike_half_batch(real):
    def half(width, height, grid, eyes, **k):
        frames = real(width, height, grid, eyes[:len(eyes) // 2], **k)
        return np.concatenate([frames, frames])
    return half


def _method_altered(real):
    return lambda self: alter_one_byte(real(self)[None])[0]


FAULTS = {
    "answer altered (views)": ("spike_g1024.views_b4", vt, "render_spike_frames",
                               _spike_altered),
    "half the batch left out": ("spike_g1024.views_b4", vt, "render_spike_frames",
                                _spike_half_batch),
    "answer altered (turntable)": ("spike_g1024.turntable", vt.TerrainSpike, "render_rgba",
                                   _method_altered),
    "camera left unchanged": ("spike_g1024.turntable", vt.TerrainSpike,
                              "set_camera_look_at", lambda real: lambda self, *a: None),
    "answer altered (relight)": ("srtm1.relight", vt.Renderer, "render_rgba",
                                 _method_altered),
    "sun left unchanged": ("srtm1.relight", vt.Renderer, "set_sun",
                           lambda real: lambda self, *a: None),
    "tile left unchanged": ("srtm1.tiles", vt.Renderer, "upload_height_r32f",
                            lambda real: lambda self: real(self) if self._height_tex is None
                            else None),
    "answer altered (tiles)": ("srtm1.tiles", vt.Renderer, "render_rgba", _method_altered),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_reads_incorrect(tiny_root, capsys, monkeypatch, fault):
    cell, owner, name, breaker = FAULTS[fault]
    monkeypatch.setattr(owner, name, breaker(getattr(owner, name)))
    rc = run.main(["--workload", cell, "--seed", "3000000047", "--seconds", "0.6"],
                  root=tiny_root, device="cpu")
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, err
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_a_sound_run_reads_correct(tiny_root, capsys):
    for cell in RUNNABLE:
        rc = run.main(["--workload", cell, "--seed", "3000000047", "--seconds", "0.3"],
                      root=tiny_root, device="cpu")
        line = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
        assert rc == 0 and line["correct"] is True
