"""Many-camera frames over torch devices (``vulkan_forge_torch._parallel``)
against ``vulkan_forge._parallel.render_spike_frames`` on the CPU, and the
cases of ``tests/test_parallel.py``: one device, the padding of the camera
batch to the device count, the validation errors. The card's case is in
``tests/test_torch_cuda.py``, which imports no jax.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import vulkan_forge as vf
from vulkan_forge._parallel import render_spike_frames as jax_spike_frames

import vulkan_forge_torch as vt
from vulkan_forge_torch._parallel import render_spike_frames
from vulkan_forge_torch._parity import assert_fs_policy

torch.set_num_threads(1)

EYES = [(3.0, 2.0, 3.0), (-3.0, 2.0, 3.0)]


def _spike(mod, w, h, grid, eye, colormap="viridis", **dev):
    t = mod.TerrainSpike(w, h, grid, colormap, **dev)
    t.set_camera_look_at(eye, (0, 0, 0), (0, 1, 0), 45.0, 0.1, 100.0)
    return t.render_rgba()


@pytest.mark.parametrize("colormap", ["viridis", "terrain"])
def test_render_spike_frames_matches_jax(colormap):
    """The port's frames against JAX's on the same eyes (160x120 g16, one
    CPU device each). They differ exactly where the two packages' single-
    frame APIs differ on the same camera -- render_spike_frames adds no
    difference of its own -- and within the FS policy (on this host: one
    byte by 1 under viridis, none under terrain)."""
    import jax
    want = jax_spike_frames(160, 120, 16, EYES, colormap=colormap,
                            devices=jax.devices("cpu")[:1])
    got = render_spike_frames(160, 120, 16, EYES, colormap=colormap, devices=["cpu"])
    assert got.shape == want.shape == (2, 120, 160, 4) and got.dtype == np.uint8
    assert_fs_policy(got, want, f"render_spike_frames {colormap}")
    for eye, g, w in zip(EYES, got, want):
        port, ref = _spike(vt, 160, 120, 16, eye, colormap, device="cpu"), \
            _spike(vf, 160, 120, 16, eye, colormap)
        np.testing.assert_array_equal(g, port)
        np.testing.assert_array_equal(w, ref)
        np.testing.assert_array_equal(g != w, port != ref)
    if colormap == "terrain":
        np.testing.assert_array_equal(got, want)


def test_render_spike_frames_single_device():
    imgs = render_spike_frames(160, 120, 16, EYES, devices=["cpu"])
    assert imgs.shape == (2, 120, 160, 4) and imgs.dtype == np.uint8
    assert not np.array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[0], _spike(vt, 160, 120, 16, EYES[0], device="cpu"))


def test_render_spike_frames_autopads_to_device_count():
    # B=3 on two devices: padded to 4 internally, the pad frame dropped.
    eyes = [(3.0, 2.0, 3.0), (-3.0, 2.0, 3.0), (0.0, 2.5, 4.0)]
    imgs = render_spike_frames(96, 64, 12, eyes, devices=["cpu", torch.device("cpu")])
    assert imgs.shape == (3, 64, 96, 4), imgs.shape
    for eye, img in zip(eyes, imgs):
        np.testing.assert_array_equal(img, _spike(vt, 96, 64, 12, eye, device="cpu"))


def test_render_spike_frames_camera_arguments():
    eye = (2.0, 1.5, 2.5)
    img = render_spike_frames(64, 48, 8, [eye], colormap="magma", fovy_deg=50.0, znear=0.2,
                              zfar=40.0, devices=["cpu"])[0]
    t = vt.TerrainSpike(64, 48, 8, "magma", device="cpu")
    t.set_camera_look_at(eye, (0, 0, 0), (0, 1, 0), 50.0, 0.2, 40.0)
    np.testing.assert_array_equal(img, t.render_rgba())


def test_render_spike_frames_validation():
    with pytest.raises(ValueError, match="at least one camera"):
        render_spike_frames(64, 64, 8, [], devices=["cpu"])
    with pytest.raises(RuntimeError, match="Unknown colormap"):
        render_spike_frames(64, 64, 8, [(3, 2, 3)], colormap="bad", devices=["cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        render_spike_frames(64, 64, 8, [(3, 2, 3)], devices=[])
    with pytest.raises(ValueError, match="unsupported device"):
        render_spike_frames(64, 64, 8, [(3, 2, 3)], devices=["meta"])


@pytest.mark.parametrize("args", [(0, 64, 8, [(3, 2, 3)]), (9000, 64, 8, [(3, 2, 3)]),
                                  (64, 64, 1, [(3, 2, 3)]), (64, 64, 5000, [(3, 2, 3)]),
                                  (64, 64, 8, []), ("x", 64, 8, [(3, 2, 3)])])
def test_validation_errors_are_the_reference_strings(args):
    """Each bad argument raises the reference's type and message, checked
    in the reference's order (size, grid, colormap, cameras)."""
    with pytest.raises(Exception) as want:
        jax_spike_frames(*args)
    with pytest.raises(type(want.value), match=f"^{re.escape(str(want.value))}$"):
        render_spike_frames(*args, devices=["cpu"])


def test_unknown_colormap_message_is_the_reference():
    with pytest.raises(RuntimeError, match="Unknown colormap") as want:
        jax_spike_frames(64, 64, 8, [], colormap="plasma")
    with pytest.raises(RuntimeError) as got:
        render_spike_frames(64, 64, 8, [], colormap="plasma", devices=["cpu"])
    assert str(got.value) == str(want.value)


def test_default_devices_without_card_raise(monkeypatch):
    """devices=None means every CUDA device; without one it raises and does
    not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        render_spike_frames(64, 48, 8, [(3.0, 2.0, 3.0)])
    with pytest.raises(RuntimeError, match="is_available"):
        vt.render_spike_frames(64, 48, 8, [(3.0, 2.0, 3.0)], devices=["cuda"])
