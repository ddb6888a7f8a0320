"""Fragment stage of the PyTorch port against ``vulkan_forge`` (CPU).

Inputs are seeded numpy arrays fed to both packages. Tolerances:
- ``pack_rgba_u32`` and the u8 unpack are exact (floor(x*255+0.5) of the
  same f32 values);
- ``srgb_encode`` and the LUT sample within a few f32 ulps (pow differs
  between math libraries; XLA contracts the LUT lerp's multiply-add);
- shaded images follow the FS policy (every differing byte off by 1, on
  at most 1e-4 of the bytes).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vulkan_forge import _colormap as jcmap, _formats as jfmt
from vulkan_forge._raster import fragment as jfrag

from vulkan_forge_torch import _formats as tfmt
from vulkan_forge_torch._parity import assert_fs_policy
from vulkan_forge_torch._raster import fragment as tfrag

# The plain raster is a loop of small eager ops: one intra-op thread is the
# fastest setting on the CPU and keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def test_srgb_encode_matches():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, 200_000).astype(np.float32)
    x[:4] = [0.0, 0.0031308, 1.0, 1e-13]
    got = tfmt.srgb_encode(torch.from_numpy(x)).numpy()
    want = np.asarray(jfmt.srgb_encode(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=1e-9)


def test_pack_and_unpack_match():
    rng = np.random.default_rng(1)
    ch = [rng.uniform(-0.1, 1.1, (37, 53)).astype(np.float32) for _ in range(4)]
    ch[0][0, :4] = [0.5 / 255, 254.5 / 255, 0.0, 1.0]
    got = tfmt.pack_rgba_u32(*[torch.from_numpy(c) for c in ch])
    assert got.dtype == torch.uint32
    want = np.asarray(jfmt.pack_rgba_u32(*[jnp.asarray(c) for c in ch]))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(tfmt.u32_image_to_rgba_u8(got).numpy(),
                                  jfmt.u32_image_to_rgba_u8(want))


@pytest.mark.parametrize("name", ["viridis", "magma", "terrain"])
def test_sample_lut_bilinear_matches(name):
    lut, _ = jcmap.build_lut(name)
    t = np.random.default_rng(2).uniform(-0.05, 1.05, 50_000).astype(np.float32)
    t[:3] = [0.0, 1.0, 0.5 / 256]
    got = tfrag.sample_lut_bilinear(torch.from_numpy(lut), torch.from_numpy(t)).numpy()
    want = np.asarray(jfrag.sample_lut_bilinear(jnp.asarray(lut), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-9)


def _gbuffer(seed, h=64, w=96):
    rng = np.random.default_rng(seed)
    hh = rng.uniform(-0.8, 0.8, (h, w)).astype(np.float32)
    xx = rng.uniform(-1.5, 1.5, (h, w)).astype(np.float32)
    zz = rng.uniform(-1.5, 1.5, (h, w)).astype(np.float32)
    mask = rng.uniform(size=(h, w)) < 0.8
    return hh, xx, zz, mask


@pytest.mark.parametrize("seed,name,h_range,exposure,sun", [
    (3, "viridis", 1.0, 1.0, (0.5, 0.8, 0.6)),
    (4, "magma", 0.7, 1.3, (0.2, 1.0, -0.4)),
    (5, "terrain", 0.0, 0.8, (-0.3, 0.5, 0.9)),      # h_range guard 1e-8
])
def test_terrain_fs_matches(seed, name, h_range, exposure, sun):
    lut, _ = jcmap.build_lut(name)
    hh, xx, zz, mask = _gbuffer(seed)
    sun = np.asarray(sun, np.float32)
    f32 = np.float32
    got = tfrag.terrain_fs(*(torch.from_numpy(a) for a in (hh, xx, zz, mask)),
                           torch.from_numpy(lut), torch.tensor(f32(h_range)),
                           torch.tensor(f32(exposure)), torch.from_numpy(sun))
    want = np.asarray(jfrag.terrain_fs(
        *(jnp.asarray(a) for a in (hh, xx, zz, mask)), jnp.asarray(lut),
        jnp.float32(h_range), jnp.float32(exposure), jnp.asarray(sun)))
    assert got.dtype == torch.uint32 and got.shape == want.shape
    assert_fs_policy(_u32(got), want, f"terrain_fs {name}")
    # Uncovered pixels are the clear color, byte for byte.
    np.testing.assert_array_equal(_u32(got)[~mask], want[~mask])


def test_triangle_fs_matches():
    rng = np.random.default_rng(6)
    r, g, b = (rng.uniform(0, 1, (48, 80)).astype(np.float32) for _ in range(3))
    mask = rng.uniform(size=(48, 80)) < 0.6
    got = tfrag.triangle_fs(*(torch.from_numpy(a) for a in (r, g, b, mask)))
    want = np.asarray(jfrag.triangle_fs(*(jnp.asarray(a) for a in (r, g, b, mask))))
    assert_fs_policy(_u32(got), want, "triangle_fs")
    np.testing.assert_array_equal(_u32(got)[~mask], want[~mask])


def test_fs_policy_helper_rejects():
    a = np.zeros((200, 200, 4), np.uint8)
    b = a.copy()
    b[0, 0, 0] = 2
    with pytest.raises(AssertionError, match="byte delta"):
        assert_fs_policy(a, b)
    b[0, 0, 0] = 1
    assert assert_fs_policy(a, b, "one byte") == (1, 1 / a.size)
    c = np.ones((200, 200, 4), np.uint8)
    with pytest.raises(AssertionError, match="of bytes differ"):
        assert_fs_policy(a, c)
