"""Color transfer functions and u8 packing on torch tensors.

Port of ``vulkan_forge/_formats.py``: the exact 2.4-gamma piecewise sRGB
encode and the ``floor(x*255 + 0.5)`` quantization, with the same float32
literals and op order as the jnp versions. The numpy decode used by the LUT
lives in ``_colormap.srgb_decode_np``.

torch has no ``<<`` on uint32, so words are packed in int32 and the caller
views the bits as ``torch.uint32`` (alpha 255 is int32 -16777216).
"""
from __future__ import annotations

import torch


def srgb_encode(c: torch.Tensor) -> torch.Tensor:
    """Linear [0,1] -> sRGB-encoded [0,1] (float32)."""
    c = torch.clamp(c.to(torch.float32), 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-12), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def _to_byte(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.int32)


def pack_rgba_u32(r, g, b, a) -> torch.Tensor:
    """Pack four [0,1] float channels into little-endian RGBA words.

    Returns a ``torch.uint32`` tensor whose bytes are the (..., 4) u8 RGBA
    layout the reference returns (src/lib.rs:305-308).
    """
    word = (_to_byte(r) | (_to_byte(g) << 8) | (_to_byte(b) << 16)
            | (_to_byte(a) << 24))
    return word.view(torch.uint32)


def u32_image_to_rgba_u8(img_u32: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint32/int32 words -> (..., H, W, 4) uint8 (little-endian RGBA)."""
    if img_u32.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"expected a uint32 or int32 image, got {img_u32.dtype}")
    img_u32 = img_u32.contiguous()
    return img_u32.view(torch.uint8).reshape(*img_u32.shape, 4)
