"""Device resolution for the PyTorch port.

Every entry point takes an explicit ``device=`` argument; this module turns
``None``/``"cuda"``/``"cpu"`` (or a ``torch.device``) into a
``torch.device`` and reports what the card is. The full ``device_probe`` /
``enumerate_adapters`` surface of ``vulkan_forge/_device.py`` is not ported
yet (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA when a card is visible, else the CPU.

    An explicit ``"cuda"`` without a card raises: nothing falls back.
    """
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; expected 'cpu' or 'cuda'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return dev


def device_info(device=None) -> Dict[str, Any]:
    """Name, compute capability and library versions of ``device``."""
    dev = resolve_device(device)
    info: Dict[str, Any] = {
        "device": str(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        info["name"] = torch.cuda.get_device_name(index)
        info["capability"] = tuple(torch.cuda.get_device_capability(index))
        info["count"] = torch.cuda.device_count()
    else:
        info["name"] = "cpu"
        info["capability"] = None
        info["count"] = 0
    return info
