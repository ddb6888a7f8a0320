"""Shared typing protocols (parity: ``vulkan_forge/types.py``)."""
from __future__ import annotations

from typing import Protocol


class SupportsPNG(Protocol):
    def render_png(self, path: str) -> None: ...
