"""Input validators for the public API.

The *error strings and bounds* are a pinned behavior contract with the
reference shim (python/vulkan_forge/_validate.py:1-40: dims <= 8192, grid in
[2, 4096], .png suffix + existing parent directory) -- tests assert the exact
messages. The implementation below is this package's own: a small
coerce-then-check helper driving every rule, rather than per-field bespoke
branches.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

MAX_DIM = 8192
GRID_MIN, GRID_MAX = 2, 4096


def _int_field(value, name: str, checks) -> int:
    """Coerce ``value`` to int, then apply (predicate, message) rules in
    order, raising ValueError with the pinned message on first failure."""
    try:
        n = int(value)
    except Exception as err:
        raise ValueError(
            f"{name} must be an integer, got {type(value).__name__}") from err
    for pred, message in checks:
        if not pred(n):
            raise ValueError(message)
    return n


def size_wh(width, height) -> Tuple[int, int]:
    # Rule ordering matches the reference shim: BOTH dims pass the > 0
    # check before either is held to the <= MAX_DIM bound (so e.g.
    # size_wh(9000, 0) reports the > 0 violation).
    dims = [_int_field(v, name, ())
            for name, v in (("width", width), ("height", height))]
    for rule, message in (
            (lambda n: n > 0, "width and height must be > 0"),
            (lambda n: n <= MAX_DIM, f"width/height must be <= {MAX_DIM}")):
        for n in dims:
            if not rule(n):
                raise ValueError(message)
    return dims[0], dims[1]


def grid(n) -> int:
    return _int_field(n, "grid", (
        (lambda g: g >= GRID_MIN, f"grid must be >= {GRID_MIN}"),
        (lambda g: g <= GRID_MAX, f"grid must be <= {GRID_MAX}"),
    ))


def png_path(p: "str | Path") -> str:
    s = str(p)
    if not s.lower().endswith(".png"):
        raise ValueError("path must end with .png")
    parent = Path(s).resolve().parent
    if not parent.exists():
        raise ValueError(f"directory does not exist: {parent}")
    return s
