"""transfer_mb: MB (1e6 bytes) per call the program copies between host and
device, its ``h2d_bytes`` and ``d2h_bytes`` counters."""

from ..program import per_call


def read(reading):
    n = per_call("h2d_bytes", "d2h_bytes")
    return None if n is None else n / 1e6
