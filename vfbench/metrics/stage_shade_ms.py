"""stage_shade_ms: stream ms per call in the program's ``vf.shade`` spans:
the torch fragment shader where it runs outside a kernel (0 where the
shader runs inside the raster kernels)."""

from ..program import stage_ms


def read(reading):
    return stage_ms("vf.shade")
