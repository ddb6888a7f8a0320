"""stage_raster_ms: stream ms per call in the program's ``vf.raster`` spans:
the route's kernel chain (cover, big-triangle pass, resolve) with its
arguments, allocations and fills; on the indexed route, the index check."""

from ..program import stage_ms


def read(reading):
    return stage_ms("vf.raster")
