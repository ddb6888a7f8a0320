"""stage_vertex_ms: stream ms per call in the program's ``vf.vertex`` spans:
the vertex shader, ``clip_to_fb`` and the fields' stacking (or the records'
setup and binning)."""

from ..program import stage_ms


def read(reading):
    return stage_ms("vf.vertex")
