"""stage_readback_ms: stream ms per call in the program's ``vf.readback``
spans: packing the frames and copying them to the host."""

from ..program import stage_ms


def read(reading):
    return stage_ms("vf.readback")
