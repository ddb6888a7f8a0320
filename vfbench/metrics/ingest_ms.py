"""ingest_ms: host ms per call inside the benchmark's ``vfbench.ingest``
span, around ``Renderer.add_terrain`` and ``upload_height_r32f``."""

from ..generator import INGEST_SPAN


def read(reading):
    s = reading["summary"]
    if not s.calls or INGEST_SPAN not in s.span_s:
        return None
    return s.span_s[INGEST_SPAN] / s.calls * 1e3
