"""stage_rec_setup_ms: stream ms per call in the program's ``vf.rec.setup``
spans, inside ``vf.vertex`` on the record route: the records' setup
(``triangle_setup``, under the hw rule with the 8.8 snap and the edge
thresholds) and their binning into tiles (``bin_tiles``), after the torch
vertex shader. None where the record has no such span."""

from ..program import record, stage_ms

SPAN = "vf.rec.setup"


def read(reading):
    rec = record()
    return None if rec is None or SPAN not in rec["spans"] else stage_ms(SPAN)
