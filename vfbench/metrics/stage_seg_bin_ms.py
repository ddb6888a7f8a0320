"""stage_seg_bin_ms: stream ms per call in the program's ``vf.seg.bin``
spans, inside ``vf.raster`` on the segment-walk route: the corner records
with the index check, the walk order (both axes' tables and estimates),
the compaction and the stacking, before the kernel's wrapper. None where
the record has no such span."""

from ..program import record, stage_ms

SPAN = "vf.seg.bin"


def read(reading):
    rec = record()
    return None if rec is None or SPAN not in rec["spans"] else stage_ms(SPAN)
