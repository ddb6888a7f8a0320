"""seg_kernel_roofline: the least time of ``vf_seg_gbuffer``'s work in the
traced calls (``seg_roofline.seg_bound`` of the program's ``seg_records``,
``seg_table_bytes``, ``seg_pairs`` and ``seg_pixels`` counters) as a share
of its device time in the trace (the ``device_ops`` entry whose name holds
``seg_kernel<false>``). None where the record lacks a counter or the
trace the kernel."""

from ..program import record
from ..seg_roofline import KERNEL, seg_bound

COUNTERS = ("seg_records", "seg_table_bytes", "seg_pairs", "seg_pixels")


def read(reading):
    s = reading["summary"]
    rec = record()
    if rec is None or not s.calls:
        return None
    totals = {}
    for counters in rec["counters"].values():
        for kind in COUNTERS:
            if kind in counters:
                totals[kind] = totals.get(kind, 0) + counters[kind]
    kernel_s = sum(seconds for name, seconds in s.device_ops if KERNEL in name)
    if len(totals) < len(COUNTERS) or kernel_s <= 0:
        return None
    bound_ms = seg_bound(*(totals[k] / rec["calls"] for k in COUNTERS))["bound_ms"]
    return 100.0 * bound_ms / (kernel_s / s.calls * 1e3)
