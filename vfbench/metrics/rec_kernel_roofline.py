"""rec_kernel_roofline: the least time of ``vf_raster_gbuffer_hw``'s work
in the traced calls (``rec_roofline.rec_bound`` of the program's
``rec_binned``, ``rec_pairs``, ``rec_offsets``, ``rec_items``,
``rec_covered`` and ``rec_pixels`` counters) as a share of the device
time of the port's own kernels in the trace (class ``port``).

On the record route's g-buffer frames those kernels are
``vf_raster_gbuffer_hw`` and the extended shader,
``vf_terrain_fs_extended`` (about a sixth of their time at 800x600). The
trace's ``device_ops`` keeps the ten largest ops by name, which on this
route are all torch's, so the record kernel's own time cannot be read
apart from the shader's: the share reads low by the shader's part, never
high. None where the record lacks a counter or the trace a port kernel."""

from ..program import record
from ..rec_roofline import rec_bound

COUNTERS = ("rec_binned", "rec_pairs", "rec_offsets", "rec_items", "rec_covered",
            "rec_pixels")


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
    port_s = s.class_s["port"]
    if len(totals) < len(COUNTERS) or port_s <= 0:
        return None
    bound_ms = rec_bound(*(totals[k] / rec["calls"] for k in COUNTERS))["bound_ms"]
    return 100.0 * bound_ms / (port_s / s.calls * 1e3)
