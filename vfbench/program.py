"""The program's own record of the traced calls, ``vulkan_forge_torch._trace``:
its stage spans (``vf.inputs``, ``vf.vertex``, ``vf.raster``, ``vf.shade``,
``vf.readback``), its counters (``syncs``, ``h2d_bytes``, ``d2h_bytes``)
and its set-up spans, read by the per-layer metrics whose source is
``program_span`` or ``program_counter``.

Each figure is None unless the record holds a traced call on a CUDA
device, so a CPU run, a faked session, or a program without the record
(``ImportError``) reports none of them.
"""
from __future__ import annotations


def record():
    """The program's record, or None without a traced call on a card."""
    try:
        from vulkan_forge_torch import _trace
    except ImportError:
        return None
    snap = _trace.snapshot()
    return snap if snap["cuda_calls"] else None


def stage_ms(name: str):
    """Stream ms per traced call, averaged over the call's devices, in the
    stage spans ``name`` (0 where the calls had no such stage)."""
    rec = record()
    if rec is None:
        return None
    return rec["spans"].get(name, {"stream_ms": 0.0})["stream_ms"] / rec["device_calls"]


def per_call(*kinds: str):
    """The counters ``kinds``, summed over every span, per traced call."""
    rec = record()
    if rec is None:
        return None
    return sum(c.get(k, 0) for c in rec["counters"].values() for k in kinds) / rec["calls"]


def setup_s():
    """Host seconds of the set-up spans closed before the first traced call."""
    rec = record()
    return None if rec is None else rec["setup_before_s"]
