"""The traced run: a torch.profiler session over a run of calls, and the
reading of its device trace into per-class device time, busy and idle
time, spans, and the top device ops and idle gaps.

Device events are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` records. They fall into three classes:

- ``copy``: host <-> device copies (memcpy HtoD and DtoH);
- ``port``: the port's own CUDA kernels, those whose names the port's
  sources declare ``__global__`` (``vulkan_forge_torch/csrc/*.cu``);
- ``torch``: everything else (PyTorch's kernels, memsets, device copies).

Profiler sessions on the card have kept only part of their records, or
none. ``launch_count`` reads the port's own count of kernel launches (the
``.launches`` counter of each wrapper in ``_raster/kernels.py``); a
session whose trace holds another number of port launches than the
counters moved by is incomplete, and the run says so and reports no
per-layer metric from it.
"""
from __future__ import annotations

import heapq
import json
import os
import re
import shutil
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")


def port_kernel_names(csrc: Path) -> frozenset:
    """The names of the kernels the port's CUDA sources declare."""
    names = set()
    for src in sorted(Path(csrc).glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return frozenset(names)


def kernel_ident(name: str) -> str:
    """A device kernel's function name without return type, namespaces,
    template arguments or parameters: "void (anonymous namespace)::f<true>
    (int)" -> "f"."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = head.split("<", 1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else ""


def classify(event: dict, port_names) -> str:
    name = event["name"]
    if event["cat"] == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name):
        return "copy"
    if event["cat"] == "kernel" and kernel_ident(name) in port_names:
        return "port"
    return "torch"


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _top(totals: dict):
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], seconds] for name, seconds in ranked]


@dataclass
class Summary:
    """What one traced window holds: ``calls`` complete call spans over
    ``window_s`` seconds, ``busy_s`` of them with a device op running (on
    each device, averaged over the devices),
    device seconds by class, port kernel launches, host seconds by span
    name, and the top device ops and idle gaps (by what the host was
    doing), each [name, seconds]."""
    calls: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    class_s: dict = field(default_factory=lambda: {"copy": 0.0, "port": 0.0, "torch": 0.0})
    port_launches: int = 0
    device_events: int = 0
    span_s: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def summarize(events, port_names, call_prefix: str, devices: int = 1) -> Summary:
    """Read a chrome trace's events (dicts with name, cat, ts and dur in
    microseconds; a device op's ``args`` name its ``device``). The window
    runs from the start of the first span whose name starts with
    ``call_prefix`` to the end of the last; ``devices`` is the number of
    devices the run uses. Idle gaps are the times no device is busy."""
    out = Summary()
    spans = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
    calls = [e for e in spans if e["name"].startswith(call_prefix)]
    if not calls:
        return out
    t0 = min(e["ts"] for e in calls)
    t1 = max(e["ts"] + e["dur"] for e in calls)
    out.calls = len(calls)
    out.window_s = (t1 - t0) * 1e-6
    for e in spans:
        out.span_s[e["name"]] = out.span_s.get(e["name"], 0.0) + e["dur"] * 1e-6

    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
              and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    out.device_events = len(device)
    ops = {}
    for e in device:
        cls = classify(e, port_names)
        out.class_s[cls] += e["dur"] * 1e-6
        out.port_launches += cls == "port"
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] * 1e-6
    out.device_ops = _top(ops)

    def clipped(evs):
        return _merge((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in evs)

    by_device = {}
    for e in device:
        by_device.setdefault(e.get("args", {}).get("device", 0), []).append(e)
    out.busy_s = sum(e - s for evs in by_device.values() for s, e in clipped(evs)) \
        * 1e-6 / max(devices, 1)
    busy = clipped(device)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    gaps = {}
    for (s, e), what in zip(idle, _innermost(events, [(s + e) / 2 for s, e in idle])):
        gaps[what] = gaps.get(what, 0.0) + (e - s) * 1e-6
    out.idle_gaps = _top(gaps)
    return out


def _innermost(events, times):
    """For each of the ascending ``times``, the name of the host event open
    then that started last ("no host span" where none is open)."""
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e)
    heap, i, names = [], 0, []
    for t in times:
        while i < len(host) and host[i][0] <= t:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "no host span")
    return names


def launch_count() -> int:
    """The port's kernel launches so far: the sum of the ``.launches``
    counters of the wrappers in ``vulkan_forge_torch._raster.kernels``."""
    from vulkan_forge_torch._raster import kernels
    return sum(f.launches for f in vars(kernels).values()
               if callable(f) and isinstance(getattr(f, "launches", None), int))


class Session:
    """One torch.profiler session (CPU and CUDA activity) over the calls
    made between ``start()`` and ``stop()``; ``stop()`` returns the
    trace's events and the port launches the counters moved by."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._launches = launch_count()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        launches = launch_count() - self._launches
        tmp = tempfile.mkdtemp()
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            self._prof = None
        return events, launches
