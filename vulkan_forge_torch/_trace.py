"""Stage spans and counters of the public entries, on the profiler's clock.

Every public render entry opens a ``call`` span named after itself
(``vf.Renderer.render_rgba``, ``vf.TerrainSpike.render_rgba``,
``vf.Scene.render_rgba``, ``vf.render_spike_frames``,
``vf.Renderer.render_triangle_rgba``) and splits its work into stage
spans, in the order it runs:

  - ``vf.inputs``: validation, camera, LUT, the mesh's build or upload and
    the parameters' uploads, everything before the first vertex-stage op
    (it may open more than once in a call; the times add);
  - ``vf.vertex``: the vertex shader, ``clip_to_fb``, the fields' stacking
    or the records' setup and binning; on the record route it holds
    ``vf.rec.setup``, the records' setup and binning after the vertex
    shader;
  - ``vf.raster``: the route's kernel chain with its arguments (the
    indexed route's index check included), allocations and fills; on the
    segment-walk route it holds ``vf.seg.bin``, the walk's set-up before
    the kernel's wrapper: corner records with the index check, walk
    order, compaction and stacking;
  - ``vf.shade``: the torch fragment shader, where it runs outside a kernel;
  - ``vf.readback``: packing the frame and copying it to the host.

Off (no ``torch.profiler`` session recording, the default), ``call`` and
``span`` return one shared no-op context after one flag read: no
``record_function``, no CUDA event, no object. The counters cost the same
flag read.

On (while a session records), each span opens
``torch.profiler.record_function(name)``, so it lands in the session's
trace on the device ops' clock, nested in the call's span. A stage span
given CUDA devices records a timing event on each device's current stream
at entry and at exit. Its stream ms run from when the stream reached the
stage to when the stage's last op finished: the stage's device work plus
the time the device waited for the host inside the stage. A call's stages
follow one another on a stream, so they tile its timeline without
overlap; a span nested in a stage (``vf.seg.bin``, ``vf.rec.setup``) is
part of its time. Pairs whose end event has completed are resolved as
later spans open; ``snapshot`` waits for the rest.

Counters (``count``, ``h2d``, ``d2h``, ``sync``, ``device_count``,
``device_sum``) tally against the innermost open span while on:
``syncs``, every blocking wait for the device (a synchronize, a host read
of a CUDA tensor, a blocking host-to-device copy, a torch op that reads a
size back, as ``torch.nonzero`` does), and ``h2d_bytes`` and
``d2h_bytes``, the bytes moved each way. The segment-walk route adds
``seg_records``, ``seg_table_bytes`` and ``seg_pixels`` (what its kernel
reads and writes, known on the host) and ``seg_pairs`` (the (tile,
record) pairs its kernel evaluates, which the kernel counts on the
device: the record keeps the kernel's output and sums it when it is
snapshot, so the call reads nothing back for it). The record route adds
``rec_pairs``, ``rec_offsets`` and ``rec_pixels`` (the binned (tile,
record) pairs, the entries of the tiles' offsets and the frames' pixels,
known on the host) and ``rec_binned`` (the records with a pair, kept on
the device in the same way), and on its g-buffer frames ``rec_items``
(the (pair, pixel) items its kernel walks, the kernel's own count) and
``rec_covered`` (the covered pixels), kept on the device too.

Set-up spans (``setup``: ``vf.setup.load``, ``vf.Renderer.add_terrain``,
``vf.Renderer.upload_height_r32f``, ``vf.mesh``) wrap one-off work and
always time their host seconds, with a ``record_function`` only while on.
The record keeps apart the set-up seconds closed before the first span
that opened while on.

The record is one per process and meant for one thread at a time.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque

import torch

# torch's own flag, the one ``record_function`` consults.
on = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()


class Record:
    """What traced calls left: per span name [spans, host s, stream ms],
    per innermost span name the counters, the set-up spans' seconds."""

    def __init__(self):
        self.calls = 0           # traced calls
        self.cuda_calls = 0      # of them, calls with a stage on a CUDA device
        self.device_calls = 0    # the CUDA devices of those calls, summed
        self.spans = {}
        self.counters = {}
        self.setup_s = {}
        self.setup_before_s = 0.0
        self.seen_on = False
        self.stack = []          # the spans open while on, innermost last
        self.call_devices = None  # the CUDA devices of the open call
        self.pending = deque()   # (name, start event, end event)
        self.on_device = []      # (name, kind, device tensor to sum)

    def add(self, name, host_s=0.0, stream_ms=0.0, n=1):
        agg = self.spans.setdefault(name, [0, 0.0, 0.0])
        agg[0] += n
        agg[1] += host_s
        agg[2] += stream_ms

    def tally(self, kind, n):
        if self.stack:
            c = self.counters.setdefault(self.stack[-1], {})
            c[kind] = c.get(kind, 0) + n

    def settle(self):
        """Tally the device counts kept so far."""
        for name, kind, t in self.on_device:
            c = self.counters.setdefault(name, {})
            c[kind] = c.get(kind, 0) + int(t.sum(dtype=torch.int64))
        self.on_device = []

    def resolve(self, wait=False):
        while self.pending:
            name, start, end = self.pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.pending.popleft()
            self.add(name, stream_ms=start.elapsed_time(end), n=0)


RECORD = Record()


def reset() -> None:
    """Start a new record."""
    global RECORD
    RECORD = Record()


def _cuda(device):
    """The distinct CUDA devices among ``device`` (None, one device or a
    list), each with its index."""
    if device is None:
        return ()
    devs = device if isinstance(device, (list, tuple)) else (device,)
    cards = (torch.device(d) for d in devs)
    return tuple(dict.fromkeys(
        d if d.index is not None else torch.device("cuda", torch.cuda.current_device())
        for d in cards if d.type == "cuda"))


class _Span:
    __slots__ = ("name", "devices", "entry", "rec", "fn", "t0", "events")

    def __init__(self, name, device=None, entry=False):
        self.name, self.entry = name, entry
        self.devices = _cuda(device)

    def __enter__(self):
        rec = self.rec = RECORD
        rec.seen_on = True
        rec.resolve()
        if self.entry:
            self.entry = rec.call_devices is None  # only the outermost call counts
            if self.entry:
                rec.call_devices = set()
        elif self.devices and rec.call_devices is not None:
            rec.call_devices.update(self.devices)
        rec.stack.append(self.name)
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.events = []
        for d in self.devices:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            self.events.append((d, ev))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        rec = self.rec
        for d, start in self.events:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(d))
            rec.pending.append((self.name, start, end))
        self.fn.__exit__(*exc)
        rec.stack.pop()
        rec.add(self.name, host_s)
        if self.entry:
            rec.calls += 1
            n = len(rec.call_devices)
            rec.cuda_calls += n > 0
            rec.device_calls += n
            rec.call_devices = None
        return False


def call(name: str):
    """A public entry's span: one traced call."""
    return _Span(name, entry=True) if on() else _OFF


def span(name: str, device=None):
    """A stage span, timed on the streams of ``device`` (None, a device or
    a list of devices) where they are CUDA devices."""
    return _Span(name, device) if on() else _OFF


@contextlib.contextmanager
def setup(name: str):
    """A set-up span: host seconds always, a trace range while on."""
    rec = RECORD
    t0 = time.perf_counter()
    try:
        with (_Span(name) if on() else _OFF):
            yield
    finally:
        dt = time.perf_counter() - t0
        rec.setup_s[name] = rec.setup_s.get(name, 0.0) + dt
        if not rec.seen_on:
            rec.setup_before_s += dt


def count(kind: str, n: int = 1) -> None:
    """Tally ``n`` of ``kind`` against the innermost open span, while on."""
    if on():
        RECORD.tally(kind, n)


def h2d(src, dst: torch.Tensor) -> torch.Tensor:
    """``dst``, made by a blocking copy from ``src`` (an array, a list or a
    tensor): a sync and its bytes when the copy went from the host to a
    card."""
    if on() and dst.is_cuda and not (isinstance(src, torch.Tensor) and src.is_cuda):
        RECORD.tally("syncs", 1)
        RECORD.tally("h2d_bytes", dst.nbytes)
    return dst


def d2h(t: torch.Tensor) -> torch.Tensor:
    """``t``, which the host is about to read: a sync and its bytes when it
    is on a card."""
    if on() and t.is_cuda:
        RECORD.tally("syncs", 1)
        RECORD.tally("d2h_bytes", t.nbytes)
    return t


def sync(t: torch.Tensor, n: int = 1) -> torch.Tensor:
    """``t``, from which a torch op is about to read ``n`` values back to
    the host before it returns (``torch.nonzero``'s count, the size of a
    ``repeat_interleave``): ``n`` syncs when it is on a card."""
    if on() and t.is_cuda:
        RECORD.tally("syncs", n)
    return t


def device_sum(kind: str, t: torch.Tensor) -> None:
    """While on, keep the tensor ``t``, whose sum tallies as ``kind``
    against the innermost open span when the record is snapshot: the call
    reads nothing back for it."""
    if on() and RECORD.stack:
        RECORD.on_device.append((RECORD.stack[-1], kind, t))


def device_count(kind: str, shape, device):
    """While on, a zeroed int32 tensor of ``shape`` on ``device`` for a
    kernel to count into, whose sum tallies as ``kind`` (``device_sum``);
    None while off."""
    if not on():
        return None
    t = torch.zeros(shape, dtype=torch.int32, device=device)
    device_sum(kind, t)
    return t


def snapshot() -> dict:
    """The record so far: ``calls``, ``cuda_calls`` and ``device_calls``;
    ``spans``, per name {count, host_s, stream_ms}, and ``counters``, per
    innermost span name {kind: n}, both empty unless a traced call ran on
    a CUDA device; ``setup_s``, per set-up span name, and
    ``setup_before_s``. Waits for the stream events still pending and
    sums the device counts."""
    rec = RECORD
    rec.resolve(wait=True)
    rec.settle()
    staged = rec.cuda_calls > 0
    return {
        "calls": rec.calls, "cuda_calls": rec.cuda_calls, "device_calls": rec.device_calls,
        "spans": {name: {"count": n, "host_s": h, "stream_ms": s}
                  for name, (n, h, s) in rec.spans.items()} if staged else {},
        "counters": {name: dict(c) for name, c in rec.counters.items()} if staged else {},
        "setup_s": dict(rec.setup_s), "setup_before_s": rec.setup_before_s,
    }
