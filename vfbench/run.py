"""Run one cell of the benchmark once, on the machine it is started on.

    python3 -m vfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the program's libraries,
the cell's inputs, the warm-up calls) runs from this module's first line
to the first timed call; then one client calls the cell's public entry in
a closed loop for ``--seconds``, each call timed on the host clock until
it returns its frames. Once the window has closed, the reference checks a
sample of the calls. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines of standard error).

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs
the window with a profiler session over the first ``trace_calls`` calls
(up to ``TRACE_ATTEMPTS`` sessions, until one is complete) and reports
the cell's per-layer metrics.

Exit codes: 0 with a result; 2 without a CUDA device for each chip the
cell asks for, or a cell, configuration or mix not found; 3 if JAX or the
JAX package was loaded in this process. Those print no result.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

from . import check, generator, roofline, spec, trace  # noqa: E402
from .reference import raster  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRACE_ATTEMPTS = 3
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vulkan_forge"})


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m vfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout. The port builds its libraries under ``build/vulkan_forge_torch``
    by itself; Triton and torch's extension builds go beside them."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "vfbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "vfbench" / "torch_extensions")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``vulkan_forge_torch`` is not
    ``vulkan_forge``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


class Tracing:
    """Profiler sessions over the window's first calls: one of
    ``calls`` calls, and another over the next calls while a session's
    trace is incomplete, up to ``TRACE_ATTEMPTS``."""

    def __init__(self, calls: int, driver, port_names, devices: int = 1):
        self.calls, self.driver, self.port_names = calls, driver, port_names
        self.devices = devices
        self.session, self.attempts, self.kept = None, 0, []
        self.summary, self.least_ms, self.why = None, 0.0, []

    @property
    def pending(self) -> bool:
        return self.summary is None and self.attempts < TRACE_ATTEMPTS

    def before_call(self) -> None:
        if self.pending and self.session is None:
            self.session, self.kept = trace.Session(), []
            self.attempts += 1
            self.session.start()

    def after_call(self, inputs, frames) -> None:
        if self.session is None:
            return
        self.kept.append((inputs, frames))
        if len(self.kept) < self.calls:
            return
        events, launches = self.session.stop()
        self.session = None
        got = trace.summarize(events, self.port_names, generator.CALL_SPAN, self.devices)
        complete = (got.calls == len(self.kept) and got.port_launches == launches
                    and got.device_events > 0)
        if not complete:
            self.why.append(f"session {self.attempts}: {got.calls} of {len(self.kept)} call "
                            f"spans, {got.port_launches} port kernel launches of {launches} "
                            f"counted, {got.device_events} device events; top device "
                            f"ops {[name for name, _ in got.device_ops[:4]]}")
            return
        self.summary = got
        clear = raster.clear_bytes()
        for inp, frames in self.kept:
            if frames is not None:
                work = roofline.request_work(self.driver.frame_inputs(inp),
                                             roofline.covered_pixels(frames, clear))
                self.least_ms += roofline.bound_of(*work)["bound_ms"]
        self.kept = []


def _device_info(torch, devices, chips: int) -> dict:
    """The run's devices; the memory peak is the fullest card's."""
    cards = [torch.device(d) for d in devices if str(d).startswith("cuda")]
    if cards:
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(cards[0]),
                "count": chips,
                "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(d))
                                         for d in cards)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def main(argv=None, root: Path = ROOT, device: str | None = None,
         started: float = STARTED) -> int:
    """Run the cell on one CUDA device per chip it asks for; ``device``
    "cpu" skips the look for a card and runs on the CPU (the benchmark's
    CPU tests)."""
    args = _args(argv)
    root = Path(root)
    try:
        bench = spec.benchmark(root)
        cell = spec.cell(bench, args.workload)
        config = spec.config(root, bench, cell["config"])
        mix = spec.traffic(root, cell["traffic"])
        limits = spec.limits(root, cell["name"])
    except (KeyError, OSError) as err:
        print(f"vfbench: {err}", file=sys.stderr)
        return 2
    cache_dirs(root)
    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"vfbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                  "visible", file=sys.stderr)
            return 2
        devices = [f"cuda:{i}" for i in range(cell["chips"])]
    else:
        devices = [device]
    on_card = devices[0].startswith("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    span = torch.profiler.record_function if args.trace else None
    driver = generator.build(config, mix, args.seed, devices, span)
    driver.setup()
    for k in range(mix["warmup_calls"]):
        driver.call(driver.inputs(k, stream=1))
    if on_card:
        for d in devices:
            torch.cuda.synchronize(d)
    tracing = None
    if args.trace:
        import vulkan_forge_torch
        csrc = Path(vulkan_forge_torch.__file__).parent / "csrc"
        tracing = Tracing(mix["trace_calls"], driver, trace.port_kernel_names(csrc),
                          len(devices))

    sample = check.Sample(mix["check_calls"], args.seed)
    latencies, pixels, failed, k = [], 0, 0, 0
    t_start = time.perf_counter()
    setup_s = t_start - started
    deadline, t_end = t_start + args.seconds, t_start
    while t_end < deadline or (tracing and tracing.session is not None):
        inp = driver.inputs(k)
        if tracing:
            tracing.before_call()
        t0 = time.perf_counter()
        try:
            frames = driver.call(inp)
        except Exception:  # a failed call is counted and the client goes on
            if not failed:
                traceback.print_exc()
            failed, frames = failed + 1, None
        t_end = time.perf_counter()
        latencies.append(t_end - t0)
        if frames is not None:
            pixels += int(math.prod(frames.shape[:3]))
            sample.offer(inp, frames)
        if tracing:
            tracing.after_call(inp, frames)
        k += 1
    window_s = t_end - t_start

    info = _device_info(torch, devices, cell["chips"])
    driver.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.compare((frames, driver.reference(inp, driver.device))
                            for inp, frames in sample.kept)
    correct, checks = check.judge(numbers, limits, failed)
    correct = correct and bool(sample.kept)

    result = {"correct": correct, "attempted": k, "failed": failed}
    if args.trace:
        metrics, breakdown = {}, None
        if tracing.summary is None:
            print("vfbench: no complete trace, so no per-layer metric: "
                  + "; ".join(tracing.why), file=sys.stderr)
        else:
            s = tracing.summary
            reading = {"summary": s, "least_ms": tracing.least_ms}
            for m in spec.metrics_of(bench, "per_layer", cell["name"]):
                value = spec.reader(m["name"])(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            info.update(busy_s=s.busy_s, window_s=s.window_s)
            breakdown = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
        result.update(metrics=metrics, device=info)
        if breakdown:
            result["breakdown"] = breakdown
    else:
        values = {"throughput_mpix_s": pixels / window_s / 1e6,
                  "call_p50_ms": statistics.median(latencies) * 1e3,
                  "call_p95_ms": percentile(latencies, 95) * 1e3,
                  "setup_s": setup_s}
        result.update(metrics={m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                               for m in spec.metrics_of(bench, "end_to_end", cell["name"])},
                      device=info)
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"vfbench: this process loaded {', '.join(found)}; the benchmark runs "
              "the port alone", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
