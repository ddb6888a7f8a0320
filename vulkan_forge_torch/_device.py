"""Device resolution, discovery and probing for the PyTorch port.

Every entry point takes an explicit ``device=`` argument; ``resolve_device``
turns ``None``/``"cuda"``/``"cpu"`` (or a ``torch.device``) into a
``torch.device`` and ``device_info`` reports what the card is.

``enumerate_adapters`` and ``device_probe`` are the port of
``vulkan_forge/_device.py:54-232``: the reference's backend matrix (TPU,
CPU, AUTO) becomes CUDA, CPU and AUTO, where AUTO means the port's default
device, the card. The adapter dicts keep the reference's keys, the probe its
status taxonomy {ok, unsupported, error} and ``millis``. The first CUDA touch
(CUDA init, device count, properties) and the probe computation run on a
daemon thread under a deadline (``VF_PROBE_TIMEOUT``, seconds; 0 disables
it), so that a wedged CUDA runtime gives an honest "timed out", not a hang.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

_KNOWN_BACKENDS = ("CUDA", "CPU", "AUTO")
# Graphics backends of the reference CLI surface, and the JAX package's
# TPU: reported as unsupported.
_LEGACY_BACKENDS = ("VULKAN", "DX12", "METAL", "GL", "TPU")
_PROBE_TIMEOUT_S = float(os.environ.get("VF_PROBE_TIMEOUT", "120"))
# NVIDIA's PCI vendor id; CPUs carry 0 like the reference's software adapters.
NVIDIA_VENDOR_ID = 0x10DE
# The framebuffer guardrail _validate.py enforces (the analog of wgpu's
# max_texture_dimension_2d in the reference's limit dump).
_FRAMEBUFFER_LIMIT = "max_framebuffer_dim=8192"
_NO_DEVICE = "No suitable accelerator device"


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; the CPU is taken only when asked for.

    ``None`` or ``"cuda"`` without a card raises: nothing falls back.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; expected 'cpu' or 'cuda'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return dev


def device_info(device=None) -> Dict[str, Any]:
    """Name, compute capability and library versions of ``device``."""
    dev = resolve_device(device)
    info: Dict[str, Any] = {
        "device": str(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        info["name"] = torch.cuda.get_device_name(index)
        info["capability"] = tuple(torch.cuda.get_device_capability(index))
        info["count"] = torch.cuda.device_count()
    else:
        info["name"] = "cpu"
        info["capability"] = None
        info["count"] = 0
    return info


def _with_deadline(fn: Callable[[], Any], timeout_s: float):
    """Run fn() on a daemon thread; (ok, value_or_exc, timed_out).

    Never raises: exceptions come back as (False, exc, False), with the
    watchdog and without it (timeout_s <= 0).
    """
    if not timeout_s or timeout_s <= 0:
        try:
            return True, fn(), False
        except Exception as e:
            return False, e, False
    q: "queue.Queue" = queue.Queue(maxsize=1)

    def run():
        try:
            q.put((True, fn()))
        except Exception as e:
            q.put((False, e))

    threading.Thread(target=run, daemon=True).start()
    try:
        ok, val = q.get(timeout=timeout_s)
        return ok, val, False
    except queue.Empty:
        return False, None, True


def _cuda_devices() -> List[Any]:
    """The visible CUDA devices' properties, in index order: the first CUDA
    touch, which the callers run under the deadline."""
    if not torch.cuda.is_available():
        return []
    return [torch.cuda.get_device_properties(i) for i in range(torch.cuda.device_count())]


def _versions() -> List[str]:
    return [f"torch={torch.__version__}", f"cuda={torch.version.cuda}"]


def _cuda_dict(index: int, props) -> Dict[str, Any]:
    """Adapter dict of CUDA device ``index`` from its properties."""
    feats = ["platform=cuda", f"kind={props.name}",
             f"capability={props.major}.{props.minor}",
             f"sm_count={props.multi_processor_count}", *_versions()]
    limits = [f"total_memory={int(props.total_memory)}"]
    for attr in ("L2_cache_size", "max_threads_per_multi_processor"):
        v = getattr(props, attr, None)
        if v is not None:
            limits.append(f"{attr}={int(v)}")
    limits.append(_FRAMEBUFFER_LIMIT)
    return {"name": str(props.name), "backend": "CUDA", "device_type": "DiscreteGpu",
            "vendor_id": NVIDIA_VENDOR_ID, "device_id": int(index),
            "features": ", ".join(feats), "limits": ", ".join(limits)}


def _cpu_dict() -> Dict[str, Any]:
    """Adapter dict of the CPU, where the plain versions run."""
    feats = ["platform=cpu", "kind=cpu", f"threads={torch.get_num_threads()}", *_versions()]
    return {"name": "cpu", "backend": "CPU", "device_type": "Cpu", "vendor_id": 0,
            "device_id": 0, "features": ", ".join(feats), "limits": _FRAMEBUFFER_LIMIT}


def enumerate_adapters() -> List[Dict[str, Any]]:
    """Every visible CUDA device, then the CPU, as adapter dicts (parity:
    ``vulkan_forge/_device.py:141-147``). Never raises: a discovery that
    fails or outlasts the deadline gives []."""
    ok, val, timed_out = _with_deadline(_cuda_devices, _PROBE_TIMEOUT_S)
    if timed_out or not ok:
        return []
    return [_cuda_dict(i, p) for i, p in enumerate(val)] + [_cpu_dict()]


def device_probe(backend: Optional[str] = None) -> Dict[str, Any]:
    """Probe a backend; returns status in {ok, unsupported, error} + millis.

    Parity with ``vulkan_forge/_device.py:150-232``: no backend means AUTO
    (here the card), a missing device is "unsupported", a failure or a
    timeout is "error". The probe computation is the reference's: the sum
    of ``arange(8)`` on the device must be 28.
    """
    b = (backend or "AUTO").upper()
    out: Dict[str, Any] = {"backend_request": b}
    t0 = time.perf_counter()

    def done(status: str, message: Optional[str] = None) -> Dict[str, Any]:
        out["status"] = status
        if message is not None:
            out["message"] = message
        out["millis"] = (time.perf_counter() - t0) * 1000.0
        return out

    if b in _LEGACY_BACKENDS:
        return done("unsupported", f"backend '{b}' not available on the PyTorch/CUDA "
                                   "build; use CUDA/CPU/AUTO")
    if b not in _KNOWN_BACKENDS:
        return done("unsupported", f"unknown backend '{b}'; use CUDA/CPU/AUTO")

    if b == "CPU":
        dev, info = torch.device("cpu"), _cpu_dict()
    else:
        ok, val, timed_out = _with_deadline(_cuda_devices, _PROBE_TIMEOUT_S)
        if timed_out:
            # The stuck thread may hold CUDA's init lock: touch CUDA no further.
            return done("error", f"device discovery timed out after "
                                 f"{_PROBE_TIMEOUT_S:.0f}s (wedged CUDA runtime?)")
        if not ok:
            return done("error", f"device probe failed: {val}")
        if not val:
            return done("unsupported", _NO_DEVICE)
        dev, info = torch.device("cuda", 0), _cuda_dict(0, val[0])
    out["adapter_name"] = info["name"]
    for key in ("backend", "device_type", "vendor_id", "device_id", "features", "limits"):
        out[key] = info[key]

    def compute() -> float:
        return float(torch.arange(8, dtype=torch.float32, device=dev).sum().item())

    ok, val, timed_out = _with_deadline(compute, _PROBE_TIMEOUT_S)
    if timed_out:
        return done("error", f"probe computation timed out after "
                             f"{_PROBE_TIMEOUT_S:.0f}s (wedged device?)")
    if not ok:
        return done("error", f"device probe failed: {val}")
    if val != 28.0:
        return done("error", f"probe computation returned {val}, expected 28.0")
    return done("ok")
