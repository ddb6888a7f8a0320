"""Device discovery and probing of the port (``vulkan_forge_torch._device``)
against the contract of ``tests/test_device_probe.py``: the status taxonomy
{ok, unsupported, error} with ``millis``, the adapter dicts' keys, and the
watchdog that turns a hanging device touch into an honest "timed out".

The CUDA cases run without a card through a stand-in for the discovery
hook; the ``gpu`` cases need the card and skip here. No jax is imported.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

import vulkan_forge_torch as vt
from vulkan_forge_torch import _device

KEYS = {"name", "backend", "device_type", "vendor_id", "device_id", "features", "limits"}
H100 = SimpleNamespace(name="NVIDIA H100 80GB HBM3", major=9, minor=0,
                       multi_processor_count=132, total_memory=85_045_477_376,
                       L2_cache_size=52_428_800, max_threads_per_multi_processor=2048)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("backend", ["VULKAN", "DX12", "METAL", "GL", "TPU", "vulkan"])
def test_probe_legacy_backends_unsupported(backend):
    r = vt.device_probe(backend)
    assert r["status"] == "unsupported"
    assert r["backend_request"] == backend.upper()
    assert "millis" in r and "message" in r


def test_probe_unknown_backend_unsupported():
    r = vt.device_probe("BOGUS")
    assert r["status"] == "unsupported" and "unknown backend" in r["message"]


def test_probe_cpu_ok():
    r = vt.device_probe("CPU")
    assert r["status"] == "ok", r
    assert r["millis"] > 0
    assert r["device_type"] == "Cpu" and r["vendor_id"] == 0 and r["backend"] == "CPU"
    assert "max_framebuffer_dim=8192" in r["limits"]


@pytest.mark.parametrize("backend", [None, "AUTO", "CUDA", "cuda"])
def test_probe_without_card_unsupported(monkeypatch, backend):
    """AUTO means the card: without one it answers unsupported with the
    reference's message and does not probe the CPU instead."""
    monkeypatch.setattr(_device, "_cuda_devices", lambda: [])
    r = vt.device_probe(backend)
    assert r["status"] == "unsupported", r
    assert r["message"] == "No suitable accelerator device"
    assert "adapter_name" not in r and r["millis"] >= 0


def test_probe_discovery_error_is_error(monkeypatch):
    def boom():
        raise RuntimeError("CUDA initialization failed")
    monkeypatch.setattr(_device, "_cuda_devices", boom)
    r = vt.device_probe("CUDA")
    assert r["status"] == "error" and "CUDA initialization failed" in r["message"]
    assert vt.enumerate_adapters() == []


@pytest.mark.parametrize("backend", ["AUTO", "CUDA"])
def test_probe_times_out_instead_of_hanging(monkeypatch, backend):
    monkeypatch.setattr(_device, "_PROBE_TIMEOUT_S", 2.0)
    monkeypatch.setattr(_device, "_cuda_devices", lambda: time.sleep(3600))
    t0 = time.perf_counter()
    r = _device.device_probe(backend)
    took = time.perf_counter() - t0
    assert r["status"] == "error"
    assert "timed out" in r["message"]
    assert took < 10.0


def test_enumerate_adapters_times_out_empty(monkeypatch):
    monkeypatch.setattr(_device, "_PROBE_TIMEOUT_S", 2.0)
    monkeypatch.setattr(_device, "_cuda_devices", lambda: time.sleep(3600))
    t0 = time.perf_counter()
    assert _device.enumerate_adapters() == []
    assert time.perf_counter() - t0 < 10.0


def test_with_deadline_never_raises():
    def boom():
        raise ValueError("x")
    for timeout in (0, 5.0):
        ok, val, timed_out = _device._with_deadline(boom, timeout)
        assert not ok and isinstance(val, ValueError) and not timed_out
        assert _device._with_deadline(lambda: 7, timeout) == (True, 7, False)


def test_adapter_dicts_carry_real_capabilities():
    adapters = vt.enumerate_adapters()
    assert adapters, "the CPU adapter is always listed"
    for a in adapters:
        assert set(a) == KEYS
        assert a["name"] and a["name"] != "unknown"
        assert "platform=" in a["features"] and "kind=" in a["features"]
        assert f"torch={torch.__version__}" in a["features"]
        assert "max_framebuffer_dim=8192" in a["limits"]
    cpu = [a for a in adapters if a["backend"] == "CPU"]
    assert len(cpu) == 1 and cpu[0]["device_type"] == "Cpu" and cpu[0]["vendor_id"] == 0
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert len(adapters) == n_cuda + 1


def test_cuda_adapter_dicts_from_device_properties(monkeypatch):
    monkeypatch.setattr(_device, "_cuda_devices", lambda: [H100, H100])
    adapters = vt.enumerate_adapters()
    assert [a["backend"] for a in adapters] == ["CUDA", "CUDA", "CPU"]
    for i, a in enumerate(adapters[:2]):
        assert set(a) == KEYS
        assert a["name"] == H100.name and a["device_type"] == "DiscreteGpu"
        assert a["vendor_id"] == 0x10DE and a["device_id"] == i
        for feat in ("platform=cuda", f"kind={H100.name}", "capability=9.0",
                     "sm_count=132", f"torch={torch.__version__}", "cuda="):
            assert feat in a["features"]
        assert f"total_memory={H100.total_memory}" in a["limits"]
        assert a["limits"].endswith("max_framebuffer_dim=8192")


def test_shim_module_carries_the_probes():
    import vulkan_forge_torch._vulkan_forge as ext
    assert ext.device_probe is vt.device_probe
    assert ext.enumerate_adapters is vt.enumerate_adapters


@pytest.mark.gpu
@pytest.mark.parametrize("backend", [None, "AUTO", "CUDA"])
def test_probe_cuda_ok_on_card(cuda, backend):
    r = vt.device_probe(backend)
    assert r["status"] == "ok", r
    assert r["vendor_id"] == 0x10DE and r["device_type"] == "DiscreteGpu"
    assert r["adapter_name"] == torch.cuda.get_device_name(0)
    assert r["millis"] > 0


@pytest.mark.gpu
def test_enumerate_adapters_lists_every_card(cuda):
    adapters = vt.enumerate_adapters()
    cards = [a for a in adapters if a["backend"] == "CUDA"]
    assert len(cards) == torch.cuda.device_count()
    for i, a in enumerate(cards):
        props = torch.cuda.get_device_properties(i)
        assert a["device_id"] == i and a["vendor_id"] == 0x10DE
        assert f"total_memory={props.total_memory}" in a["limits"]
        assert "max_framebuffer_dim=8192" in a["limits"]
        assert f"capability={props.major}.{props.minor}" in a["features"]
