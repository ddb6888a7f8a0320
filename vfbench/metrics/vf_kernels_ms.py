"""vf_kernels_ms: device ms per call of the port's own CUDA kernels, those
the sources under ``vulkan_forge_torch/csrc`` declare (the raster kernels
behind the ``vf_*`` entry points of ``_raster/kernels.py``)."""


def read(reading):
    s = reading["summary"]
    return s.class_s["port"] / s.calls * 1e3 if s.calls and s.port_launches else None
