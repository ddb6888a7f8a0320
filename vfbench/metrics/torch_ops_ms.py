"""torch_ops_ms: device ms per call of every device op that is neither a
host <-> device copy nor one of the port's own CUDA kernels: the pipeline's
torch stages (the vertex stage, the extended shader, packing, fills)."""


def read(reading):
    s = reading["summary"]
    return s.class_s["torch"] / s.calls * 1e3 if s.calls else None
