"""copy_ms: device ms per call of host <-> device copies (memcpy HtoD and
DtoH in the trace): the public entries' uploads and the frames' readback."""


def read(reading):
    s = reading["summary"]
    return s.class_s["copy"] / s.calls * 1e3 if s.calls else None
