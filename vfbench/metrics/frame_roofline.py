"""frame_roofline: the frames' least time (``roofline.request_work`` and
``bound_of`` over the traced calls) as a share of the device's busy time
in the traced window."""


def read(reading):
    s = reading["summary"]
    return 100.0 * reading["least_ms"] / (s.busy_s * 1e3) if s.busy_s > 0 else None
