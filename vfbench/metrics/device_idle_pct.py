"""device_idle_pct: the share of the traced window, from the first call's
start to the last call's end, in which no kernel, copy or fill ran."""


def read(reading):
    s = reading["summary"]
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 else None
