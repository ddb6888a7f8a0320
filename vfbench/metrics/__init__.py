"""One reader per per-layer metric, found by the metric's name
(``spec.reader``). Each module's ``read(reading)`` takes the traced run's
reading, a dict with ``summary`` (``trace.Summary`` of a complete session)
and ``least_ms`` (the frame roofline's least time of the traced calls,
summed), and returns the metric's value, or None where it finds nothing
to read: the run then leaves the metric out.
"""
