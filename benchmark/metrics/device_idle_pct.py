"""Share of the traced window in which no operation ran on the card: the
window by the profiler's own clock, from the end of its opening markers to
the end of the last device operation, less the union of the profiler's
device spans in it. A union longer than the window is a fault of the
trace, and fails the run rather than reading 0."""


def read(reading):
    if not reading.device:
        return None
    if reading.busy_s > reading.window_s:
        raise ValueError(f"busy {reading.busy_s!r} s over a traced window "
                         f"of {reading.window_s!r} s")
    return 100.0 * (1.0 - reading.busy_s / reading.window_s)
