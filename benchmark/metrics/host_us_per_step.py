"""Host microseconds a step spends in its issuing call (the replay, the
static input copies, the output copy), the mean over the measured window,
by the host clock around each call."""


def read(reading):
    if not reading.host_s:
        return None
    return 1e6 * sum(reading.host_s) / len(reading.host_s)
