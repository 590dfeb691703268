"""Device operations (kernels, copies and fills) the traced window ran,
over its steps, by torch.profiler; the window's opening markers are left
out."""


def read(reading):
    if not reading.device:
        return None
    return len(reading.device) / len(reading.steps)
