"""Device milliseconds a step of operations that are not the program's own
kernels (the glue, as glue_ms_per_step counts it) in no layer span: the
loop's own work (the loss sum, the update, the restart), the autograd
engine's own nodes, the copies in and out of the step, self time (a child
span's operations are the child's), by torch.profiler over the spans
window (benchlib/spans.py)."""

from benchlib import spans


def read(reading):
    return spans.layer_glue_ms(reading, "outside")
