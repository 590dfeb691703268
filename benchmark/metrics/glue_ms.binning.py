"""Device milliseconds a step of operations that are not the program's own
kernels (the glue, as glue_ms_per_step counts it) in the program's
"binning" span, forward or "binning.bwd", self time (a child span's
operations are the child's), by torch.profiler over the spans window
(benchlib/spans.py)."""

from benchlib import spans


def read(reading):
    return spans.layer_glue_ms(reading, "binning")
