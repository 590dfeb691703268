"""Share of its roofline that ``soft_coverage_bwd_kernel``
(``csrc/soft_coverage.cu``) reaches in the traced window: the least time the
card could take for the traced steps' work (``work/soft_coverage_bwd.py``,
counted from the scene, by the data-sheet peaks) over the kernel's device
time, by torch.profiler. None where the kernel did not run."""


def read(reading):
    return reading.roofline_pct("soft_coverage_bwd_kernel",
                                "soft_coverage_bwd")
