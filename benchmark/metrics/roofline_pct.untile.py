"""Share of its roofline that ``untile_kernel``
(``csrc/untile.cu``) reaches in the traced window: the least time the
card could take for the traced steps' work (``work/untile.py``,
counted from the scene, by the data-sheet peaks) over the kernel's device
time, by torch.profiler. None where the kernel did not run."""


def read(reading):
    return reading.roofline_pct("untile_kernel", "untile")
