"""Share of its roofline that ``hard_k1_kernel``
(``csrc/hard_raster.cu``) reaches in the traced window: the least time the
card could take for the traced steps' work (``work/hard_k1.py``,
counted from the scene, by the data-sheet peaks) over the kernel's device
time, by torch.profiler. None where the kernel did not run."""


def read(reading):
    return reading.roofline_pct("hard_k1_kernel", "hard_k1")
