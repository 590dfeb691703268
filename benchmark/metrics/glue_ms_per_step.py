"""Device milliseconds a step spends in operations that are not the
program's own kernels (PyTorch's elementwise, reduction, copy and library
kernels: the glue around them), by torch.profiler. The program's own
kernels are every __global__ function of its CUDA sources and every
@triton.jit function, read from its sources at run time."""


def read(reading):
    if not reading.device:
        return None
    glue = [b - a for n, a, b in reading.device if not reading.is_own(n)]
    return sum(glue) / 1e3 / len(reading.steps)
