"""torch_renderer_tpu_torch: the PyTorch + CUDA port of torch_renderer_tpu.

This slice carries the soft-silhouette render + backward path: padded
meshes, the pinhole camera, face setup, active-tile binning and the
hand-written CUDA coverage kernels (built on first use, never at import).
The JAX package ``torch_renderer_tpu`` stays the reference; this package
does not import it or JAX.
"""

from .cameras.perspective import PerspectiveCamera
from .ops.icosphere import icosphere
from .rasterize.cuda_soft import (
    SoftKernelConfig,
    soft_silhouette_cuda,
    soft_silhouette_fd,
    suggest_soft_config,
)
from .rasterize.geometry import FacePlanes, setup_face_planes
from .rasterize.soft import soft_silhouette_streaming
from .structures.meshes import Meshes

__all__ = [
    "FacePlanes",
    "Meshes",
    "PerspectiveCamera",
    "SoftKernelConfig",
    "icosphere",
    "setup_face_planes",
    "soft_silhouette_cuda",
    "soft_silhouette_fd",
    "soft_silhouette_streaming",
    "suggest_soft_config",
]
