"""torch_renderer_tpu_torch: the PyTorch + CUDA port of torch_renderer_tpu.

Two slices are ported:

  * the soft-silhouette render + backward: padded meshes, the pinhole
    camera, face setup, active-tile binning and the soft-coverage CUDA
    kernel pair;
  * the camera pose fit: look-at poses and quaternions, the top-K mesh
    rasterizer (the K=1 and top-K hard-raster CUDA kernels for binned
    settings, plain torch for dense ones), Phong shading and blending, the
    mesh renderers and the pose fitters.

The CUDA kernels are built on first use, never at import. The JAX package
``torch_renderer_tpu`` stays the reference; this package does not import it
or JAX.
"""

from .cameras.look_at import look_at_view_transform
from .cameras.perspective import PerspectiveCamera
from .ops.icosphere import icosphere
from .opt.pose_fit import (
    CameraPoseFitter,
    DepthPoseFitter,
    ObjectPoseFitter,
    PoseFitConfig,
    pose_params_from_Rt,
    pose_params_to_Rt,
)
from .rasterize.cuda_soft import (
    SoftKernelConfig,
    soft_silhouette_cuda,
    soft_silhouette_fd,
    suggest_soft_config,
)
from .rasterize.fragments import Fragments
from .rasterize.geometry import (
    FacePlanes,
    FaceRasterData,
    setup_face_planes,
    setup_faces,
)
from .rasterize.raster import (
    RasterizationSettings,
    rasterize_face_data,
    rasterize_meshes,
)
from .rasterize.soft import soft_silhouette_streaming
from .renderer import (
    ColorRender,
    DepthRender,
    MeshRenderer,
    RenderOutputs,
    SilhouetteRender,
)
from .shading.blending import BlendParams
from .shading.lights import DirectionalLights, Materials, PointLights
from .structures.meshes import Meshes

__all__ = [
    "BlendParams",
    "CameraPoseFitter",
    "ColorRender",
    "DepthPoseFitter",
    "DepthRender",
    "DirectionalLights",
    "FacePlanes",
    "FaceRasterData",
    "Fragments",
    "Materials",
    "MeshRenderer",
    "Meshes",
    "ObjectPoseFitter",
    "PerspectiveCamera",
    "PointLights",
    "PoseFitConfig",
    "RasterizationSettings",
    "RenderOutputs",
    "SilhouetteRender",
    "SoftKernelConfig",
    "icosphere",
    "look_at_view_transform",
    "pose_params_from_Rt",
    "pose_params_to_Rt",
    "rasterize_face_data",
    "rasterize_meshes",
    "setup_face_planes",
    "setup_faces",
    "soft_silhouette_cuda",
    "soft_silhouette_fd",
    "soft_silhouette_streaming",
    "suggest_soft_config",
]
