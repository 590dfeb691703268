"""torch_renderer_tpu_torch: the PyTorch + CUDA port of torch_renderer_tpu.

Four slices are ported:

  * the soft-silhouette render + backward: padded meshes, the pinhole
    camera, face setup, active-tile binning and the soft-coverage CUDA
    kernel pair;
  * the camera pose fit: look-at poses and quaternions, the top-K mesh
    rasterizer (the K=1 and top-K hard-raster CUDA kernels for binned
    settings, plain torch for dense ones), Phong shading and blending, the
    mesh renderers and the pose fitters;
  * shape fitting and texture: TexturesVertex / TexturesUV (the bilinear
    texture-sampling CUDA kernel pair), the mesh regularizers, surface
    sampling and the chamfer distance, the joint shape + UV-texture fit,
    the chamfer deformation and vertex-color fits, and OBJ / MTL / PNG IO;
  * the point stack: point clouds with features, point-splat
    rasterization (the point-selection CUDA kernel for binned settings,
    plain torch for dense ones), the compositors and the five point
    renderers (alpha, norm, Pulsar splat, Pulsar sphere, depth).

Entry points that build tensors from host data put them on the card unless
given device="cpu" (``_device.resolve_device``). The CUDA kernels are built
on first use, never at import. The JAX package ``torch_renderer_tpu`` stays
the reference; this package does not import it or JAX.
"""

from .cameras.look_at import look_at_view_transform
from .cameras.perspective import PerspectiveCamera
from .ops.icosphere import icosphere
from .io.obj import load_obj, load_objs_as_meshes, save_obj
from .ops.knn_chamfer import chamfer_distance, knn_points
from .ops.mesh_losses import (
    build_topology,
    mesh_edge_loss,
    mesh_laplacian_smoothing,
    mesh_normal_consistency,
)
from .ops.sample_points import sample_points_from_meshes
from .opt.deform import (
    ColorFitConfig,
    DeformConfig,
    MeshDeformer,
    VertexColorFitter,
)
from .opt.deform_color import JointFitConfig, JointShapeTextureFitter
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
from .rasterize.points import (
    PointFragments,
    PointsRasterizationSettings,
    rasterize_points,
)
from .rasterize.raster import (
    RasterizationSettings,
    rasterize_face_data,
    rasterize_meshes,
)
from .rasterize.soft import soft_silhouette_streaming
from .renderer import (
    AlphaPointRender,
    ColorRender,
    DepthPointRender,
    DepthRender,
    MeshRenderer,
    NormPointRender,
    PointsRenderer,
    PulsarPointRender,
    PulsarRenderer,
    RenderOutputs,
    SilhouetteRender,
)
from .shading.blending import BlendParams
from .shading.lights import DirectionalLights, Materials, PointLights
from .structures.meshes import Meshes
from .structures.pointclouds import Pointclouds
from .structures.textures import (
    TexturesUV,
    TexturesVertex,
    sphere_uv_mapping,
)

__all__ = [
    "AlphaPointRender",
    "BlendParams",
    "CameraPoseFitter",
    "ColorFitConfig",
    "ColorRender",
    "DeformConfig",
    "DepthPointRender",
    "DepthPoseFitter",
    "DepthRender",
    "DirectionalLights",
    "FacePlanes",
    "FaceRasterData",
    "Fragments",
    "JointFitConfig",
    "JointShapeTextureFitter",
    "Materials",
    "MeshDeformer",
    "MeshRenderer",
    "Meshes",
    "NormPointRender",
    "ObjectPoseFitter",
    "PerspectiveCamera",
    "PointFragments",
    "PointLights",
    "Pointclouds",
    "PointsRasterizationSettings",
    "PointsRenderer",
    "PoseFitConfig",
    "PulsarPointRender",
    "PulsarRenderer",
    "RasterizationSettings",
    "RenderOutputs",
    "SilhouetteRender",
    "SoftKernelConfig",
    "TexturesUV",
    "TexturesVertex",
    "VertexColorFitter",
    "build_topology",
    "chamfer_distance",
    "icosphere",
    "knn_points",
    "load_obj",
    "load_objs_as_meshes",
    "look_at_view_transform",
    "mesh_edge_loss",
    "mesh_laplacian_smoothing",
    "mesh_normal_consistency",
    "pose_params_from_Rt",
    "pose_params_to_Rt",
    "rasterize_face_data",
    "rasterize_meshes",
    "rasterize_points",
    "sample_points_from_meshes",
    "save_obj",
    "setup_face_planes",
    "setup_faces",
    "soft_silhouette_cuda",
    "soft_silhouette_fd",
    "soft_silhouette_streaming",
    "sphere_uv_mapping",
    "suggest_soft_config",
]
