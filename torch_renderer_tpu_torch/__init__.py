"""torch_renderer_tpu_torch: the PyTorch + CUDA port of torch_renderer_tpu.

Five slices are ported:

  * the soft-silhouette render + backward: padded meshes, the pinhole
    camera, face setup, active-tile binning (in raster or count order), the
    soft-coverage CUDA kernel pair with the packed layout's occupancy
    split, the public entry soft_silhouette and the benchmark of the
    render + backward step (bench.py);
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
    renderers (alpha, norm, Pulsar splat, Pulsar sphere, depth);
  * the batched multi-view depth render (apps/batch_render_bench.py): the
    tile-gather kernel pair that loads every binned path's candidate slabs,
    the fused untile kernel that ends every binned mesh raster, and the
    timing harness (utils.timing).

Entry points that build tensors from host data put them on the card unless
given device="cpu" (``_device.resolve_device``). The CUDA kernels are built
on first use, never at import. The JAX package ``torch_renderer_tpu`` stays
the reference; this package does not import it or JAX.
"""

from .cameras.look_at import (
    camera_position_from_spherical_angles,
    look_at_opencv,
    look_at_rotation_opencv,
    look_at_view_transform,
)
from .cameras.perspective import (
    PerspectiveCamera,
    pose_opencv_to_pytorch3d,
    pose_pytorch3d_to_opencv,
)
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
from .rasterize.cuda_gather import gather_tiles
from .rasterize.cuda_soft import (
    SoftKernelConfig,
    soft_silhouette_cuda,
    soft_silhouette_fd,
    suggest_soft_config,
)
from .rasterize.cuda_untile import tile_slot_table, untile_scatter
from .rasterize.fragments import Fragments, interpolate_face_attributes
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
from .rasterize.soft import soft_silhouette, soft_silhouette_streaming
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
from .shading.blending import BlendParams, sigmoid_alpha, softmax_rgb_blend
from .shading.lights import DirectionalLights, Materials, PointLights
from .structures.meshes import Meshes
from .structures.pointclouds import Pointclouds
from .structures.textures import (
    TexturesUV,
    TexturesVertex,
    sphere_uv_mapping,
)
from .utils.timing import StageTimer, TimingResult, profiler_trace, time_fn

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
    "StageTimer",
    "TexturesUV",
    "TexturesVertex",
    "TimingResult",
    "VertexColorFitter",
    "build_topology",
    "camera_position_from_spherical_angles",
    "chamfer_distance",
    "gather_tiles",
    "icosphere",
    "interpolate_face_attributes",
    "knn_points",
    "load_obj",
    "load_objs_as_meshes",
    "look_at_opencv",
    "look_at_rotation_opencv",
    "look_at_view_transform",
    "mesh_edge_loss",
    "mesh_laplacian_smoothing",
    "mesh_normal_consistency",
    "pose_opencv_to_pytorch3d",
    "pose_params_from_Rt",
    "pose_params_to_Rt",
    "pose_pytorch3d_to_opencv",
    "profiler_trace",
    "rasterize_face_data",
    "rasterize_meshes",
    "rasterize_points",
    "sample_points_from_meshes",
    "save_obj",
    "setup_face_planes",
    "setup_faces",
    "sigmoid_alpha",
    "soft_silhouette",
    "soft_silhouette_cuda",
    "soft_silhouette_fd",
    "soft_silhouette_streaming",
    "softmax_rgb_blend",
    "sphere_uv_mapping",
    "suggest_soft_config",
    "tile_slot_table",
    "time_fn",
    "untile_scatter",
]
