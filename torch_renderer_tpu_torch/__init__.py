"""torch_renderer_tpu_torch: the PyTorch + CUDA port of torch_renderer_tpu.

Seven slices are ported:

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
    timing harness (utils.timing);
  * registration and search: batched ICP (ops.icp, with the batched 3x3
    SVD CUDA kernel of ops.cuda_svd3) and its workload
    (opt.registration), the diagonal GMM (ops.gmm) and the chamfer-scored
    GMM pose search with its loss landscape (opt.pose_search), the
    finite-difference depth pose fit (opt.pose_fit_fd), the rest of
    transforms.so3, and the model registry (models.MODEL_FAMILIES);
  * data generation (apps/coco_data_generator.py): multi-object scenes
    (structures.scenes), the G-buffer decodes (shading.gbuffer), Canny
    edges (ops.canny), procedural textures (datagen.texgen), the rigid-body
    settle (datagen.physics), the COCO generator (datagen.coco), the native
    host runtime (io.native: OBJ parsing, RLE, PNG; built by g++ into
    build/native/), PLY IO, the color transfer and the two-phase creator.

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
from .datagen.coco import COCODataGenerator, DataGenConfig, ObjectLibrary
from .ops.icosphere import icosphere
from .io.obj import load_obj, load_objs_as_meshes, save_obj
from .io.ply import load_ply, save_ply
from .ops.canny import CannyOutputs, canny_edges
from .ops.color_transfer import query_vertex_colors
from .ops.icp import ICPSolution, SimilarityTransform, iterative_closest_point
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
from .opt.creator import CreatorConfig, TwoPhaseCreator
from .opt.pose_fit_fd import FDPoseFitConfig, FiniteDifferencePoseFitter
from .opt.pose_search import GMMPoseSearch, PoseSearchConfig
from .opt.registration import RegisterDataConfig, register_batch
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
from .shading.gbuffer import (
    instance_masks,
    instance_segmentation,
    render_normals,
    visibility_fraction,
)
from .shading.lights import DirectionalLights, Materials, PointLights
from .structures.meshes import Meshes
from .structures.pointclouds import Pointclouds
from .structures.scenes import SceneMeshes, merge_meshes
from .structures.textures import (
    TexturesUV,
    TexturesVertex,
    sphere_uv_mapping,
)
from .utils.timing import StageTimer, TimingResult, profiler_trace, time_fn

from . import datagen, io, models, opt  # noqa: E402,F401 namespaces

__all__ = [
    "AlphaPointRender",
    "BlendParams",
    "COCODataGenerator",
    "CameraPoseFitter",
    "CannyOutputs",
    "ColorFitConfig",
    "ColorRender",
    "CreatorConfig",
    "DataGenConfig",
    "DeformConfig",
    "DepthPointRender",
    "DepthPoseFitter",
    "DepthRender",
    "DirectionalLights",
    "FDPoseFitConfig",
    "FacePlanes",
    "FaceRasterData",
    "FiniteDifferencePoseFitter",
    "Fragments",
    "GMMPoseSearch",
    "ICPSolution",
    "JointFitConfig",
    "JointShapeTextureFitter",
    "Materials",
    "MeshDeformer",
    "MeshRenderer",
    "Meshes",
    "NormPointRender",
    "ObjectLibrary",
    "ObjectPoseFitter",
    "PerspectiveCamera",
    "PointFragments",
    "PointLights",
    "Pointclouds",
    "PointsRasterizationSettings",
    "PointsRenderer",
    "PoseFitConfig",
    "PoseSearchConfig",
    "PulsarPointRender",
    "PulsarRenderer",
    "RasterizationSettings",
    "RegisterDataConfig",
    "RenderOutputs",
    "SceneMeshes",
    "SilhouetteRender",
    "SimilarityTransform",
    "SoftKernelConfig",
    "StageTimer",
    "TexturesUV",
    "TexturesVertex",
    "TimingResult",
    "TwoPhaseCreator",
    "VertexColorFitter",
    "build_topology",
    "camera_position_from_spherical_angles",
    "canny_edges",
    "chamfer_distance",
    "gather_tiles",
    "icosphere",
    "instance_masks",
    "instance_segmentation",
    "interpolate_face_attributes",
    "iterative_closest_point",
    "knn_points",
    "load_obj",
    "load_objs_as_meshes",
    "load_ply",
    "look_at_opencv",
    "look_at_rotation_opencv",
    "look_at_view_transform",
    "merge_meshes",
    "mesh_edge_loss",
    "mesh_laplacian_smoothing",
    "mesh_normal_consistency",
    "pose_opencv_to_pytorch3d",
    "pose_params_from_Rt",
    "pose_params_to_Rt",
    "pose_pytorch3d_to_opencv",
    "profiler_trace",
    "query_vertex_colors",
    "rasterize_face_data",
    "rasterize_meshes",
    "rasterize_points",
    "register_batch",
    "render_normals",
    "sample_points_from_meshes",
    "save_obj",
    "save_ply",
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
    "visibility_fraction",
]
