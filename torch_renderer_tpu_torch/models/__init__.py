"""Model families, the analysis-by-synthesis workloads (counterpart of
``torch_renderer_tpu.models``).

In the reference the "models" are nn.Modules whose forward returns a
scalar loss driving an optimizer (camera_pose_optimizer.py:205-276,
pose_optimizer.py:119-151, deform_mesh_from_pcd.py:131-250,
mesh_deformer.py:62-381, deform_mesh_with_color.py:259-478,
pytorch3d_icp_evaluation.py:117-341). Here each is a fitter class in
../opt whose loop runs as captured CUDA graph replays on the card; they
are re-exported here as the package's model registry.
"""

from ..opt.deform import ColorFitConfig, DeformConfig, MeshDeformer, VertexColorFitter
from ..opt.deform_color import JointFitConfig, JointShapeTextureFitter
from ..opt.pose_fit import CameraPoseFitter, DepthPoseFitter, PoseFitConfig
from ..opt.pose_search import GMMPoseSearch, PoseSearchConfig
from ..opt.registration import RegisterDataConfig, register_batch

MODEL_FAMILIES = {
    "camera_pose": CameraPoseFitter,        # camera_pose_optimizer.py
    "depth_pose": DepthPoseFitter,          # pose_optimizer.py / myrenderer.py
    "deform": MeshDeformer,                 # deform_mesh_from_pcd.py
    "vertex_color": VertexColorFitter,      # mesh_deformer.py color_train
    "joint_shape_texture": JointShapeTextureFitter,  # deform_mesh_with_color.py
    "pose_search": GMMPoseSearch,           # pytorch3d_icp_evaluation.py
}
