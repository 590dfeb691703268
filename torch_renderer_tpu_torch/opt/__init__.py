"""The fitting loops (counterpart of ``torch_renderer_tpu.opt``): the pose
fits, the finite-difference pose fit, the deformation and vertex-color
fits, the joint shape + texture fit, ICP registration, the GMM pose
search and the two-phase creator."""

from .deform import (
    ColorFitConfig,
    DeformConfig,
    MeshDeformer,
    VertexColorFitter,
)
from .pose_search import (
    GMMPoseSearch,
    PoseSearchConfig,
    chamfer_loss_landscape,
    chamfer_scores,
    pose_errors,
    poses6d_to_Rt,
)
from .registration import (
    RegisterDataConfig,
    create_register_data,
    evaluate_registration,
    icp_cpu_reference,
    register_batch,
)
from .creator import CreatorConfig, TwoPhaseCreator
from .pose_fit_fd import (
    FDPoseFitConfig,
    FiniteDifferencePoseFitter,
    finite_difference_grad,
)
from .pose_fit import (
    CameraPoseFitter,
    DepthPoseFitter,
    PoseFitConfig,
    huber_loss,
    iou,
    patch_occlusion,
    pose_params_from_Rt,
    pose_params_to_Rt,
)
