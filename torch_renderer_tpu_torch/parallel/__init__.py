"""The multi-card layer (counterpart of ``torch_renderer_tpu.parallel``):
DeviceMesh construction and batch sharding (mesh), the sharded renders and
fits (sharded), and the launcher that starts one process per card
(launch)."""

from .launch import init_from_env, run_ranks
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_gather_batch,
    batch_spec,
    data_mesh,
    data_specs,
    make_mesh,
    pad_axis_to_multiple,
    pad_batch_to,
    replicate,
    shard_batch,
)
from .sharded import (
    data_parallel_fit,
    make_sharded_pose_step,
    render_points_sharded,
    sharded_silhouette_loss,
    soft_silhouette_sharded,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "all_gather_batch", "batch_spec",
           "data_mesh", "data_parallel_fit", "data_specs", "init_from_env",
           "make_mesh", "make_sharded_pose_step", "pad_axis_to_multiple",
           "pad_batch_to", "render_points_sharded", "replicate",
           "run_ranks", "shard_batch", "sharded_silhouette_loss",
           "soft_silhouette_sharded"]
