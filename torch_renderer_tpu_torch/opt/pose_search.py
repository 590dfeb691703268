"""Global pose search by chamfer-scored GMM cross-entropy (PyTorch
counterpart of ``torch_renderer_tpu.opt.pose_search``, the reference's
ICPTensorEvalutor, pytorch3d_icp_evaluation.py:117-341), and the chamfer
loss landscape of chamfer_loss_evaluation.py:77-201.

Pose hypotheses (a Gaussian translation about the target's centroid and a
uniform roll-pitch-yaw) are scored with one batched chamfer call; a
diagonal GMM is fitted to the elite set (ops/gmm.py) and resampled for
n_iters iterations. The reference goes to the host every iteration
(sklearn); here scoring, elite selection, the GMM fit and the resampling
stay on the device, and on the card each iteration is a replay of one
captured CUDA graph (utils/graph.StepGraph), the port's counterpart of the
JAX package's one jitted lax.scan. Every random draw of the search is made
from the caller's torch.Generator before the loop, and each iteration
reads its own from a step counter on the device, so the captured graph
holds no generator. ``search_batch`` searches B targets at once with the
batch written out (JAX vmaps the search).

The chamfer scores' dense (H, P, M) distance matrices are cut into chunks
of at most CHAMFER_CHUNK_ELEMS elements (one chunk at the apps' defaults
for one target).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .._device import draw, resolve_device
from ..ops.gmm import _gmm_em, _gmm_sample_from, _gumbel, _kmeanspp_centers
from ..ops.knn_chamfer import _mask_cols, square_distance_matrix
from ..transforms.so3 import (
    euler_angles_to_matrix,
    matrix_to_euler_angles,
    matrix_to_quaternion,
    quaternion_distance,
    transform_points,
)
from ..utils.graph import StepGraph

# the most elements of one chunk's distance matrix in chamfer_scores: 2^27
# (512 MiB of float32; the matrix's temporaries hold a few of them)
CHAMFER_CHUNK_ELEMS = 1 << 27

_ITEM_24 = ("needs the port's parallel/ (torch.distributed), ROADMAP Queue 1 "
            "item 24")


def poses6d_to_Rt(poses: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 6) [x y z roll pitch yaw] -> R (..., 3, 3), t (..., 3); the
    rpy in the intrinsic XYZ convention of the reference's
    euler_angles_to_matrix call (pytorch3d_icp_evaluation.py:188)."""
    return euler_angles_to_matrix(poses[..., 3:], "XYZ"), poses[..., :3]


def chamfer_scores(ref_points: torch.Tensor, target_points: torch.Tensor,
                   poses: torch.Tensor,
                   target_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Chamfer distance of ref (P, 3) moved by each pose against the
    target: poses (H, 6) and target (M, 3) give (H,); poses (G, H, 6) and
    targets (G, M, 3) (masks (G, M)) give (G, H). One batched call over
    the hypotheses, in chunks of at most CHAMFER_CHUNK_ELEMS distances."""
    batched = poses.ndim == 3
    if not batched:
        poses, target_points = poses[None], target_points[None]
        target_mask = None if target_mask is None else target_mask[None]
    G, H, _ = poses.shape
    P, M = ref_points.shape[0], target_points.shape[1]
    R, t = poses6d_to_Rt(poses.reshape(G * H, 6))
    moved = transform_points(R, t, ref_points.expand(G * H, P, 3))
    tgt = target_points[:, None].expand(G, H, M, 3).reshape(G * H, M, 3)
    tm = None if target_mask is None else \
        target_mask[:, None].expand(G, H, M).reshape(G * H, M)
    chunk = max(1, CHAMFER_CHUNK_ELEMS // (P * M))
    cham = torch.cat([
        _chamfer(moved[i:i + chunk], tgt[i:i + chunk],
                 None if tm is None else tm[i:i + chunk])
        for i in range(0, G * H, chunk)]).reshape(G, H)
    return cham if batched else cham[0]


def _chamfer(x, y, y_mask):
    """knn_chamfer.chamfer_distance(x, y, y_mask=y_mask, batch_reduction=
    None) from one (B, N, M) distance matrix, its minima taken along both
    axes (the y -> x matrix is its transpose: the same sums, added in the
    other order)."""
    d2 = square_distance_matrix(x, y)
    cham = _mask_cols(d2, y_mask).amin(-1).mean(-1)
    dy = d2.amin(-2)
    if y_mask is None:
        return cham + dy.mean(-1)
    return cham + (dy * y_mask).sum(-1) / y_mask.sum(-1).clamp_min(1.0)


def _elite(poses: torch.Tensor, scores: torch.Tensor, n_elite: int):
    """The n_elite lowest-scoring poses (G, E, 6) and their scores (G, E),
    ascending: JAX's lax.top_k(-scores)."""
    e_scores, idx = torch.topk(scores, n_elite, dim=-1, largest=False,
                               sorted=True)
    return poses.gather(-2, idx[..., None].expand(idx.shape + (6,))), \
        e_scores


@dataclasses.dataclass(frozen=True)
class PoseSearchConfig:
    """The reference's scale: 400 hypotheses, elite 100, 10 EM iterations
    (pytorch3d_icp_evaluation.py:171-239)."""

    n_hypotheses: int = 400
    n_elite: int = 100
    n_iters: int = 10
    n_components: int = 5
    translation_std: float = 0.1
    gmm_em_iters: int = 15
    reg_covar: float = 1e-6


class GMMPoseSearch:
    """Cross-entropy pose search over SE(3) as 6D xyz + rpy. ref_points
    (P, 3) go to ``device`` (default: their device when a tensor, else the
    card)."""

    def __init__(self, ref_points, config: PoseSearchConfig =
                 PoseSearchConfig(), device=None):
        device = resolve_device(device, like=ref_points)
        self.ref_points = torch.as_tensor(ref_points, dtype=torch.float32,
                                          device=device)
        self.config = config

    @property
    def device(self) -> torch.device:
        return self.ref_points.device

    def _draws(self, generator, G: int) -> Dict[str, torch.Tensor]:
        """Every random draw of G searches, made up front from generator:
        the initial translations' normals and rpy uniforms, and per
        iteration (leading axis) the k-means++ first rows and Gumbel
        uniforms, and the samples' component uniforms and normals."""
        cfg = self.config
        H, E, C, T = (cfg.n_hypotheses, cfg.n_elite, cfg.n_components,
                      cfg.n_iters)

        def rand(shape):
            return draw(torch.rand, generator, shape, self.device)

        def randn(shape):
            return draw(torch.randn, generator, shape, self.device)

        return {"trans": randn((G, H, 3)), "rpy": rand((G, H, 3)),
                "first": torch.randint(0, E, (T, G), generator=generator,
                                       device=generator.device
                                       ).to(self.device),
                "seed": rand((T, G, C - 1, E)), "comp": rand((T, G, H, C)),
                "offset": randn((T, G, H, 6))}

    def _run(self, generator, targets, masks, capture):
        """The search of G targets (G, M, 3) with masks (G, M); every
        output has a leading G."""
        cfg = self.config
        G = targets.shape[0]
        H, E, T = cfg.n_hypotheses, cfg.n_elite, cfg.n_iters
        ref, dev = self.ref_points, self.device
        draws = self._draws(generator, G)

        # initial hypotheses (reference :171-175) and their elite
        centroid = (targets * masks[..., None]).sum(1) \
            / masks.sum(-1).clamp_min(1.0)[:, None]
        trans = centroid[:, None] + cfg.translation_std * draws["trans"]
        rpy = draws["rpy"] * (2.0 * math.pi) - math.pi
        poses = torch.cat([trans, rpy], dim=-1)

        e_poses, e_scores = _elite(
            poses, chamfer_scores(ref, targets, poses, masks), E)
        best_pose = e_poses[:, 0].clone()
        best_score = e_scores[:, 0].clone()

        C = cfg.n_components
        hist = {"best_history": torch.zeros((T, G), device=dev),
                "elite_best_history": torch.zeros((T, G), device=dev),
                "iter_poses": torch.zeros((T, G, H, 6), device=dev),
                "iter_scores": torch.zeros((T, G, H), device=dev),
                "gmm_means": torch.zeros((T, G, C, 6), device=dev),
                "gmm_var": torch.zeros((T, G, C, 6), device=dev),
                "gmm_weights": torch.zeros((T, G, C), device=dev)}
        k = torch.zeros((1,), dtype=torch.int64, device=dev)

        def step():
            d = {n: v.index_select(0, k)[0] for n, v in draws.items()
                 if n not in ("trans", "rpy")}
            centers = _kmeanspp_centers(e_poses, C, d["first"],
                                        _gumbel(d["seed"]))
            gmm = _gmm_em(e_poses, centers, cfg.gmm_em_iters, cfg.reg_covar)
            poses = _gmm_sample_from(gmm, _gumbel(d["comp"]), d["offset"])
            scores = chamfer_scores(ref, targets, poses, masks)
            ep, es = _elite(poses, scores, E)
            improved = es[:, 0] < best_score
            best_pose.copy_(torch.where(improved[:, None], ep[:, 0],
                                        best_pose))
            best_score.copy_(torch.where(improved, es[:, 0], best_score))
            e_poses.copy_(ep)
            # the per-iteration population and fitted GMM: the reference's
            # scatter + ellipse plot of each EM iteration (:244-279)
            for name, val in (("best_history", best_score),
                              ("elite_best_history", es[:, 0]),
                              ("iter_poses", poses), ("iter_scores", scores),
                              ("gmm_means", gmm.means), ("gmm_var", gmm.var),
                              ("gmm_weights", gmm.weights)):
                hist[name].index_copy_(0, k, val[None])
            k.add_(1)

        run = StepGraph(step, dev, capture)
        for _ in range(T):
            run()
        run.release()
        R, t = poses6d_to_Rt(best_pose)
        return {"pose6d": best_pose, "R": R, "t": t, "score": best_score,
                "final_elite": e_poses,
                **{n: v.movedim(0, 1) for n, v in hist.items()}}

    @staticmethod
    def _mask(target_points, target_mask):
        if target_mask is None:
            return torch.ones(target_points.shape[:-1], dtype=torch.float32,
                              device=target_points.device)
        return torch.as_tensor(target_mask, dtype=torch.float32,
                               device=target_points.device)

    def search(self, generator: torch.Generator, target_points,
               target_mask=None, device_mesh=None,
               capture=None) -> Dict[str, torch.Tensor]:
        """The full search for target_points (M, 3), optional (M,) mask;
        draws from generator. capture (utils/graph.py): None replays one
        captured CUDA graph an iteration on the card and runs eagerly on
        the CPU. device_mesh (sharding the hypotheses over cards) raises
        NotImplementedError until ROADMAP Queue 1 item 24."""
        if device_mesh is not None:
            raise NotImplementedError(f"search(device_mesh=...) {_ITEM_24}")
        tp = torch.as_tensor(target_points, dtype=torch.float32,
                             device=self.device)
        out = self._run(generator, tp[None],
                        self._mask(tp, target_mask)[None], capture)
        return {n: v[0] for n, v in out.items()}

    def search_batch(self, generator: torch.Generator, target_points,
                     target_mask=None, device_mesh=None,
                     capture=None) -> Dict[str, torch.Tensor]:
        """B independent searches over targets (B, M, 3), optional (B, M)
        masks, at once; every output gains a leading B. device_mesh as in
        search."""
        if device_mesh is not None:
            raise NotImplementedError(
                f"search_batch(device_mesh=...) {_ITEM_24}")
        tp = torch.as_tensor(target_points, dtype=torch.float32,
                             device=self.device)
        return self._run(generator, tp, self._mask(tp, target_mask), capture)

    def _sharded_search_fn(self, device_mesh):
        """The search with its hypotheses sharded over cards: waits for
        ROADMAP Queue 1 item 24."""
        raise NotImplementedError(f"the sharded search {_ITEM_24}")


# ---------------------------------------------------------------------------
# Chamfer loss-landscape evaluation (chamfer_loss_evaluation.py)
# ---------------------------------------------------------------------------

def pose_errors(poses: torch.Tensor, gt_R: torch.Tensor, gt_t: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translation L2 and rotation angle (rad) of each 6D pose (H, 6)
    against the ground truth (the reference's metrics,
    chamfer_loss_evaluation.py:140-157)."""
    R, t = poses6d_to_Rt(poses)
    trans_err = torch.linalg.norm(t - gt_t, dim=-1)
    q = matrix_to_quaternion(R)
    rot_err = quaternion_distance(q, matrix_to_quaternion(gt_R).expand_as(q))
    return trans_err, rot_err


def chamfer_loss_landscape(generator: torch.Generator, ref_points,
                           gt_R: torch.Tensor, gt_t: torch.Tensor,
                           n_poses: int = 1000,
                           translation_std: float = 0.1,
                           rotation_std: float = 0.5,
                           target_points=None) -> Dict[str, torch.Tensor]:
    """n_poses perturbations of the ground-truth pose (Gaussian in xyz and
    rpy), each scored with chamfer: the (chamfer, translation error,
    rotation error) scatter of chamfer_loss_evaluation.py:105-157. Runs on
    gt_R's device; draws from generator."""
    dev = gt_R.device
    ref_points = torch.as_tensor(ref_points, dtype=torch.float32,
                                 device=dev)
    if target_points is None:
        target_points = transform_points(gt_R, gt_t, ref_points)

    gt_rpy = matrix_to_euler_angles(gt_R, "XYZ")
    trans = gt_t[None] + translation_std * draw(torch.randn, generator,
                                                (n_poses, 3), dev)
    rpy = gt_rpy[None] + rotation_std * draw(torch.randn, generator,
                                            (n_poses, 3), dev)
    poses = torch.cat([trans, rpy], dim=-1)
    cham = chamfer_scores(ref_points, target_points, poses)
    trans_err, rot_err = pose_errors(poses, gt_R, gt_t)
    return {"poses6d": poses, "chamfer": cham, "trans_err": trans_err,
            "rot_err": rot_err}
