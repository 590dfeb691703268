"""Mesh rasterization into top-K fragments (PyTorch counterpart of
``torch_renderer_tpu.rasterize.raster``).

Two passes, as in the JAX package:

  1. SELECTION (not differentiable): the K nearest faces that cover each
     pixel. Binned settings (bin_size > 0) run the CUDA kernels of
     rasterize/cuda_hard.py for every K (their plain PyTorch versions on a
     CPU tensor); bin_size 0 runs the dense selection below in plain torch,
     which is XLA, not Pallas, in the JAX package.
  2. INTERPOLATION (differentiable): the winners' corner channels are
     gathered by face id and geometry.fragment_math recomputes
     barycentrics, z and signed distances, so gradients reach the vertices
     through this pass only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..cameras.perspective import PerspectiveCamera
from ..structures.meshes import Meshes
from .fragments import EMPTY_DIST, Fragments
from .geometry import (
    FaceRasterData,
    fragment_math,
    point_to_edges_dist2,
    setup_face_planes,
    setup_faces,
)
from .soft import pixel_coords_raster

INF = 3.0e38


@dataclasses.dataclass(frozen=True)
class RasterizationSettings:
    """Mirror of pytorch3d's RasterizationSettings, with every field of the
    JAX package's settings so a configuration carries across unchanged.

    blur_radius is a squared raster-space distance (faces within
    sqrt(blur_radius) of a pixel produce fragments); faces_per_pixel is K;
    pixel_chunk bounds the dense selection's working set.

    bin_size: None = auto (rasterize/autotune.py measures tile and budgets
    from the first concrete scene), 0 = dense selection, k > 0 = binned with
    tile k (any k, any faces_per_pixel) and the budgets max_faces_per_bin
    / active_tiles: faces beyond a tile's budget and non-empty tiles beyond
    active_tiles are dropped. Every binned call runs the CUDA kernels on a CUDA tensor,
    whatever ``impl`` says ("auto", "pallas" and "xla" are accepted), and
    ends with the untile kernel (rasterize/cuda_untile.py), one launch for
    all of its fragment fields, whatever ``untile_impl`` says (the JAX
    package's two epilogues give the same bits).

    occupancy_split (hi, lo) ranks the active tiles by descending
    candidate count and gives the first hi of them max_faces_per_bin slots
    and the rest lo, dropping what the JAX package's binned path drops
    (cuda_hard.binned_inputs); size it with
    binning.suggest_occupancy_split_fd.

    Accepted and without effect here: ``layout`` ("packed" is the JAX
    package's K=1 packed-selection kernel; the port routes it to the one K=1
    kernel), ``group_lanes``, ``select_impl="affine"`` (selection keys of
    the JAX XLA path) and ``untile_impl``. The combinations the JAX package
    rejects are rejected here too.

    check_budgets: None (the process default of
    binning.set_budget_check_default), "off", or "warn" (reads each true
    count back to the host once per call and warns on overflow).
    """

    image_size: Tuple[int, int]
    blur_radius: float = 0.0
    faces_per_pixel: int = 1
    znear: float = 1e-5
    pixel_chunk: int = 8192
    clip_barycentric_coords: Optional[bool] = None  # default: blur_radius > 0
    bin_size: Optional[int] = None
    max_faces_per_bin: int = 128
    impl: str = "auto"
    active_tiles: Optional[int] = None
    layout: str = "tile"
    group_lanes: Optional[int] = None
    occupancy_split: Optional[Tuple[int, int]] = None
    select_impl: str = "auto"
    untile_impl: str = "xla"
    check_budgets: Optional[str] = None

    @property
    def clip_bary(self) -> bool:
        if self.clip_barycentric_coords is None:
            return self.blur_radius > 0.0
        return self.clip_barycentric_coords


def _select_chunk(pix, fd: FaceRasterData, K: int, blur: float,
                  znear: float) -> torch.Tensor:
    """Top-K nearest covering faces of one pixel chunk: pix (P, 2) raster
    coords -> (B, P, K) face ids (-1 = empty), nearest first, ties in
    ascending face id."""
    pix_h = torch.cat([pix, torch.ones_like(pix[:, :1])], dim=-1)  # (P, 3)
    e = torch.einsum("pc,bfkc->bpfk", pix_h, fd.abc)              # (B,P,F,3)
    bary = e * (1.0 / fd.area2)[:, None, :, None]
    inside = (bary >= 0.0).all(-1)
    rb = torch.relu(bary)
    denom = (rb * fd.invz[:, None]).sum(-1).clamp_min(1e-12)
    zfrag = rb.sum(-1) / denom
    if blur > 0.0:
        d2 = point_to_edges_dist2(pix[None, :, None, :], fd.q[:, None])
        inside = inside | (d2 < blur)
    cover = inside & fd.valid[:, None] & (zfrag > znear)
    priority = torch.where(cover, zfrag, torch.full_like(zfrag, INF))
    k_eff = min(K, priority.shape[-1])
    z, idx = torch.sort(priority, dim=-1, stable=True)
    z, idx = z[..., :k_eff], idx[..., :k_eff]
    out = torch.where(z < INF, idx, torch.full_like(idx, -1))
    if k_eff < K:
        out = torch.nn.functional.pad(out, (0, K - k_eff), value=-1)
    return out


def _interpolate(pix_all, fd: FaceRasterData, pix_to_face,
                 clip_bary: bool) -> Fragments:
    """Differentiable bary / z / dists of the selected faces: pix_all
    (HW, 2), pix_to_face (B, HW, K) -> flat Fragments (B, HW, K, ...)."""
    B, HW, K = pix_to_face.shape
    idx = pix_to_face.clamp_min(0).reshape(B, HW * K)

    def g(plane):                                            # (B, F) -> (B, HW*K)
        return plane.gather(1, idx)

    qx = [g(fd.q[:, :, k, 0]) for k in range(3)]
    qy = [g(fd.q[:, :, k, 1]) for k in range(3)]
    zf = [g(fd.z[:, :, k]) for k in range(3)]
    invzf = [g(fd.invz[:, :, k]) for k in range(3)]
    px = pix_all[None, :, None, 0].expand(B, HW, K).reshape(B, HW * K)
    py = pix_all[None, :, None, 1].expand(B, HW, K).reshape(B, HW * K)
    zbuf, pc, dists = fragment_math(px, py, qx, qy, zf, invzf, clip_bary)

    live = pix_to_face >= 0
    shape = lambda a: a.reshape(B, HW, K)                    # noqa: E731
    return Fragments(
        pix_to_face=pix_to_face,
        zbuf=torch.where(live, shape(zbuf), -1.0),
        bary=torch.where(live[..., None],
                         torch.stack([shape(b) for b in pc], dim=-1), 0.0),
        dists=torch.where(live, shape(dists), EMPTY_DIST),
    )


def _check_settings(settings: RasterizationSettings) -> None:
    """The setting combinations the JAX package refuses."""
    K = settings.faces_per_pixel
    if settings.layout not in ("tile", "packed"):
        raise ValueError(f"unknown layout {settings.layout!r}")
    if settings.layout == "packed":
        if not settings.bin_size:
            raise ValueError("layout='packed' requires bin_size (binned path)")
        if settings.impl != "xla" and K != 1:
            raise ValueError(
                f"layout='packed' supports faces_per_pixel=1 only; got {K}")
        if settings.impl != "xla" and settings.active_tiles is None:
            raise ValueError("layout='packed' requires active_tiles")
    if settings.occupancy_split is not None:
        if (not settings.bin_size or settings.impl == "pallas"
                or settings.layout == "packed"):
            raise ValueError(
                "occupancy_split applies to the XLA binned path only; got "
                f"bin_size={settings.bin_size}, impl={settings.impl!r}, "
                f"layout={settings.layout!r}")
        if settings.active_tiles is None:
            raise ValueError("occupancy_split requires active_tiles")
    if settings.select_impl == "affine":
        if (K != 1 or settings.blur_radius > 0.0 or not settings.bin_size
                or settings.impl == "pallas" or settings.layout == "packed"):
            raise ValueError(
                "select_impl='affine' requires the XLA binned path with "
                "faces_per_pixel=1 and blur_radius=0")
    elif settings.select_impl != "auto":
        raise ValueError(f"unknown select_impl {settings.select_impl!r} "
                         "(expected 'auto' or 'affine')")


def rasterize_face_data(fd, settings: RasterizationSettings) -> Fragments:
    """Rasterize pre-projected faces (FaceRasterData, or FacePlanes on a
    binned path) into per-pixel top-K Fragments (B, H, W, K, ...)."""
    from .autotune import resolve_mesh_settings

    settings = resolve_mesh_settings(settings, fd=fd)
    _check_settings(settings)
    if settings.bin_size:
        from .cuda_hard import rasterize_binned_cuda

        return rasterize_binned_cuda(fd, settings)

    H, W = settings.image_size
    K = settings.faces_per_pixel
    pix_all = pixel_coords_raster((H, W), fd.q.device)     # (HW, 2)
    with torch.no_grad():
        sel = [_select_chunk(pix_all[p0:p0 + settings.pixel_chunk], fd, K,
                             settings.blur_radius, settings.znear)
               for p0 in range(0, H * W, settings.pixel_chunk)]
    frags = _interpolate(pix_all, fd, torch.cat(sel, dim=1),
                         settings.clip_bary)
    shape = lambda a: a.reshape((a.shape[0], H, W) + a.shape[2:])  # noqa: E731
    return Fragments(pix_to_face=shape(frags.pix_to_face),
                     zbuf=shape(frags.zbuf), bary=shape(frags.bary),
                     dists=shape(frags.dists))


def rasterize_meshes(meshes: Meshes, camera: PerspectiveCamera,
                     settings: RasterizationSettings) -> Fragments:
    """End to end: meshes + camera -> Fragments (the MeshRasterizer call).
    The binned path reads per-face channel planes, the dense path the
    corner tensors and edge coefficients."""
    from .autotune import resolve_mesh_settings

    settings = resolve_mesh_settings(settings, meshes, camera)
    setup = setup_face_planes if settings.bin_size else setup_faces
    fd = setup(meshes, camera, znear=settings.znear)
    return rasterize_face_data(fd, settings)
