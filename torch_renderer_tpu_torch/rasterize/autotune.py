"""Automatic rasterization-settings resolution (PyTorch counterpart of
``torch_renderer_tpu.rasterize.autotune``, pytorch3d's bin_size contract):

  * ``bin_size=None`` -> auto: tile 16 and budgets (max_faces_per_bin or
    max_points_per_bin, and active_tiles) measured from the concrete scene
    with head-room, cached per (batch, faces or points, settings);
  * ``bin_size=0``    -> dense selection;
  * ``bin_size=k > 0`` -> explicit binned settings, untouched.

Measuring reads counts back to the host, so it happens once: at the first
call for a shape, or at set-up through ``MeshRenderer.prepare`` (the pose
fitters call it with grow=True and margin 2.0 before their loop) or
``PointsRenderer.prepare``. Later
calls on the same shape reuse the cached budgets and read nothing back.
Torch runs eagerly, so every call sees concrete tensors and the JAX
package's traced-call dense fallback does not exist here.

Auto budgets are heuristic, so auto mode defaults ``check_budgets`` to
"warn" unless the settings or the process default say otherwise; "off" is
the benching switch.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

AUTO_TILE = 16
# Images below this side, meshes of at most this many faces and clouds of at
# most this many points stay dense: the binning's fixed cost exceeds the
# small dense selection it replaces.
MIN_BINNED_IMAGE = 32
MIN_BINNED_FACES = 256
MIN_BINNED_POINTS = 1024
# Head-room on measured budgets (footprints move during fits; the pose
# fitters pass 2.0).
AUTO_MARGIN = 1.5

_CACHE: dict = {}


def clear_cache() -> None:
    """Drop every cached auto resolution."""
    _CACHE.clear()


def _settings_key(settings) -> tuple:
    return (type(settings).__name__,) + dataclasses.astuple(settings)


def _auto_guard(settings):
    """check_budgets for auto-resolved settings: an explicit value wins,
    then the process default, else "warn"."""
    if settings.check_budgets is not None:
        return settings.check_budgets
    from .binning import _BUDGET_CHECK_DEFAULT

    default = _BUDGET_CHECK_DEFAULT[0]
    return "warn" if default is None else default


def _dense(settings):
    if settings.impl == "pallas":
        warnings.warn(
            "impl='pallas' with bin_size=None: auto resolution chose the "
            "DENSE path for this scene (below the binning thresholds); the "
            "binned kernels do not apply. Pass an explicit bin_size to "
            "force binning.", RuntimeWarning, stacklevel=3)
        return dataclasses.replace(settings, bin_size=0, impl="auto")
    return dataclasses.replace(settings, bin_size=0)


def resolve_mesh_settings(settings, meshes=None, camera=None, fd=None,
                          grow: bool = False, margin=None):
    """Resolve ``bin_size=None`` into explicit binned (or dense) settings
    for this scene; explicit settings pass through. Give (meshes, camera)
    or a projected fd (FaceRasterData or FacePlanes). grow=True re-measures
    against a cached resolution and keeps the larger budgets; margin
    overrides AUTO_MARGIN."""
    if settings.bin_size is not None:
        return settings
    H, W = settings.image_size
    B, F = fd.valid.shape if fd is not None else meshes.faces.shape[:2]
    if min(H, W) < MIN_BINNED_IMAGE or F <= MIN_BINNED_FACES:
        return _dense(settings)
    key = ("mesh", B, F, _settings_key(settings))
    hit = _CACHE.get(key)
    if hit is not None and not grow:
        return hit

    from .binning import count_overflow, suggest_active_tiles_fd, tile_grid

    with torch.no_grad():
        if fd is None:
            from .geometry import setup_face_planes

            fd = setup_face_planes(meshes, camera, znear=settings.znear)
        m = AUTO_MARGIN if margin is None else margin
        pad = math.sqrt(settings.blur_radius) if settings.blur_radius > 0 \
            else 0.0
        mx, _ = count_overflow(fd, (H, W), AUTO_TILE, 0, pad)
        mfb = int(min(F, max(32, math.ceil(float(mx) * m / 32) * 32)))
        act = suggest_active_tiles_fd(fd, (H, W), AUTO_TILE, pad, margin=m)
    TH, TW, _ = tile_grid((H, W), AUTO_TILE)
    if hit is not None:
        # grow: budgets only ever expand
        mfb = max(mfb, hit.max_faces_per_bin)
        act = TH * TW if hit.active_tiles is None else max(
            act, hit.active_tiles)
    resolved = dataclasses.replace(
        settings, bin_size=AUTO_TILE, max_faces_per_bin=mfb,
        active_tiles=None if act >= TH * TW else act,
        check_budgets=_auto_guard(settings),
    )
    _CACHE[key] = resolved
    return resolved


def resolve_points_settings(settings, pcls=None, camera=None, radius=None,
                            q=None, z=None, valid=None, radius_arr=None,
                            grow: bool = False):
    """Resolve ``PointsRasterizationSettings.bin_size=None`` for this cloud;
    explicit settings pass through. Give (pcls, camera [, radius]) or the
    projected (q, z, valid, radius_arr). Cached per (batch, points,
    settings); grow=True re-measures against a cached resolution and keeps
    the larger budgets."""
    if settings.bin_size is not None:
        return settings
    H, W = settings.image_size
    B, N = z.shape if q is not None else pcls.points.shape[:2]
    if min(H, W) < MIN_BINNED_IMAGE or N <= MIN_BINNED_POINTS:
        return _dense(settings)
    key = ("points", B, N, _settings_key(settings))
    hit = _CACHE.get(key)
    if hit is not None and not grow:
        return hit

    from .binning import count_bbox_active_tiles, count_bbox_overflow, \
        tile_grid

    with torch.no_grad():
        if q is None:
            from .points import _radius_array, project_points_screen

            q, z, valid = project_points_screen(pcls, camera, settings.znear)
            radius_arr = _radius_array(radius, settings.radius, B, N,
                                       q.device)
        elif radius_arr is None:
            radius_arr = torch.full((B, N), settings.radius,
                                    dtype=torch.float32, device=q.device)
        lo = q - radius_arr[..., None]
        hi = q + radius_arr[..., None]
        mx = count_bbox_overflow(lo, hi, valid, (H, W), AUTO_TILE)
        na = count_bbox_active_tiles(lo, hi, valid, (H, W), AUTO_TILE)
    ppb = int(min(N, max(32, math.ceil(float(mx) * AUTO_MARGIN / 32) * 32)))
    TH, TW, _ = tile_grid((H, W), AUTO_TILE)
    T = TH * TW
    act = max(8, min(int(math.ceil(na * AUTO_MARGIN / 8) * 8), T))
    if hit is not None:
        # grow: budgets only ever expand (drops strictly decrease)
        ppb = max(ppb, hit.max_points_per_bin)
        act = T if hit.active_tiles is None else max(act, hit.active_tiles)
    resolved = dataclasses.replace(
        settings, bin_size=AUTO_TILE, max_points_per_bin=ppb,
        active_tiles=None if act >= T else act,
        check_budgets=_auto_guard(settings),
    )
    _CACHE[key] = resolved
    return resolved
