"""Carry the JAX package's state into the port.

Every function takes numpy arrays (``np.asarray`` of the JAX dataclass
fields) or plain values, so this module needs neither JAX nor the JAX
package. Carried across: meshes (with their textures), TexturesUV,
TexturesVertex, cameras, FacePlanes, FaceRasterData, RasterizationSettings,
pose parameters, joint shape + texture parameters, PointLights and
Materials.
Each converter builds on ``device`` (default: the card, see
_device.resolve_device).
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .cameras.perspective import PerspectiveCamera
from .rasterize.geometry import FacePlanes, FaceRasterData
from .rasterize.raster import RasterizationSettings
from .shading.lights import Materials, PointLights
from .structures.meshes import Meshes
from .structures.textures import TexturesUV, TexturesVertex


def _tensor(a, dtype, device) -> torch.Tensor:
    # a copy: arrays viewed from another framework are often read-only
    return torch.from_numpy(np.array(a, dtype=dtype)).to(
        resolve_device(device))


def meshes_from_arrays(verts, faces, num_verts, num_faces, textures=None,
                       device=None) -> Meshes:
    """Padded (B, V, 3) verts, (B, F, 3) faces and (B,) counts -> Meshes;
    textures (a TexturesUV or TexturesVertex of this package) is moved to
    the same device."""
    device = resolve_device(device)
    return Meshes(verts=_tensor(verts, np.float32, device),
                  faces=_tensor(faces, np.int64, device),
                  num_verts=_tensor(num_verts, np.int64, device),
                  num_faces=_tensor(num_faces, np.int64, device),
                  textures=None if textures is None else textures.to(device))


def textures_uv_from_arrays(maps, faces_uvs, verts_uvs,
                            device=None) -> TexturesUV:
    """(B, Hm, Wm, C) maps, (B, F, 3) faces_uvs, (B, VT, 2) verts_uvs ->
    TexturesUV."""
    return TexturesUV(maps=_tensor(maps, np.float32, device),
                      faces_uvs=_tensor(faces_uvs, np.int64, device),
                      verts_uvs=_tensor(verts_uvs, np.float32, device))


def textures_vertex_from_arrays(verts_features,
                                device=None) -> TexturesVertex:
    """(B, V, C) per-vertex features -> TexturesVertex."""
    return TexturesVertex(_tensor(verts_features, np.float32, device))


def joint_params_from_arrays(deform, texture_map, device=None) -> dict:
    """Joint-fit parameters {deform: (V, 3), texture_map: (T, T, 3)} as
    JointShapeTextureFitter takes them."""
    return {"deform": _tensor(deform, np.float32, device),
            "texture_map": _tensor(texture_map, np.float32, device)}


def camera_from_arrays(fx, fy, cx, cy, R, t, image_size,
                       device=None) -> PerspectiveCamera:
    """(B,) intrinsics, (B, 3, 3) R and (B, 3) t -> PerspectiveCamera."""
    f = [_tensor(a, np.float32, device) for a in (fx, fy, cx, cy, R, t)]
    return PerspectiveCamera(*f, image_size=(int(image_size[0]),
                                             int(image_size[1])))


def face_planes_from_arrays(x0, y0, x1, y1, x2, y2, z0, z1, z2, valid,
                            device=None) -> FacePlanes:
    """The ten (B, F) planes of a FacePlanes, in field order -> FacePlanes.
    A JAX FacePlanes is a NamedTuple, so ``face_planes_from_arrays(
    *map(np.asarray, fp))`` carries it over."""
    planes = [_tensor(a, np.float32, device)
              for a in (x0, y0, x1, y1, x2, y2, z0, z1, z2)]
    return FacePlanes(*planes, valid=_tensor(valid, np.bool_, device))


def face_raster_data_from_arrays(q, z, invz, area2, abc, zden, valid,
                                 device=None) -> FaceRasterData:
    """The seven arrays of a FaceRasterData, in field order ->
    FaceRasterData."""
    f = [_tensor(a, np.float32, device) for a in (q, z, invz, area2, abc,
                                                  zden)]
    return FaceRasterData(*f, valid=_tensor(valid, np.bool_, device))


def raster_settings_from_fields(**fields) -> RasterizationSettings:
    """RasterizationSettings from the fields of the JAX package's settings
    (``dataclasses.asdict(settings)``): both carry the same fields."""
    fields["image_size"] = tuple(int(v) for v in fields["image_size"])
    if fields.get("occupancy_split") is not None:
        fields["occupancy_split"] = tuple(fields["occupancy_split"])
    return RasterizationSettings(**fields)


def pose_params_from_arrays(t, quat, device=None) -> dict:
    """Pose parameters {t: (B, 3), quat: (B, 4)} as the fitters take them."""
    return {"t": _tensor(t, np.float32, device),
            "quat": _tensor(quat, np.float32, device)}


def point_lights_from_arrays(location, ambient_color, diffuse_color,
                             specular_color, device=None) -> PointLights:
    """The four (B|1, 3) arrays of PointLights, in field order."""
    return PointLights(*(_tensor(a, np.float32, device) for a in (
        location, ambient_color, diffuse_color, specular_color)))


def materials_from_arrays(ambient_color, diffuse_color, specular_color,
                          shininess, device=None) -> Materials:
    """The arrays of Materials, in field order."""
    return Materials(*(_tensor(a, np.float32, device) for a in (
        ambient_color, diffuse_color, specular_color, shininess)))
