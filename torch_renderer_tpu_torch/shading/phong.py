"""Phong shading over fragment buffers (PyTorch counterpart of
``torch_renderer_tpu.shading.phong``, pytorch3d's Soft/HardPhongShader):
interpolate world positions and normals per fragment, evaluate Phong
lighting, sample texels, then blend (softmax or hard).

Interpolation is global: one indexed gather of the winners' corners over
all faces, on the shade_k-cut fragments. The JAX package's bin-local branch
is a TPU gather workaround and is not carried over. Texels come from a
TexturesVertex (interpolated vertex features), a TexturesUV (interpolated
UVs, then the bilinear sampling kernels of ops/cuda_texsample.py) or, for a
mesh without textures, white.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..cameras.perspective import PerspectiveCamera
from ..rasterize.fragments import Fragments, interpolate_face_attributes
from ..structures.meshes import Meshes
from ..structures.textures import TexturesUV, TexturesVertex
from .blending import BlendParams, hard_rgb_blend, softmax_rgb_blend
from .lights import DirectionalLights, Materials, PointLights

Lights = Union[PointLights, DirectionalLights]


def sample_textures(meshes: Meshes, fragments: Fragments) -> torch.Tensor:
    """Per-fragment texel colors (B, H, W, K, C): barycentric interpolation
    of per-vertex features (TexturesVertex), or of per-corner UVs followed
    by a bilinear map lookup (TexturesUV); ones (C = 3) for an untextured
    mesh."""
    tex = meshes.textures
    if tex is None:
        return torch.ones(fragments.pix_to_face.shape + (3,),
                          dtype=torch.float32, device=fragments.zbuf.device)
    if isinstance(tex, TexturesVertex):
        return interpolate_face_attributes(
            fragments.pix_to_face, fragments.bary,
            tex.face_features(meshes.faces))
    if isinstance(tex, TexturesUV):
        uv = interpolate_face_attributes(fragments.pix_to_face,
                                         fragments.bary, tex.face_uvs())
        return tex.sample(uv)
    raise TypeError(f"unsupported textures type {type(tex)!r}")


def phong_lighting(points: torch.Tensor, normals: torch.Tensor,
                   camera_pos: torch.Tensor, lights: Lights,
                   materials: Materials):
    """Per-fragment (ambient, diffuse, specular) from world-space points
    and normals (B, ..., 3) and the camera center (B, 3)."""
    def expand(c):
        return c.reshape((c.shape[0],) + (1,) * (points.ndim - 2) + (3,))

    ambient = expand(lights.ambient_color * materials.ambient_color)
    l_dir = lights.direction_to(points)
    n = normals / torch.linalg.norm(normals, dim=-1,
                                    keepdim=True).clamp_min(1e-12)
    ndl_raw = (n * l_dir).sum(-1, keepdim=True)
    ndl = torch.relu(ndl_raw)
    diffuse = expand(lights.diffuse_color * materials.diffuse_color) * ndl
    view = expand(camera_pos) - points
    view = view / torch.linalg.norm(view, dim=-1, keepdim=True).clamp_min(1e-12)
    r = 2.0 * ndl_raw * n - l_dir               # reflect the light about n
    rdv = torch.relu((r * view).sum(-1, keepdim=True))
    gate = (ndl > 0).to(points.dtype)           # front-facing only
    shininess = materials.shininess.reshape(
        (materials.shininess.shape[0],) + (1,) * (points.ndim - 1))
    specular = (expand(lights.specular_color * materials.specular_color)
                * gate * torch.pow(rdv.clamp(1e-6, 1.0), shininess))
    return ambient, diffuse, specular


def shade_phong(meshes: Meshes, fragments: Fragments,
                camera: PerspectiveCamera, lights: Optional[Lights] = None,
                materials: Optional[Materials] = None,
                shade_k: Optional[int] = None) -> torch.Tensor:
    """Per-fragment Phong colors (B, H, W, Kc, 3) = texel * (ambient +
    diffuse) + specular. shade_k shades only the nearest shade_k slots."""
    device = meshes.device
    lights = lights if lights is not None else PointLights.make(device=device)
    materials = materials if materials is not None \
        else Materials.make(device=device)
    if shade_k is not None and shade_k < fragments.pix_to_face.shape[-1]:
        fragments = dataclasses.replace(
            fragments, pix_to_face=fragments.pix_to_face[..., :shade_k],
            zbuf=fragments.zbuf[..., :shade_k],
            bary=fragments.bary[..., :shade_k, :],
            dists=fragments.dists[..., :shade_k])
    B, F, _ = meshes.faces.shape
    vn = meshes.vertex_normals()
    fv_normals = vn.gather(1, meshes.faces.reshape(B, 3 * F, 1)
                           .expand(B, 3 * F, 3)).reshape(B, F, 3, 3)
    both = interpolate_face_attributes(
        fragments.pix_to_face, fragments.bary,
        torch.cat([meshes.face_verts(), fv_normals], dim=-1))
    pts, nrm = both[..., :3], both[..., 3:]
    texels = sample_textures(meshes, fragments)
    ambient, diffuse, specular = phong_lighting(
        pts, nrm, camera.camera_center_world(), lights, materials)
    return texels * (ambient + diffuse) + specular


def soft_phong_shader(meshes, fragments, camera, lights=None, materials=None,
                      blend: Optional[BlendParams] = None, znear: float = 1.0,
                      zfar: float = 100.0,
                      shade_k: Optional[int] = None) -> torch.Tensor:
    """SoftPhongShader: Phong colors + softmax blending -> (B, H, W, 4)."""
    colors = shade_phong(meshes, fragments, camera, lights, materials,
                         shade_k=shade_k)
    return softmax_rgb_blend(colors, fragments, blend or BlendParams(),
                             znear=znear, zfar=zfar)


def hard_phong_shader(meshes, fragments, camera, lights=None, materials=None,
                      blend: Optional[BlendParams] = None) -> torch.Tensor:
    """HardPhongShader: nearest-fragment Phong color -> (B, H, W, 4)."""
    colors = shade_phong(meshes, fragments, camera, lights, materials)
    return hard_rgb_blend(colors, fragments, blend or BlendParams())
