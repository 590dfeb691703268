"""Light and material models with pytorch3d's defaults (PyTorch counterpart
of ``torch_renderer_tpu.shading.lights``). Colors and locations are (B|1, 3)
tensors that broadcast over the batch."""

from __future__ import annotations

import dataclasses

import torch


def _c3(x, device=None) -> torch.Tensor:
    a = torch.as_tensor(x, dtype=torch.float32, device=device)
    return a[None] if a.ndim == 1 else a


def _unit(d: torch.Tensor) -> torch.Tensor:
    return d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-12)


def _expand_to(v: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(B|1, 3) -> (B|1, 1, ..., 1, 3) of points' rank."""
    return v.reshape((v.shape[0],) + (1,) * (points.ndim - 2) + (3,))


@dataclasses.dataclass(frozen=True)
class _Tensors:
    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class PointLights(_Tensors):
    """Point lights (defaults: ambient 0.5, diffuse 0.3, specular 0.2)."""

    location: torch.Tensor
    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor

    @staticmethod
    def make(location=((0.0, 0.0, -3.0),), ambient=((0.5,) * 3,),
             diffuse=((0.3,) * 3,), specular=((0.2,) * 3,),
             device=None) -> "PointLights":
        return PointLights(*(_c3(a, device)
                             for a in (location, ambient, diffuse, specular)))

    def direction_to(self, points: torch.Tensor) -> torch.Tensor:
        """Unit vector from surface points (B, ..., 3) toward the light."""
        return _unit(_expand_to(self.location, points) - points)


@dataclasses.dataclass(frozen=True)
class DirectionalLights(_Tensors):
    """Directional lights; direction points FROM the light."""

    direction: torch.Tensor
    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor

    @staticmethod
    def make(direction=((0.0, 1.0, 0.0),), ambient=((0.5,) * 3,),
             diffuse=((0.3,) * 3,), specular=((0.2,) * 3,),
             device=None) -> "DirectionalLights":
        return DirectionalLights(*(_c3(a, device) for a in (
            direction, ambient, diffuse, specular)))

    def direction_to(self, points: torch.Tensor) -> torch.Tensor:
        return _unit(-_expand_to(self.direction, points)).expand(points.shape)


@dataclasses.dataclass(frozen=True)
class Materials(_Tensors):
    """Phong material (defaults: all-ones colors, shininess 64)."""

    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor
    shininess: torch.Tensor     # (B|1,)

    @staticmethod
    def make(ambient=((1.0,) * 3,), diffuse=((1.0,) * 3,),
             specular=((1.0,) * 3,), shininess=64.0,
             device=None) -> "Materials":
        return Materials(
            _c3(ambient, device), _c3(diffuse, device),
            _c3(specular, device),
            torch.tensor([shininess], dtype=torch.float32, device=device))
