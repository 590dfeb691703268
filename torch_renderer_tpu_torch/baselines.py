"""Baseline / oracle renderers: an always-available numpy ray caster plus
the optional pyrender and open3d oracles, import-gated; the port's own
copy of ``torch_renderer_tpu.baselines`` (numpy only).

The reference keeps pyrender and Open3D as validation baselines
(visualizer.py VisPyrender :8-63; the ICP CPU path at
pytorch3d_icp_registeration.py:191-238). They are comparison oracles, not
capabilities to port: this module exposes pyrender's `quick_depth_render`
and open3d's point-to-point ICP when those packages are installed, and
raises ImportError when they are not.

The executable stand-in for its pixel-fidelity-gate role
(renderer_comparison_with_pyrender.py:254-259) is `VisRaytrace` /
`raytrace_depth` below: an independent float64 Möller–Trumbore ray caster
derived straight from the pinhole model. It shares NOTHING with
rasterize/geometry.setup_faces — no raster-space normalization, no edge
functions, no perspective-correct barycentrics — only the camera contract
both must honor (X_cam = R X + t; u = fx x/z + cx; pixel (i, j) sampled at
(j+0.5, i+0.5)). tests/test_torch_depth_apps.py shows the gate has teeth
(a 4-px principal-point error is caught) and apps/render_compare.py runs it
as the cross-renderer diff.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def raytrace_depth(
    verts, faces, K, R, t, image_size,
    znear: float = 1e-5,
    pixel_chunk: int = 2048,
    face_chunk: int = 2048,
) -> np.ndarray:
    """Float64 ray-cast depth map (H, W); 0 where no triangle is hit.

    Derivation independent of the rasterizer: per pixel the ray direction is
    d = ((u-cx)/fx, (v-cy)/fy, 1) from the camera origin; Möller–Trumbore
    against R X + t triangles; depth is the ray parameter (= camera z since
    d_z = 1). Chunked over both pixels and faces so recorded-sensor-size
    frames (e.g. 180x320 vs a 6k-face mesh) stay within memory.
    """
    Hh, Ww = image_size
    K = np.asarray(K, np.float64)
    tri = (np.asarray(verts, np.float64) @ np.asarray(R, np.float64).T
           + np.asarray(t, np.float64))[np.asarray(faces)]  # (F, 3, 3)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]

    jj, ii = np.meshgrid(np.arange(Ww), np.arange(Hh))
    u = jj.reshape(-1) + 0.5
    v = ii.reshape(-1) + 0.5
    d = np.stack(
        [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)],
        axis=-1,
    )  # (P, 3)

    depth = np.full(d.shape[0], np.inf)
    for lo in range(0, d.shape[0], pixel_chunk):
        dc = d[lo:lo + pixel_chunk]                          # (p, 3)
        best = np.full(dc.shape[0], np.inf)
        for f0 in range(0, v0.shape[0], face_chunk):
            v0c = v0[f0:f0 + face_chunk]
            e1c = e1[f0:f0 + face_chunk]
            e2c = e2[f0:f0 + face_chunk]
            h = np.cross(dc[:, None, :], e2c[None])          # (p, f, 3)
            a = np.einsum("fk,pfk->pf", e1c, h)
            f = 1.0 / np.where(np.abs(a) < 1e-14, np.inf, a)
            s = -v0c[None]                                   # origin is 0
            uu = f * np.einsum("fk,pfk->pf", -v0c, h)
            q = np.cross(s, e1c[None])                       # (p, f, 3)
            vv = f * np.einsum("pk,pfk->pf", dc, q)
            tt = f * np.einsum("fk,pfk->pf", e2c, q)
            hit = (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > znear)
            tt = np.where(hit, tt, np.inf)
            best = np.minimum(best, tt.min(axis=1))
        depth[lo:lo + pixel_chunk] = best

    depth[~np.isfinite(depth)] = 0.0
    return depth.reshape(Hh, Ww)


class VisRaytrace:
    """Always-available offscreen depth oracle with VisPyrender's surface
    (reference visualizer.py:8-63): `quick_depth_render(verts, faces, K,
    extrinsic)` -> (H, W) depth. Backed by the independent numpy ray caster
    above instead of OpenGL; no external dependency, runs in any image."""

    def __init__(self, image_size: Tuple[int, int]):
        self.image_size = tuple(image_size)

    def quick_depth_render(self, verts, faces, K, extrinsic) -> np.ndarray:
        ext = np.asarray(extrinsic, np.float64)
        return raytrace_depth(
            verts, faces, K, ext[:3, :3], ext[:3, 3], self.image_size
        )


def pyrender_available() -> bool:
    try:
        import pyrender  # noqa: F401

        return True
    except Exception:
        return False


class VisPyrender:
    """Offscreen pyrender depth oracle (reference visualizer.py:8-63).

    quick_depth_render(verts, faces, K, extrinsic) -> (H, W) depth. The
    OpenCV->OpenGL pose flip (negate rows 1-2 of the camera pose, reference
    :38-42) happens here so callers speak OpenCV like the rest of the
    framework.
    """

    def __init__(self, image_size: Tuple[int, int]):
        if not pyrender_available():
            raise ImportError(
                "pyrender is not installed; use the framework's own streaming "
                "rasterizer oracle (rasterize.soft.soft_silhouette_streaming / "
                "tests' numpy references) for fidelity gating instead"
            )
        import pyrender

        self._pyrender = pyrender
        H, W = image_size
        self.renderer = pyrender.OffscreenRenderer(W, H)
        self.scene = pyrender.Scene()

    def quick_depth_render(self, verts, faces, K, extrinsic) -> np.ndarray:
        pyrender = self._pyrender
        import trimesh

        self.scene.clear()
        mesh = pyrender.Mesh.from_trimesh(
            trimesh.Trimesh(np.asarray(verts), np.asarray(faces)), smooth=False
        )
        self.scene.add(mesh)
        K = np.asarray(K)
        cam = pyrender.IntrinsicsCamera(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        pose = np.linalg.inv(np.asarray(extrinsic))
        flip = np.diag([1.0, -1.0, -1.0, 1.0])  # OpenCV -> OpenGL camera
        self.scene.add(cam, pose=pose @ flip)
        return self.renderer.render(
            self.scene, flags=pyrender.RenderFlags.DEPTH_ONLY
        )


def open3d_available() -> bool:
    try:
        import open3d  # noqa: F401

        return True
    except Exception:
        return False


def open3d_registration_icp(source: np.ndarray, target: np.ndarray,
                            max_correspondence_distance: float = 0.5,
                            init: Optional[np.ndarray] = None,
                            max_iterations: int = 100):
    """Open3D point-to-point ICP oracle (reference :221-223). Returns
    (R (3, 3), t (3,), rmse)."""
    if not open3d_available():
        raise ImportError(
            "open3d is not installed; use opt.registration.icp_cpu_reference "
            "(numpy) as the CPU oracle instead")
    import open3d as o3d

    def cloud(x):
        return o3d.geometry.PointCloud(o3d.utility.Vector3dVector(
            np.asarray(x, np.float64)))

    reg = o3d.pipelines.registration
    result = reg.registration_icp(
        cloud(source), cloud(target), max_correspondence_distance,
        np.eye(4) if init is None else np.asarray(init, np.float64),
        reg.TransformationEstimationPointToPoint(),
        reg.ICPConvergenceCriteria(max_iteration=max_iterations))
    T = np.asarray(result.transformation)
    return T[:3, :3], T[:3, 3], float(result.inlier_rmse)
