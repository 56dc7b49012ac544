"""Cameras (counterpart of ``pagnerf_tpu/core/camera.py``).

Learnable extrinsics are a ``[num_cams, 9]`` tensor: the 6-D continuous
rotation (the first two columns of the world->camera rotation, Zhou et al.
CVPR'19) plus the translation. ``transform_rays`` applies them to
camera-space base rays, as ``BAPipeline`` does each forward.

``PinholeIntrinsics`` and ``view_from_c2w`` are numpy helpers for the
synthetic dataset; they are copies of the JAX package's, kept here so the
port imports nothing of it. ``generate_pinhole_rays`` makes the camera-space
rays through pixel centres that validation regenerates at each mip level.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .rays import Rays


@dataclasses.dataclass
class PinholeIntrinsics:
    fx: np.float32
    fy: np.float32
    cx: np.float32
    cy: np.float32
    width: int
    height: int
    near: float = 0.0
    far: float = 6.0

    def rescaled(self, scale: float, new_width: int, new_height: int) -> "PinholeIntrinsics":
        """The intrinsics of the image resized by ``scale`` (a mip level)."""
        return PinholeIntrinsics(fx=self.fx * scale, fy=self.fy * scale,
                                 cx=self.cx * scale, cy=self.cy * scale,
                                 width=new_width, height=new_height,
                                 near=self.near, far=self.far)


def view_from_c2w(c2w: np.ndarray) -> np.ndarray:
    """Invert a camera-to-world pose into a world->camera view matrix."""
    rot = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    view = np.zeros_like(c2w)
    rt = np.swapaxes(rot, -1, -2)
    view[..., :3, :3] = rt
    view[..., :3, 3] = -np.einsum("...ij,...j->...i", rt, t)
    view[..., 3, 3] = 1.0
    return view


def r6_to_rotmat(r6: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] rotation via Gram-Schmidt of the first two columns."""
    a1, a2 = r6[..., 0:3], r6[..., 3:6]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + 1e-12)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / (torch.linalg.norm(a2p, dim=-1, keepdim=True) + 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)  # columns


def rotmat_to_r6(rot: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: first two columns, flattened."""
    return torch.cat([rot[..., :, 0], rot[..., :, 1]], dim=-1)


def extrinsics_params_from_view_matrix(view: torch.Tensor) -> torch.Tensor:
    """World->camera view matrices [N, 4, 4] -> learnable params [N, 9]."""
    return torch.cat([rotmat_to_r6(view[..., :3, :3]), view[..., :3, 3]], dim=-1)


def view_matrix_from_extrinsics_params(params: torch.Tensor) -> torch.Tensor:
    """Params [N, 9] -> world->camera view matrices [N, 4, 4]."""
    view = torch.zeros(params.shape[:-1] + (4, 4), dtype=params.dtype,
                       device=params.device)
    view[..., :3, :3] = r6_to_rotmat(params[..., :6])
    view[..., :3, 3] = params[..., 6:9]
    view[..., 3, 3] = 1.0
    return view


def inv_transform_rays(params: torch.Tensor, origins: torch.Tensor,
                       dirs: torch.Tensor):
    """Camera-space rays [num_cams, R, 3] -> world space under extrinsics
    [num_cams, 9]: x_world = R^T (x_cam - t). The 3x3 products run in full
    float32 (PyTorch leaves TF32 off for matmuls by default)."""
    rot = r6_to_rotmat(params[..., :6])          # [N, 3, 3]
    t = params[..., 6:9]                          # [N, 3]
    o_w = torch.einsum("nij,nri->nrj", rot, origins - t[:, None, :])
    d_w = torch.einsum("nij,nri->nrj", rot, dirs)
    return o_w, d_w


def generate_centered_pixel_coords(width: int, height: int):
    """Pixel-centre coordinate grids (x, y), each [height, width] float32."""
    x = torch.arange(width, dtype=torch.float32) + 0.5
    y = torch.arange(height, dtype=torch.float32) + 0.5
    return torch.meshgrid(x, y, indexing="xy")


def generate_pinhole_rays(intr: PinholeIntrinsics, dist_min: float = 0.0,
                          dist_max: float = 6.0) -> Rays:
    """Camera-space pinhole rays [height, width] through pixel centres, GL
    convention (the camera looks down -z, y up), in float32 on the CPU."""
    px, py = generate_centered_pixel_coords(intr.width, intr.height)
    x = (px - float(intr.cx)) / float(intr.fx)
    y = (py - float(intr.cy)) / float(intr.fy)
    dirs = torch.stack([x, -y, -torch.ones_like(x)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return Rays(origins=torch.zeros_like(dirs), dirs=dirs,
                dist_min=dist_min, dist_max=dist_max)


def rays_to_3d_points(rays: Rays, depth: torch.Tensor) -> torch.Tensor:
    """World points at the rendered depth [R, 1] along world rays [R]."""
    return rays.origins + rays.dirs * depth.reshape(depth.shape[0], 1)


def transform_rays(params: torch.Tensor, base_rays: Rays,
                   cam_idx: torch.Tensor) -> Rays:
    """Apply the extrinsics of cameras ``cam_idx`` [B] to camera-space base rays
    [B, R]; directions are re-normalised."""
    o_w, d_w = inv_transform_rays(params[cam_idx], base_rays.origins,
                                  base_rays.dirs)
    d_w = d_w / (torch.linalg.norm(d_w, dim=-1, keepdim=True) + 1e-12)
    return Rays(origins=o_w.float(), dirs=d_w.float(),
                dist_min=base_rays.dist_min, dist_max=base_rays.dist_max)
