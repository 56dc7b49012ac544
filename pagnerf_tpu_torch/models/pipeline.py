"""Pipelines: NeF + tracer (+ learnable camera extrinsics) (counterpart of
``pagnerf_tpu/models/pipeline.py``).

The JAX package keeps parameters in a pytree ``{"nef": ..., "extrinsics":
[num_cams, 9]}``; here they live in the modules, under the same names
(``nef.<...>`` and ``extrinsics``), so ``convert.params_from_flax`` maps one
onto the other by flattening.
"""
from __future__ import annotations

from typing import FrozenSet, Optional, Sequence

import torch
from torch import nn

from ..core.camera import extrinsics_params_from_view_matrix, transform_rays
from ..core.rays import Rays
from ..core.render_buffer import RenderBuffer
from ..ops.occupancy import OccupancyGrid
from .tracer import TracerConfig, trace


class Pipeline(nn.Module):
    """NeF module + tracer config."""

    def __init__(self, nef: nn.Module, tracer_cfg: TracerConfig):
        super().__init__()
        self.nef = nef
        self.tracer_cfg = tracer_cfg

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.nef.reset_parameters(generator)

    def nef_fn(self, lod_weights: Optional[torch.Tensor] = None):
        """Feature-major closure (coordsT [3, N], ray_dT [3, N], channels) ->
        {channel: [C, N]}."""
        def fn(coordsT, ray_dT, channels):
            return self.nef(coordsT, ray_dT, frozenset(channels), lod_weights)
        return fn

    def forward(self, rays: Rays, channels: FrozenSet[str], occ: OccupancyGrid,
                lod_weights: Optional[torch.Tensor] = None,
                stage: str = "val") -> RenderBuffer:
        return trace(self.nef_fn(lod_weights), rays, occ, self.tracer_cfg,
                     frozenset(channels), stage)


class BAPipeline(Pipeline):
    """Bundle-adjustment pipeline: per-camera learnable extrinsics
    ``[num_cams, 9]`` applied to camera-space base rays each forward. Anchor
    frames' extrinsics are detached."""

    def __init__(self, nef: nn.Module, tracer_cfg: TracerConfig,
                 view_matrices: torch.Tensor,
                 anchor_frame_idxs: Sequence[int] = ()):
        super().__init__(nef, tracer_cfg)
        self.register_buffer("_init_extrinsics",
                             extrinsics_params_from_view_matrix(view_matrices.float()),
                             persistent=False)
        self.extrinsics = nn.Parameter(self._init_extrinsics.clone())
        self.num_cameras = int(view_matrices.shape[0])
        anchor = torch.zeros((self.num_cameras,), dtype=torch.bool)
        anchor[list(anchor_frame_idxs)] = True
        self.register_buffer("anchor_mask", anchor, persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.extrinsics.copy_(self._init_extrinsics)

    def camera_params(self) -> torch.Tensor:
        p = self.extrinsics
        return torch.where(self.anchor_mask[:, None], p.detach(), p)

    def transform_rays(self, base_rays: Rays, cam_idx: torch.Tensor) -> Rays:
        """Camera-space base rays [B, R] -> world rays [B*R]."""
        return transform_rays(self.camera_params(), base_rays, cam_idx).reshape(-1)

    def forward(self, rays: Rays, channels: FrozenSet[str], occ: OccupancyGrid,
                lod_weights: Optional[torch.Tensor] = None, stage: str = "val",
                cam_idx: Optional[torch.Tensor] = None) -> RenderBuffer:
        if cam_idx is not None:
            rays = self.transform_rays(rays, cam_idx)
        return super().forward(rays, channels, occ, lod_weights, stage)
