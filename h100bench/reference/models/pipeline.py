"""Pipelines: NeF + tracer (+ learnable camera extrinsics) (counterpart of
``pagnerf_tpu/models/pipeline.py``).

The JAX package keeps parameters in a pytree ``{"nef": ..., "extrinsics":
[num_cams, 9]}``; here they live in the modules, under the same names
(``nef.<...>`` and ``extrinsics``), so ``convert.params_from_flax`` maps one
onto the other by flattening.
"""
from __future__ import annotations

from typing import FrozenSet, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.camera import extrinsics_params_from_view_matrix, transform_rays
from ..core.rays import Rays
from ..core.render_buffer import RenderBuffer
from ..ops.occupancy import OccupancyGrid
from ..ops.raymarch import Jitter
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

    def query_density(self, coordsT: torch.Tensor,
                      lod_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Density [N] at coords [3, N] (the prune's query): the max of
        ``density`` and ``panoptic_density`` where the NeF has both."""
        channels = frozenset({"density"}) | (
            frozenset({"panoptic_density"}) & self.nef.supported_channels())
        dirsT = torch.full_like(coordsT, 1.0 / 3.0 ** 0.5)
        out = self.nef(coordsT, dirsT, channels, lod_weights)
        d = out["density"][0]
        if "panoptic_density" in out:
            d = torch.maximum(d, out["panoptic_density"][0])
        return d

    def forward(self, rays: Rays, channels: FrozenSet[str], occ: OccupancyGrid,
                lod_weights: Optional[torch.Tensor] = None, stage: str = "val",
                jitter: Jitter = None,
                tracer_cfg: Optional[TracerConfig] = None, group=None,
                images: int = 1) -> RenderBuffer:
        """``jitter`` stands where the JAX package takes a ``key``: None for
        midpoint samples, or stratified samples' uniforms [R, S] (or a
        generator to draw them). ``group``: the trainer's data-parallel
        ``RayGroup``, for the packed layout's global cap; ``images``: the
        images the rays come from, each its rank's share of ``R`` rays in
        turn (the tracer places them in the global ray order)."""
        return trace(self.nef_fn(lod_weights), rays, occ,
                     tracer_cfg or self.tracer_cfg, frozenset(channels), stage,
                     jitter, group, images)


class BAPipeline(Pipeline):
    """Bundle-adjustment pipeline: per-camera learnable extrinsics
    ``[num_cams, 9]`` applied to camera-space base rays each forward. Anchor
    frames' extrinsics are detached, so a batch of anchor rays carries no
    coordinate gradient and its encode skips ``dbary``."""

    def __init__(self, nef: nn.Module, tracer_cfg: TracerConfig,
                 view_matrices: torch.Tensor,
                 anchor_frame_idxs: Sequence[int] = ()):
        super().__init__(nef, tracer_cfg)
        self.register_buffer("_init_extrinsics",
                             extrinsics_params_from_view_matrix(view_matrices.float()),
                             persistent=False)
        self.extrinsics = nn.Parameter(self._init_extrinsics.clone())
        self.num_cameras = int(view_matrices.shape[0])
        anchor = np.zeros((self.num_cameras,), dtype=bool)
        anchor[list(anchor_frame_idxs)] = True
        # the host copy answers "is every camera of the batch an anchor"
        # without a device read
        self.anchor_host = anchor
        self.register_buffer("anchor_mask", torch.from_numpy(anchor.copy()),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.extrinsics.copy_(self._init_extrinsics)

    def camera_params(self, cam_idx: Optional[torch.Tensor] = None,
                      cam_idx_host: Optional[np.ndarray] = None) -> torch.Tensor:
        """Extrinsics with the anchor frames' rows detached. When every camera
        of the batch is an anchor, the whole tensor is detached, so the rays
        (and the samples' coordinates) carry no gradient at all and the
        encode's backward skips ``dbary``. The cameras are read from
        ``cam_idx_host`` (the batch's numpy array) against the host copy of
        the anchor mask; without it, from ``cam_idx`` (a device read)."""
        p = self.extrinsics
        if cam_idx is not None and p.requires_grad and torch.is_grad_enabled():
            cams = (np.asarray(cam_idx_host) if cam_idx_host is not None
                    else cam_idx.cpu().numpy())
            if bool(self.anchor_host[cams.astype(np.int64)].all()):
                return p.detach()
        return torch.where(self.anchor_mask[:, None], p.detach(), p)

    def transform_rays(self, base_rays: Rays, cam_idx: torch.Tensor,
                       cam_idx_host: Optional[np.ndarray] = None) -> Rays:
        """Camera-space base rays [B, R] -> world rays [B*R]."""
        return transform_rays(self.camera_params(cam_idx, cam_idx_host), base_rays,
                              cam_idx).reshape(-1)

    def forward(self, rays: Rays, channels: FrozenSet[str], occ: OccupancyGrid,
                lod_weights: Optional[torch.Tensor] = None, stage: str = "val",
                cam_idx: Optional[torch.Tensor] = None, jitter: Jitter = None,
                tracer_cfg: Optional[TracerConfig] = None,
                cam_idx_host: Optional[np.ndarray] = None, group=None,
                images: int = 1) -> RenderBuffer:
        if cam_idx is not None:
            rays = self.transform_rays(rays, cam_idx, cam_idx_host)
        return super().forward(rays, channels, occ, lod_weights, stage, jitter,
                               tracer_cfg, group, images)
