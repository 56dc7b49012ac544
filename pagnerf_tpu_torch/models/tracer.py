"""Panoptic radiance-field tracer (counterpart of
``pagnerf_tpu/models/tracer.py``: ``TracerConfig``, ``trace``, the dense or
per-ray compacted ``_trace_block`` and the packed ``_trace_block_packed``).

Contracts kept from the JAX package: panoptic channels integrate under the
detached transmittance; white background composites as
``(1 - alpha) + alpha * ray_colors``; a panoptic channel is
``panoptic_alpha * integrated features``, with the optional background
residual in slot 0.

Ported: the single-block trace in 'ray' and 'voxel' mode, with midpoint
samples or, for training, stratified ``jitter`` (``ops/raymarch.py``), over
the dense layout, the per-ray compacted one (``compact_steps``) or the
cross-ray packed one (``pack_steps``, ``ops/packed.py``). Ray and sample
chunking, the delta-density (DD) tracer and the ray-sparsity loss are not
ported yet; a config that asks for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Optional

import torch

from ..core.rays import Rays
from ..core.render_buffer import RenderBuffer
from ..ops.composite import (composite_channel_T, composite_scalar,
                             exponential_integration_weights)
from ..ops.occupancy import OccupancyGrid
from ..ops.packed import (pack_samples, packed_composite,
                          packed_integration_weights, segment_broadcast)
from ..ops.raymarch import Jitter, compact_samples, raymarch

RENDER_CHANNELS = frozenset({"depth", "alpha", "hit"})
PANOPTIC_CHANNELS = frozenset({"semantics", "inst_embedding"})

NefFn = Callable[[torch.Tensor, Optional[torch.Tensor], FrozenSet[str]],
                 Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TracerConfig:
    """The JAX package's tracer settings, same names and defaults."""

    tracer_type: str = "PanopticPackedRFTracer"
    num_steps: int = 512
    raymarch_type: str = "ray"
    bg_color: str = "white"
    ray_max_travel: float = 2.0
    ray_sparsity_reg: float = 0.0
    sample_chunk: int = 0
    ray_chunk: int = 0
    compact_steps: int = 0
    pack_steps: int = 0
    panoptic_bg_residual: bool = False
    bg_residual_sem: bool = True
    bg_residual_inst: bool = True

    @property
    def is_dd(self) -> bool:
        return "DDensity" in self.tracer_type

    def bg_residual_on(self, channel: str) -> bool:
        gate = (self.bg_residual_inst if channel == "inst_embedding"
                else self.bg_residual_sem)
        return self.panoptic_bg_residual and gate

    def check_ported(self, stage: str) -> None:
        """Raise for settings whose code paths are not ported yet."""
        # each with the ROADMAP.md Queue 1 item that ports it
        unported = {"ray_chunk": (self.ray_chunk, 6),
                    "sample_chunk": (self.sample_chunk, 6),
                    "DD tracer": (self.is_dd, 3),
                    "ray_sparsity_reg (train)": (self.ray_sparsity_reg > 0.0
                                                 and stage == "train", 6)}
        asked = [f"{k} (ROADMAP.md Queue 1 item {n})" for k, (on, n) in unported.items()
                 if on]
        if asked:
            raise NotImplementedError(f"tracer settings not ported yet: {'; '.join(asked)}")


def trace(nef_fn: NefFn, rays: Rays, occ: OccupancyGrid, cfg: TracerConfig,
          channels: FrozenSet[str], stage: str = "val",
          jitter: Jitter = None) -> RenderBuffer:
    """Trace rays [R] against the neural field; midpoint samples unless
    ``jitter`` (a [R, S] tensor or a generator) stratifies them."""
    cfg.check_ported(stage)
    if cfg.pack_steps:
        return _trace_block_packed(nef_fn, rays, occ, cfg, channels, jitter)
    return _trace_block(nef_fn, rays, occ, cfg, channels, jitter)


def _trace_block(nef_fn: NefFn, rays: Rays, occ: OccupancyGrid,
                 cfg: TracerConfig, channels: FrozenSet[str],
                 jitter: Jitter = None) -> RenderBuffer:
    rm = raymarch(rays, occ, cfg.num_steps, cfg.raymarch_type, jitter,
                  cfg.ray_max_travel)
    if cfg.compact_steps:
        rm = compact_samples(rm, cfg.compact_steps)
    r, s = rm.depths.shape

    # feature-major samples [3, R*S]
    coordsT = rm.positionsT.reshape(3, r * s)
    ray_dT = rays.dirs.T[:, :, None].expand(3, r, s).reshape(3, r * s)

    sample_channels = frozenset(channels - RENDER_CHANNELS) | {"density"}
    feats = nef_fn(coordsT, ray_dT, sample_channels)             # {ch: [C, N]}
    out: Dict[str, torch.Tensor] = {}

    density = feats["density"].reshape(r, s)
    tau = density * rm.deltas
    weights, alpha = exponential_integration_weights(tau, rm.mask)
    out["alpha"] = alpha
    out["hit"] = alpha[..., 0] > 0.0

    if channels & PANOPTIC_CHANNELS:
        panop_weights, panop_alpha = exponential_integration_weights(
            tau.detach(), rm.mask)
        out["panoptic_alpha"] = panop_alpha

    if "rgb" in channels:
        ray_colors = composite_channel_T(feats["rgb"].reshape(3, r, s), weights)
        if cfg.bg_color == "white":
            out["rgb"] = (1.0 - alpha) + alpha * ray_colors
        else:
            out["rgb"] = alpha * ray_colors

    if "depth" in channels:
        out["depth"] = composite_scalar(rm.depths, weights)

    for ch in channels & PANOPTIC_CHANNELS:
        f = feats[ch].reshape(-1, r, s)
        comp = panop_alpha * composite_channel_T(f, panop_weights)   # [R, C]
        if cfg.bg_residual_on(ch):
            residual = torch.zeros_like(comp)
            residual[:, 0] = 1.0 - panop_alpha[:, 0] ** 2
            comp = comp + residual
        out[ch] = comp
    return RenderBuffer(**out)


def _trace_block_packed(nef_fn: NefFn, rays: Rays, occ: OccupancyGrid,
                        cfg: TracerConfig, channels: FrozenSet[str],
                        jitter: Jitter = None) -> RenderBuffer:
    """``_trace_block``'s contracts (channels, stop-gradients, background)
    over one cross-ray [3, B] buffer of the march's valid samples, B =
    ``pack_steps`` x rays (``ops/packed.py``)."""
    num_rays = rays.origins.shape[0]
    rm = raymarch(rays, occ, cfg.num_steps, cfg.raymarch_type, jitter,
                  cfg.ray_max_travel)
    ps = pack_samples(rm, rays.origins.T, rays.dirs.T, budget=cfg.pack_steps * num_rays)
    ray_dT = segment_broadcast(rays.dirs.T, ps.ray_id, ps.offsets)   # [3, B]

    sample_channels = frozenset(channels - RENDER_CHANNELS) | {"density"}
    feats = nef_fn(ps.positionsT, ray_dT, sample_channels)           # {ch: [C, B]}
    out: Dict[str, torch.Tensor] = {}

    tau = feats["density"].reshape(-1) * ps.deltas
    weights, alpha = packed_integration_weights(tau, ps)
    out["alpha"] = alpha
    out["hit"] = alpha[..., 0] > 0.0

    if channels & PANOPTIC_CHANNELS:
        panop_weights, panop_alpha = packed_integration_weights(tau.detach(), ps)
        out["panoptic_alpha"] = panop_alpha

    if "rgb" in channels:
        ray_colors = packed_composite(feats["rgb"], weights, ps)
        if cfg.bg_color == "white":
            out["rgb"] = (1.0 - alpha) + alpha * ray_colors
        else:
            out["rgb"] = alpha * ray_colors

    if "depth" in channels:
        out["depth"] = packed_composite(ps.depths[None, :], weights, ps)

    # a packed channel is a difference of prefix sums and may come out a hair
    # below zero: the losses read it through ``safe_prob_log``
    for ch in channels & PANOPTIC_CHANNELS:
        comp = panop_alpha * packed_composite(feats[ch], panop_weights, ps)
        if cfg.bg_residual_on(ch):
            residual = torch.zeros_like(comp)
            residual[:, 0] = 1.0 - panop_alpha[:, 0] ** 2
            comp = comp + residual
        out[ch] = comp
    return RenderBuffer(**out)
