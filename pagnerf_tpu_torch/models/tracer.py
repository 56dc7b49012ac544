"""Panoptic radiance-field tracer (counterpart of
``pagnerf_tpu/models/tracer.py``: ``TracerConfig``, ``trace``, the dense or
per-ray compacted ``_trace_block`` and the packed ``_trace_block_packed``).

Contracts kept from the JAX package: panoptic channels integrate under the
detached transmittance; white background composites as
``(1 - alpha) + alpha * ray_colors``; a panoptic channel is
``panoptic_alpha * integrated features``, with the optional background
residual in slot 0.

With the DD tracer (``PanopticDDensityPackedRFTracer``) the panoptic
channels integrate under the NeF's own ``panoptic_density`` with detached
deltas instead; a NeF without that channel raises ``KeyError`` at the first
trace that asks for a panoptic channel, as in the JAX package.

The trace runs in 'ray' and 'voxel' mode, with midpoint samples or, for
training, stratified ``jitter`` (``ops/raymarch.py``), over the dense
layout, the per-ray compacted one (``compact_steps``) or the cross-ray
packed one (``pack_steps``, ``ops/packed.py``). ``ray_chunk`` traces the
rays in blocks and ``sample_chunk`` evaluates the NeF in chunks of samples,
each block or chunk under ``torch.utils.checkpoint`` when gradients are on
(the JAX package's ``jax.checkpoint``), so its activations are recomputed in
the backward. ``ray_sparsity_reg`` adds the Cauchy sparsity of the
densities, summed per ray and averaged over the real rays, in training.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.rays import Rays
from ..core.render_buffer import RenderBuffer
from ..ops.composite import (composite_channel_T, composite_scalar,
                             exponential_integration_weights)
from ..ops.occupancy import OccupancyGrid
from ..ops.packed import (pack_samples, packed_composite,
                          packed_integration_weights, segment_broadcast,
                          segment_sum)
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


def _checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    gradients are on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _chunked_nef_eval(nef_fn: NefFn, coordsT: torch.Tensor, ray_dT: torch.Tensor,
                      channels: FrozenSet[str], chunk: int) -> Dict[str, torch.Tensor]:
    """The NeF over [3, N] samples in chunks of ``chunk`` (0: one call). The
    JAX package pads N to a multiple of the chunk for its scan; each sample's
    channels do not depend on its chunk, so the port's last chunk is short."""
    n = coordsT.shape[1]
    if chunk <= 0 or n <= chunk:
        return nef_fn(coordsT, ray_dT, channels)
    outs = [_checkpointed(lambda c, d: nef_fn(c, d, channels),
                          coordsT[:, i:i + chunk], ray_dT[:, i:i + chunk])
            for i in range(0, n, chunk)]
    return {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}


def trace(nef_fn: NefFn, rays: Rays, occ: OccupancyGrid, cfg: TracerConfig,
          channels: FrozenSet[str], stage: str = "val",
          jitter: Jitter = None, group=None) -> RenderBuffer:
    """Trace rays [R] against the neural field; midpoint samples unless
    ``jitter`` (a [R, S] tensor or a generator) stratifies them.

    With ``ray_chunk`` the rays are padded, as in the JAX package, to whole
    blocks (origin 0, direction +z: a packed block's water-filling sees its
    padding rays) and traced block by block; a generator draws each block's
    [ray_chunk, S] uniforms in turn, and a jitter tensor has the padded rays'
    rows too, or midpoints stand there. Outputs keep the real rays.
    ``group`` (a data-parallel ``RayGroup``) reaches the packed layout."""
    n, blk = rays.origins.shape[0], cfg.ray_chunk
    if blk <= 0 or n <= blk:
        rb = _trace_block(nef_fn, rays, occ, cfg, channels, stage, jitter, group)
    else:
        pad = (-n) % blk
        o = torch.cat([rays.origins, rays.origins.new_zeros((pad, 3))])
        d = torch.cat([rays.dirs, rays.dirs.new_tensor([0.0, 0.0, 1.0]).expand(pad, 3)])
        if isinstance(jitter, torch.Tensor) and jitter.shape[0] == n:
            jitter = torch.cat([jitter, jitter.new_full((pad, jitter.shape[1]), 0.5)])
        blocks = []
        for i in range(0, n + pad, blk):
            jb = jitter[i:i + blk] if isinstance(jitter, torch.Tensor) else (
                None if jitter is None else torch.rand(
                    (blk, cfg.num_steps), generator=jitter, device=o.device))

            def block(ob, db, jb=jb):
                return _trace_block(nef_fn, Rays(origins=ob, dirs=db, dist_min=rays.dist_min,
                                                 dist_max=rays.dist_max),
                                    occ, cfg, channels, stage, jb, group)
            blocks.append(_checkpointed(block, o[i:i + blk], d[i:i + blk]))
        rb = RenderBuffer.concatenate(blocks)
        rb = RenderBuffer(**{f.name: None if getattr(rb, f.name) is None
                             else getattr(rb, f.name)[:n]
                             for f in dataclasses.fields(rb)})
    if rb.ray_sparsity_loss is not None:
        rb.ray_sparsity_loss = rb.ray_sparsity_loss.mean()
    return rb


def _sample_channels(cfg: TracerConfig, channels: FrozenSet[str]) -> FrozenSet[str]:
    """What the NeF evaluates per sample: the asked channels and the density,
    and the DD tracer's ``panoptic_density`` when a panoptic channel is asked."""
    out = frozenset(channels - RENDER_CHANNELS) | {"density"}
    if cfg.is_dd and channels & PANOPTIC_CHANNELS:
        out = out | {"panoptic_density"}
    return out


def _trace_block(nef_fn: NefFn, rays: Rays, occ: OccupancyGrid,
                 cfg: TracerConfig, channels: FrozenSet[str], stage: str = "val",
                 jitter: Jitter = None, group=None) -> RenderBuffer:
    if cfg.pack_steps:
        return _trace_block_packed(nef_fn, rays, occ, cfg, channels, stage, jitter, group)
    rm = raymarch(rays, occ, cfg.num_steps, cfg.raymarch_type, jitter,
                  cfg.ray_max_travel)
    if cfg.compact_steps:
        rm = compact_samples(rm, cfg.compact_steps)
    r, s = rm.depths.shape

    # feature-major samples [3, R*S]
    coordsT = rm.positionsT.reshape(3, r * s)
    ray_dT = rays.dirs.T[:, :, None].expand(3, r, s).reshape(3, r * s)

    feats = _chunked_nef_eval(nef_fn, coordsT, ray_dT, _sample_channels(cfg, channels),
                              cfg.sample_chunk)                  # {ch: [C, N]}
    out: Dict[str, torch.Tensor] = {}

    density = feats["density"].reshape(r, s)
    tau = density * rm.deltas
    weights, alpha = exponential_integration_weights(tau, rm.mask)
    out["alpha"] = alpha
    out["hit"] = alpha[..., 0] > 0.0

    if cfg.ray_sparsity_reg > 0.0 and stage == "train":
        # per ray; ``trace`` averages over the real rays
        spars = torch.log(1.0 + 2.0 * density ** 2) * rm.mask
        out["ray_sparsity_loss"] = spars.sum(dim=-1) * cfg.ray_sparsity_reg

    if channels & PANOPTIC_CHANNELS:
        if cfg.is_dd:
            panop_tau = feats["panoptic_density"].reshape(r, s) * rm.deltas.detach()
        else:
            panop_tau = tau.detach()
        panop_weights, panop_alpha = exponential_integration_weights(panop_tau, rm.mask)
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
                        stage: str = "val", jitter: Jitter = None,
                        group=None) -> RenderBuffer:
    """``_trace_block``'s contracts (channels, stop-gradients, background)
    over one cross-ray [3, B] buffer of the march's valid samples, B =
    ``pack_steps`` x rays (``ops/packed.py``)."""
    num_rays = rays.origins.shape[0]
    rm = raymarch(rays, occ, cfg.num_steps, cfg.raymarch_type, jitter,
                  cfg.ray_max_travel)
    ps = pack_samples(rm, rays.origins.T, rays.dirs.T, budget=cfg.pack_steps * num_rays,
                      group=group)
    ray_dT = segment_broadcast(rays.dirs.T, ps.ray_id, ps.offsets)   # [3, B]

    feats = _chunked_nef_eval(nef_fn, ps.positionsT, ray_dT,
                              _sample_channels(cfg, channels), cfg.sample_chunk)
    out: Dict[str, torch.Tensor] = {}                                # {ch: [C, B]}

    density = feats["density"].reshape(-1)
    tau = density * ps.deltas
    weights, alpha = packed_integration_weights(tau, ps)
    out["alpha"] = alpha
    out["hit"] = alpha[..., 0] > 0.0

    if cfg.ray_sparsity_reg > 0.0 and stage == "train":
        spars = torch.log(1.0 + 2.0 * density ** 2) * ps.valid
        out["ray_sparsity_loss"] = segment_sum(spars[None, :], ps.offsets)[0] \
            * cfg.ray_sparsity_reg

    if channels & PANOPTIC_CHANNELS:
        if cfg.is_dd:
            panop_tau = feats["panoptic_density"].reshape(-1) * ps.deltas.detach()
        else:
            panop_tau = tau.detach()
        panop_weights, panop_alpha = packed_integration_weights(panop_tau, ps)
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
