"""Ray marching against the occupancy grid, dense ``[rays, steps]`` layout
(counterpart of ``pagnerf_tpu/ops/raymarch.py``).

Ported: the 'ray' mode, with midpoint samples (a render) or stratified
jitter (training: the JAX package's ``key``, here an explicit ``jitter``
tensor ``[R, S]`` of uniforms in [0, 1) or a ``torch.Generator`` to draw one
from). The 'voxel' mode and sample compaction are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..core.rays import Rays
from .occupancy import OccupancyGrid


@dataclasses.dataclass
class RaymarchResult:
    """Dense samples along rays: positionsT [3, R, S] (coordinate axis major),
    depths/deltas/mask [R, S], and the per-ray interval t0/span [R]."""

    positionsT: torch.Tensor
    depths: torch.Tensor
    deltas: torch.Tensor
    mask: torch.Tensor
    t0: Optional[torch.Tensor] = None
    span: Optional[torch.Tensor] = None


def aabb_intersect(rays: Rays, lo: float = -1.0, hi: float = 1.0):
    """Slab test against the scene cube: (t_near [R], t_far [R], hit [R])."""
    d = rays.dirs
    inv_d = 1.0 / torch.where(d.abs() < 1e-9,
                              torch.where(d >= 0, 1e-9, -1e-9).to(d.dtype), d)
    t0 = (lo - rays.origins) * inv_d
    t1 = (hi - rays.origins) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_near = torch.clamp(t_near, min=0.0)
    return t_near, t_far, t_far > t_near


Jitter = Union[None, torch.Tensor, torch.Generator]


def _uniform_samples(t0: torch.Tensor, t1: torch.Tensor, num_steps: int,
                     jitter: Jitter = None):
    """Stratified (or midpoint, ``jitter=None``) samples in [t0, t1] per ray
    -> depths, deltas [R, S]."""
    r = t0.shape[0]
    span = (t1 - t0)[:, None]
    step = span / num_steps
    frac = torch.arange(num_steps, dtype=torch.float32,
                        device=t0.device)[None, :] / num_steps
    if jitter is None:
        jitter = 0.5
    elif isinstance(jitter, torch.Generator):
        jitter = torch.rand((r, num_steps), generator=jitter, device=t0.device)
    elif tuple(jitter.shape) != (r, num_steps):
        raise ValueError(f"jitter must be [R={r}, S={num_steps}], got "
                         f"{tuple(jitter.shape)}")
    depths = t0[:, None] + (frac + jitter / num_steps) * span
    return depths, step.expand_as(depths)


def raymarch(rays: Rays, occ: OccupancyGrid, num_steps: int,
             raymarch_type: str = "ray", jitter: Jitter = None) -> RaymarchResult:
    """'ray' mode: ``num_steps`` samples in each ray's AABB interval (midpoints,
    or stratified by ``jitter``), masked by occupancy and by the AABB hit."""
    if raymarch_type != "ray":
        raise NotImplementedError(
            f"raymarch_type={raymarch_type!r} is not ported yet (only 'ray')")
    t_near, t_far, hit_aabb = aabb_intersect(rays)
    dist_min = torch.as_tensor(rays.dist_min, dtype=torch.float32, device=t_near.device)
    dist_max = torch.as_tensor(rays.dist_max, dtype=torch.float32, device=t_near.device)
    t0 = torch.maximum(t_near, dist_min)
    t1 = torch.maximum(torch.minimum(t_far, dist_max), t0)

    depths, deltas = _uniform_samples(t0, t1, num_steps, jitter)
    oT, dT = rays.origins.T, rays.dirs.T
    positionsT = oT[:, :, None] + dT[:, :, None] * depths[None, :, :]   # [3, R, S]
    mask = occ.occupied_at_T(positionsT) & hit_aabb[:, None]
    return RaymarchResult(positionsT=positionsT, depths=depths, deltas=deltas,
                          mask=mask, t0=t0, span=t1 - t0)
