"""Ray marching against the occupancy grid, dense ``[rays, steps]`` layout
(counterpart of ``pagnerf_tpu/ops/raymarch.py``).

Both march modes, with midpoint samples (a render) or stratified jitter
(training: the JAX package's ``key``, here an explicit ``jitter`` tensor
``[R, S]`` of uniforms in [0, 1) or a ``torch.Generator`` to draw one from):
'ray' spreads the samples over each ray's AABB interval; 'voxel' (after the
prune) probes for the first occupied cell and refits the samples to the
``ray_max_travel`` span behind it. ``compact_samples`` is the per-ray
compacted layout.

The voxel probe is single-stage by default. With ``PAGNERF_WINDOWED_PROBE=1``
(read at each march, as the JAX package reads it), a finite
``ray_max_travel`` and an occupancy level of 5 or more, it is the JAX
package's two-stage probe whenever that takes fewer lookups: a res/4
max-pool mip of the mask finds a conservative window start, then
full-resolution probes cover only the window the refit can use.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Union

import torch

from ..core.rays import Rays
from ..device import constant
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


_BIG = 1e10


def _windowed_probe() -> bool:
    """``PAGNERF_WINDOWED_PROBE`` is "1": the two-stage voxel probe. Off by
    default: it places samples otherwise, so it must not flip in a run
    resumed mid-flight."""
    return os.environ.get("PAGNERF_WINDOWED_PROBE", "0") == "1"


def _window_plan(occ: OccupancyGrid, ray_max_travel: float):
    """(coarse level, pn1, pn2, window width) of the two-stage probe, or
    None where the single-stage probe runs: the switch off, an infinite
    travel, a level below 5, or no fewer lookups (pn1 + pn2 >= probe_n)."""
    if not (_windowed_probe() and math.isfinite(ray_max_travel) and occ.level >= 5):
        return None
    clevel = occ.level - 2
    cres = 1 << clevel
    pn1 = int(math.ceil(math.sqrt(3.0) * cres))
    w_max = ray_max_travel + 2.0 * (2.0 / cres)
    pn2 = int(math.ceil(occ.res * w_max / 2.0))
    if pn1 + pn2 >= int(math.ceil(math.sqrt(3.0) * occ.res)):
        return None
    return clevel, pn1, pn2, w_max


def mip_mask(occ: OccupancyGrid) -> OccupancyGrid:
    """The res/4 max-pool mip of ``occ.mask`` (a coarse cell is occupied
    when any of its 4^3 fine cells is), as a grid two levels down."""
    cres = occ.res // 4
    mip = occ.mask.reshape(cres, 4, cres, 4, cres, 4).any(dim=5).any(dim=3).any(dim=1)
    return OccupancyGrid(occupancy=occ.occupancy.new_zeros((1,)), mask=mip.reshape(-1),
                         level=occ.level - 2)


def raymarch(rays: Rays, occ: OccupancyGrid, num_steps: int,
             raymarch_type: str = "ray", jitter: Jitter = None,
             ray_max_travel: float = float("inf")) -> RaymarchResult:
    """'ray' mode: ``num_steps`` samples in each ray's AABB interval
    (midpoints, or stratified by ``jitter``), masked by occupancy and by the
    AABB hit. 'voxel' mode: ``ceil(sqrt(3) res)`` midpoint probes of the
    interval find each ray's first occupied cell; the interval then starts
    one probe step before it and ends ``ray_max_travel`` later (or at the
    AABB exit), and the samples are spread over that; a ray whose probes
    hit nothing keeps its interval. Under ``PAGNERF_WINDOWED_PROBE=1`` the
    probe may be the two-stage one (``_window_plan``)."""
    if raymarch_type not in ("ray", "voxel"):
        raise ValueError(f"raymarch_type must be 'ray' or 'voxel', got {raymarch_type!r}")
    t_near, t_far, hit_aabb = aabb_intersect(rays)
    dist_min, dist_max = (d.to(t_near.device, torch.float32) if isinstance(d, torch.Tensor)
                          else constant(d, torch.float32, t_near.device)
                          for d in (rays.dist_min, rays.dist_max))
    t0 = torch.maximum(t_near, dist_min)
    t1 = torch.maximum(torch.minimum(t_far, dist_max), t0)
    oT, dT = rays.origins.T, rays.dirs.T

    def positions_at(depths):
        return oT[:, :, None] + dT[:, :, None] * depths[None, :, :]   # [3, R, S]

    if raymarch_type == "voxel":
        plan = _window_plan(occ, ray_max_travel)
        if plan is not None:
            # the mip's occupancy is a superset of the mask's, so its first
            # hit lies at or before the fine one; full-resolution probes then
            # cover [tc, tc + w_max] only. A ray whose corridor holds no fine
            # hit in the window keeps its interval, as a probe miss does.
            clevel, pn1, pn2, w_max = plan
            d1, _ = _uniform_samples(t0, t1, pn1)
            o1 = mip_mask(occ).occupied_at_T(positions_at(d1))
            tc = torch.amin(torch.where(o1, d1, _BIG), dim=-1)
            coarse_hit = tc < _BIG
            tc = torch.where(coarse_hit, torch.maximum(tc - (t1 - t0) / pn1, t0), t0)
            w = torch.clamp(t1 - tc, max=w_max)
            d2, _ = _uniform_samples(tc, tc + w, pn2)
            o2 = occ.occupied_at_T(positions_at(d2))
            first = torch.amin(torch.where(o2, d2, _BIG), dim=-1)
            has_hit = first < _BIG
            first = torch.maximum(first - w / pn2, t0)
        else:
            # probes one cell apart on the longest diagonal, so a one-cell
            # wall cannot fall between two of them
            probe_n = int(math.ceil(math.sqrt(3.0) * occ.res))
            probe_depths, _ = _uniform_samples(t0, t1, probe_n)
            probe_occ = occ.occupied_at_T(positions_at(probe_depths))
            first = torch.amin(torch.where(probe_occ, probe_depths, _BIG), dim=-1)
            has_hit = first < _BIG
            # back off one probe step: the occupied cell's front face lies
            # up to a step before its probe
            first = torch.maximum(first - (t1 - t0) / probe_n, t0)
        t0 = torch.where(has_hit, first, t0)
        if ray_max_travel != float("inf"):
            t1 = torch.where(has_hit, torch.minimum(t0 + ray_max_travel, t1), t1)

    depths, deltas = _uniform_samples(t0, t1, num_steps, jitter)
    positionsT = positions_at(depths)
    mask = occ.occupied_at_T(positionsT) & hit_aabb[:, None]
    return RaymarchResult(positionsT=positionsT, depths=depths, deltas=deltas,
                          mask=mask, t0=t0, span=t1 - t0)


def compact_samples(rm: RaymarchResult, keep_steps: int) -> RaymarchResult:
    """Per-ray compaction: each ray's samples stably sorted valid first
    (depth order kept among the valid) and cut to ``keep_steps``; a ray with
    more valid samples loses its deepest ones. A no-op for ``keep_steps``
    <= 0 or >= S."""
    if keep_steps <= 0 or keep_steps >= rm.depths.shape[-1]:
        return rm
    key = (~rm.mask).to(torch.int32)
    _, order = torch.sort(key, dim=-1, stable=True)
    order = order[:, :keep_steps]
    take = lambda a: torch.gather(a, -1, order)
    return RaymarchResult(
        positionsT=torch.stack([take(p) for p in rm.positionsT]),
        depths=take(rm.depths), deltas=take(rm.deltas), mask=take(rm.mask),
        t0=rm.t0, span=rm.span)
