"""Cross-ray packed sample layout (counterpart of ``pagnerf_tpu/ops/packed.py``).

After the prune most of a dense ``[R, S]`` march is masked. The packed layout
flattens a microbatch's valid samples, ray-major and depth-ordered, into one
static ``[B]`` buffer (``B = pack_steps * R``, sized for the batch's mean
valid count), so the NeF evaluates B samples instead of R * S. Every ray's
segment is contiguous, so:

- segment reductions (compositing sums, per-ray alpha) are differences of a
  prefix sum at the segment boundaries (``segment_sum``);
- per-ray -> per-sample broadcasts (ray origins and directions, t0 and span)
  are gathers whose backward is again a ``segment_sum``
  (``segment_broadcast``), not a B-event scatter-add.

When the batch holds more valid samples than B, rays are cut by water-filling
(``_water_fill_cap``): the largest per-ray cap k with sum(min(count, k)) <= B,
so every ray keeps its k shallowest valid samples before any ray keeps more.

The buffer's shape is static: nothing here reads a count back to the host.
The pack permutation is built by the JAX package's scatter construction (one
scatter of each kept sample's flat index into its slot); its gather
construction, the JAX package's default, gives the same buffers bit for bit
and is not needed here, where a scatter costs no more than a gather.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .raymarch import RaymarchResult


@dataclasses.dataclass
class PackedSamples:
    """A microbatch's valid samples, ray-major and depth-ordered.

    ray_id [B] int32 owning ray (0 on the padding tail); step_id [B] int32
    step within the ray's dense [S] grid; offsets [R+1] int32 segment
    boundaries (ray r is offsets[r]..offsets[r+1], offsets[R] = the packed
    count <= B); valid [B] bool (False on the padding tail); depths, deltas
    [B]; positionsT [3, B] (feature-major)."""

    ray_id: torch.Tensor
    step_id: torch.Tensor
    offsets: torch.Tensor
    valid: torch.Tensor
    depths: torch.Tensor
    deltas: torch.Tensor
    positionsT: torch.Tensor


# ------------------------------------------------------------- segment ops
_SCAN_BLOCK = 1024


def _scan_rows(t: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum`` along the last axis of t seen as [rows, n]. On the
    card PyTorch scans a tensor of one row (numel == n) with CUB's decoupled
    look-back, whose float sums change from run to run with the order its
    blocks finish (PyTorch lists float ``cumsum`` on CUDA among its
    nondeterministic operations); two or more rows go to its row-per-block
    scan, which adds in a fixed order. A lone row is scanned beside a zero
    row."""
    n = t.shape[-1]
    rows = t.reshape(-1, n)
    if rows.shape[0] == 1:
        return torch.cumsum(torch.cat([rows, torch.zeros_like(rows)]), dim=-1)[:1].reshape(
            t.shape)
    return torch.cumsum(rows, dim=-1).reshape(t.shape)


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, the same bits on every run:
    a scan within blocks of 1024 entries, then a scan of the block totals
    added to each block (the row-per-block scan walks a row in sequence,
    so rows stay short)."""
    b = x.shape[-1]
    nb = -(-b // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - b))
    local = _scan_rows(xp.reshape(x.shape[:-1] + (nb, _SCAN_BLOCK)))
    incl = _scan_rows(local[..., -1])                                # [..., nb]
    carry = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    return (local + carry[..., None]).reshape(xp.shape)[..., :b]


def _comp_prefix(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated inclusive prefix sum along the last axis, with a leading
    zero: (hi, lo) of shape [..., B+1] with hi + lo ~ the exact prefix.

    A float32 prefix over a buffer of millions of samples reaches magnitudes
    whose ulp is ~1e-2, so boundary differences of O(1) segment sums would
    lose 2-4 digits. ``lo`` accumulates each step's rounding residual
    (``x - diff(hi)``) in a second float32 stream, so differences of hi and
    of lo recover segment-scale sums to ~float32 accuracy. The residual is
    zero mathematically, so ``lo`` is detached: the backward is the plain
    prefix sum's. Sums run in float32 (bfloat16 inputs are widened), in the
    fixed order of ``_prefix``."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    hi = _prefix(x)
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    r = x - torch.diff(hi, dim=-1, prepend=zero)
    lo = _prefix(r).detach()
    return torch.cat([zero, hi], dim=-1), torch.cat([zero, lo], dim=-1)


class _BoundaryDiff(torch.autograd.Function):
    """hi [C, B+1] at the sorted boundaries offsets [R+1] -> hi[:, end] -
    hi[:, start], [C, R]. Boundary i is the end of segment i-1 and the start
    of segment i, so the cotangent of hi at offsets[i] is g[i-1] - g[i].
    Empty segments repeat a boundary; over a run of equal boundaries a..b
    those terms telescope to g[a-1] - g[b] (an empty segment's difference is
    identically 0, so its cotangent reaches nothing). The backward writes
    that value at each run's position, the same from every member of the
    run: it adds nothing, so it gives the same bits on every run, whatever
    order the index backward's accumulation would take."""

    @staticmethod
    def forward(ctx, hi, offsets):
        off = offsets.long()
        ctx.save_for_backward(off)
        ctx.width = hi.shape[-1]
        return hi[:, off[1:]] - hi[:, off[:-1]]

    @staticmethod
    def backward(ctx, g):
        (off,) = ctx.saved_tensors
        zero = g.new_zeros(g.shape[:-1] + (1,))
        gp = torch.cat([zero, g, zero], dim=-1)              # gp[:, i] = g[:, i-1]
        first = torch.searchsorted(off, off, right=False)    # run a..b of each boundary
        last = torch.searchsorted(off, off, right=True) - 1
        d = g.new_zeros(g.shape[:-1] + (ctx.width,))
        d[:, off] = gp[:, first] - gp[:, last + 1]
        return d, None


def segment_sum(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sums of contiguous segments: x [C, B], offsets [R+1] -> [C, R], as
    compensated prefix differences at the boundaries. Entries at or past
    offsets[-1] (the padding tail) are in no segment; an empty segment sums
    to exactly 0."""
    hi, lo = _comp_prefix(x)
    end, start = offsets[1:].long(), offsets[:-1].long()
    return _BoundaryDiff.apply(hi, offsets) + (lo[:, end] - lo[:, start])


class _SegmentBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ray_id, offsets):
        ctx.save_for_backward(offsets)
        return x[:, ray_id.long()]

    @staticmethod
    def backward(ctx, g):
        (offsets,) = ctx.saved_tensors
        return segment_sum(g, offsets), None, None


def segment_broadcast(x: torch.Tensor, ray_id: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """Per-ray values to packed samples: x [C, R] -> [C, B] (a gather). Its
    backward is a ``segment_sum`` of the cotangent: cotangents on the padding
    tail (positions >= offsets[-1], which gather ray 0) are dropped, not
    credited to ray 0, since padding outputs are not part of the layout."""
    return _SegmentBroadcast.apply(x, ray_id, offsets)


# ------------------------------------------------------------------ pack
def _count_hist(counts: torch.Tensor, num_steps: int) -> torch.Tensor:
    """hist[j-1] = rays with count >= j, j = 1..num_steps."""
    levels = torch.arange(1, num_steps + 1, dtype=counts.dtype, device=counts.device)
    return torch.sum(counts[None, :] >= levels[:, None], dim=1)


def _cap_from_hist(hist: torch.Tensor, budget) -> torch.Tensor:
    """Largest cap k >= 0 with totals[k-1] = sum(min(counts, k)) <= budget,
    over the last axis of ``hist`` (a budget tensor broadcasts against the
    histograms' cumsum)."""
    return torch.sum(torch.cumsum(hist, dim=-1) <= budget, dim=-1)


def _water_fill_cap(counts: torch.Tensor, num_steps: int, budget: int) -> torch.Tensor:
    """Largest per-ray cap k >= 0 with sum(min(counts, k)) <= budget, from
    one cumsum over the count histogram (totals[k-1] = sum min(counts, k))."""
    return _cap_from_hist(_count_hist(counts, num_steps), budget).to(counts.dtype)



def pack_samples(rm: RaymarchResult, rays_oT: torch.Tensor, rays_dT: torch.Tensor,
                 budget: int, group=None, cap=None) -> PackedSamples:
    """Pack a dense march [R, S] into a static [B = budget] buffer.

    rays_oT / rays_dT: [3, R] ray origins and directions. Depths and
    positions are recomputed in packed space from each ray's t0 and span
    (through ``segment_broadcast``) and the detached unit coordinate
    u = (depth - t0) / span, which is frac + jitter / S and does not depend
    on the pose: pose gradients reach t0, span and the rays through
    ``segment_broadcast``'s backward, with no dense [R, S] scatter. ``cap``:
    the per-ray cap, decided already."""
    r, s = rm.mask.shape
    if rm.t0 is None or rm.span is None:
        raise ValueError("pack_samples needs a RaymarchResult with t0 and span")
    dev = rm.mask.device
    counts = torch.sum(rm.mask, dim=-1, dtype=torch.int32)        # [R]
    if cap is not None:
        cap = cap.to(counts.dtype)
    elif group is None:
        cap = _water_fill_cap(counts, s, budget)
    else:
        raise NotImplementedError("the reference runs in one process")
    keep = torch.minimum(counts, cap)
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.cumsum(keep, dim=0, dtype=torch.int32)])

    # a sample is kept iff valid and among its ray's `keep` shallowest valid
    # ones; its slot is offsets[ray] + its rank among the ray's valid samples
    rank = torch.cumsum(rm.mask, dim=-1, dtype=torch.int32) - 1  # [R, S]
    eligible = rm.mask & (rank < keep[:, None])
    valid = torch.arange(budget, dtype=torch.int32, device=dev) < offsets[-1]
    slot = torch.where(eligible, offsets[:-1, None] + rank, budget).long()
    flat = torch.arange(r * s, dtype=torch.int32, device=dev)
    # slot `budget` collects every dropped sample and is cut off
    sidx = torch.zeros((budget + 1,), dtype=torch.int32, device=dev).scatter_(
        0, slot.reshape(-1), flat)[:budget]
    sidx = torch.where(valid, sidx, 0)
    ray_id = torch.div(sidx, s, rounding_mode="floor")
    step_id = sidx - ray_id * s

    span = rm.span
    safe_span = torch.where(span > 0, span, 1.0)
    u = ((rm.depths - rm.t0[:, None]) / safe_span[:, None]).detach()
    u_b = u.reshape(-1)[sidx.long()]                              # [B]

    geom_b = segment_broadcast(torch.stack([rm.t0, span]), ray_id, offsets)   # [2, B]
    depths = geom_b[0] + u_b * geom_b[1]
    deltas = geom_b[1] / float(s)
    od_b = segment_broadcast(torch.cat([rays_oT, rays_dT], dim=0), ray_id, offsets)
    positionsT = od_b[:3] + od_b[3:] * depths[None, :]
    return PackedSamples(ray_id=ray_id, step_id=step_id, offsets=offsets, valid=valid,
                         depths=depths, deltas=deltas, positionsT=positionsT)


# ------------------------------------------------------------ integration
def packed_integration_weights(tau: torch.Tensor, ps: PackedSamples
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed ``exponential_integration_weights``: tau [B] -> (weights [B],
    alpha [R, 1]). A ray's exclusive transmittance sum is the compensated
    global prefix minus its value at the ray's segment start (hi and lo
    differenced apart)."""
    tau = torch.where(ps.valid, tau, 0.0)
    hi, lo = _comp_prefix(tau)                                    # [B+1] each
    # rays sharing a start are empty but the last: segment_broadcast's
    # backward gives an empty ray exactly 0, so the index backward of
    # hi[start] adds zeros to one term and is the same on every run
    start = ps.offsets[:-1].long()
    base_b = segment_broadcast(torch.stack([hi[start], lo[start]]), ps.ray_id,
                               ps.offsets)                        # [2, B]
    excl = (hi[:-1] - base_b[0]) + (lo[:-1] - base_b[1])
    weights = torch.exp(-excl) * (1.0 - torch.exp(-tau))
    weights = torch.where(ps.valid, weights, 0.0)
    alpha = segment_sum(weights[None, :], ps.offsets).T          # [R, 1]
    return weights, alpha


def packed_composite(feats: torch.Tensor, weights: torch.Tensor,
                     ps: PackedSamples) -> torch.Tensor:
    """Weighted per-ray sums: feats [C, B], weights [B] -> [R, C]."""
    return segment_sum(feats * weights[None, :], ps.offsets).T
