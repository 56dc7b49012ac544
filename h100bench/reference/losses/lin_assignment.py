"""Linear-assignment instance losses (counterpart of
``pagnerf_tpu/losses/lin_assignment.py``).

Per image: a (label x slot) cost from the mean rendered slot probability
under each ground-truth label, a minimum-cost matching of labels to slots
(``ops/assignment.lap_assign``: the microbatch's [B, K, M] costs in one
call, on the device, as the JAX package's ``vmap`` solves them), and an NLL
toward the matched "virtual" labels wherever a pixel disagrees. In the 'things' variant slot 0
is reserved for stuff and the optional repeated-ID rejection penalises
slots outside a band that each instance's world-x position allows; the
plain variant matches every label over all pixels.

Under ray-axis data parallelism (a ``group``, ``parallel/sharding.py``)
each image's label x slot sums and counts, and the rejection's centre
sums, are summed over the ranks before the division (one collective a
microbatch), so every rank solves the same assignment on the same costs;
``any_wrong`` is reduced by max, and the plain variant's per-image
denominators are global.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..ops.assignment import lap_assign
from .photometric import safe_prob_log


def one_hot(labels: torch.Tensor, num: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: rows of labels outside [0, num) are all zero."""
    return (labels[:, None] == torch.arange(num, device=labels.device)).to(dtype)


def hungarian_assign(cost: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``hungarian_assign`` contract: NaN and infinities
    mapped into [-1e12, 1e12], then the exact assignment of each image
    (cost [B, K, M] or [K, M])."""
    cost = torch.clamp(torch.nan_to_num(cost.float()), -1e12, 1e12)
    return lap_assign(cost, present)


def _slot_sums(probs: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
               num_labels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums [K, M] of probs over each label's valid pixels, counts [K])."""
    oh = one_hot(labels, num_labels, probs.dtype) * valid[:, None]
    return oh.T @ probs, oh.sum(0)


def add_position_id_range_cost(cost: torch.Tensor, centers_x: torch.Tensor,
                               present: torch.Tensor,
                               frame_min_length: float = 0.3,
                               max_num_inst_at_x: int = 30,
                               id_margin_at_frame_length: int = 30) -> torch.Tensor:
    """Repeated-ID rejection: each instance's world x maps to a band of
    allowed slots; out-of-band (label, slot) pairs cost 10000 more.
    cost [K, M], centers_x [K]. With M at or below the id margin every slot
    is in band and the cost is returned as it is."""
    m = cost.shape[1]
    slope = (max_num_inst_at_x + id_margin_at_frame_length) / frame_min_length
    x_limit = (m - id_margin_at_frame_length) / slope
    if x_limit <= 0:
        return cost
    x = (-centers_x + 1.0) / 2.0
    lo = torch.clamp(slope * torch.remainder(x, x_limit), 0, m - 1).to(torch.int32)
    hi = torch.clamp(lo + id_margin_at_frame_length, 0, m - 1)
    slots = torch.arange(m, device=cost.device)[None, :]
    allowed = (lo[:, None] <= slots) & (slots <= hi[:, None])
    penal = torch.where(allowed | ~present[:, None], 0.0, 10000.0)
    return cost + penal


def _reduce(parts: List[torch.Tensor], group, tag: str) -> List[torch.Tensor]:
    """``parts`` summed over the ranks in one collective (as they are
    without a group)."""
    if group is None:
        return parts
    raise NotImplementedError("the reference runs in one process")
    flat = all_reduce(torch.cat([p.reshape(-1) for p in parts]), group, tag)
    return [x.view(p.shape).to(p.dtype)
            for x, p in zip(torch.split(flat, [p.numel() for p in parts]), parts)]


def _any_wrong(wrong: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return wrong
    raise NotImplementedError("the reference runs in one process")
    import torch.distributed as dist
    return all_reduce(wrong.to(torch.int32), group, "any_wrong", dist.ReduceOp.MAX) > 0


def lin_assignment_things_loss(probs: torch.Tensor, labels: torch.Tensor,
                               stuff_mask: torch.Tensor, num_labels: int,
                               points_3d: Optional[torch.Tensor] = None,
                               outlier_rejection: bool = False, group=None) -> torch.Tensor:
    """probs [B, R, M] softmaxed slot probabilities; labels [B, R] instance
    ids; stuff_mask [B, R] bool; points_3d [B, R, 3] world points for the
    rejection cost. Returns the per-pixel loss map [B, R]. The matching is
    made on detached probabilities (it is integer-valued); the NLL carries
    the gradient."""
    gts = labels.to(torch.int64)
    in_range = gts < num_labels
    things_mask = (gts > 0) & in_range
    valid = (stuff_mask | things_mask) & in_range
    with torch.no_grad():
        parts = []
        for b in range(probs.shape[0]):
            p, gt = probs[b], gts[b]
            things_valid = things_mask[b].to(p.dtype)
            sums, counts = _slot_sums(p[:, 1:], gt, things_valid, num_labels)
            parts += [sums, counts]
            if outlier_rejection:
                pts = (points_3d[b] if points_3d is not None
                       else torch.zeros(p.shape[0], 3, dtype=p.dtype, device=p.device))
                parts += list(_slot_sums(pts, gt, things_mask[b].to(pts.dtype),
                                         num_labels))
        parts = _reduce(parts, group, "assign_sums")
        step = 4 if outlier_rejection else 2
        costs, presents = [], []
        for b in range(probs.shape[0]):
            sums, counts = parts[step * b], parts[step * b + 1]
            cost = -sums / (counts[:, None] + 1e-4)
            present = (counts > 0) & (torch.arange(num_labels, device=probs.device) > 0)
            if outlier_rejection:
                centers = parts[step * b + 2] / torch.clamp(parts[step * b + 3][:, None],
                                                            min=1e-6)
                cost = add_position_id_range_cost(cost, centers[:, 0], present)
            costs.append(cost)
            presents.append(present)
        assign = hungarian_assign(torch.stack(costs), torch.stack(presents))   # [B, K]
        virt = torch.where(things_mask, torch.gather(
            assign, 1, torch.clamp(gts, 0, num_labels - 1)) + 1, 0)
        any_wrong = _any_wrong(torch.any((virt != torch.argmax(probs, dim=-1)) & valid,
                                         dim=1), group)
    nll = -torch.gather(safe_prob_log(probs), 2, virt[..., None])[..., 0]
    return torch.where(valid & any_wrong[:, None], nll, 0.0)


def lin_assignment_loss(probs: torch.Tensor, labels: torch.Tensor,
                        num_labels: int, group=None) -> torch.Tensor:
    """The plain linear-assignment loss: per image, labels matched to slots
    over all pixels, an NLL toward the virtual labels if any pixel
    disagrees, averaged over the images. probs [B, R, M] softmaxed, labels
    [B, R]. Labels at or past ``num_labels`` add nothing. The reference
    builds the cost from a second softmax of the probabilities (the NLL
    reads them as they are), which can move the optimum in near ties; it is
    kept. Under a ``group``, this rank's share of the loss."""
    gts = labels.to(torch.int64)
    in_range = gts < num_labels
    with torch.no_grad():
        parts = []
        for p, gt, ok in zip(probs, gts, in_range):
            parts += list(_slot_sums(torch.softmax(p, dim=-1), gt, ok.to(p.dtype),
                                     num_labels))
        parts.append(in_range.sum(dim=1).to(probs.dtype))
        parts = _reduce(parts, group, "assign_sums")
        costs, presents = [], []
        for b in range(probs.shape[0]):
            sums, counts = parts[2 * b], parts[2 * b + 1]
            costs.append(-sums / (counts[:, None] + 1e-4))
            presents.append(counts > 0)
        assign = hungarian_assign(torch.stack(costs), torch.stack(presents))   # [B, K]
        virt = torch.gather(assign, 1, torch.clamp(gts, 0, num_labels - 1))
        any_wrong = _any_wrong(torch.any((virt != torch.argmax(probs, dim=-1)) & in_range,
                                         dim=1), group)
        denom = torch.clamp(parts[-1], min=1)
    nll = -torch.gather(safe_prob_log(probs), 2, virt[..., None])[..., 0]
    nll = torch.where(in_range, nll, 0.0)
    return torch.where(any_wrong, nll.sum(dim=1) / denom, 0.0).mean()
