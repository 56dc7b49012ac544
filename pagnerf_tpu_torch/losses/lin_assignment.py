"""Linear-assignment instance losses (counterpart of
``pagnerf_tpu/losses/lin_assignment.py``).

Per image: a (label x slot) cost from the mean rendered slot probability
under each ground-truth label, a minimum-cost matching of labels to slots
(``ops/assignment.lap_assign``, on the host), and an NLL toward the matched
"virtual" labels wherever a pixel disagrees. In the 'things' variant slot 0
is reserved for stuff and the optional repeated-ID rejection penalises
slots outside a band that each instance's world-x position allows; the
plain variant matches every label over all pixels.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.assignment import lap_assign
from .photometric import safe_prob_log


def one_hot(labels: torch.Tensor, num: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: rows of labels outside [0, num) are all zero."""
    return (labels[:, None] == torch.arange(num, device=labels.device)).to(dtype)


def hungarian_assign(cost: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``hungarian_assign`` contract on the host: NaN and
    infinities mapped into [-1e12, 1e12], then the exact assignment."""
    cost = torch.clamp(torch.nan_to_num(cost.float()), -1e12, 1e12)
    return lap_assign(cost, present)


def centers_from_points_with_labels(points: torch.Tensor, labels: torch.Tensor,
                                    weights: torch.Tensor,
                                    num_labels: int) -> torch.Tensor:
    """Mean 3-D position per label id. points [N, 3], labels [N], weights [N]
    validity -> centers [K, 3]."""
    oh = one_hot(labels, num_labels, points.dtype) * weights[:, None]
    counts = oh.sum(0)
    sums = oh.T @ points
    return sums / torch.clamp(counts[:, None], min=1e-6)


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


def _label_slot_cost(probs: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, num_labels: int):
    """cost[l, m] = -mean over pixels of label l of probs[., m]; returns
    (cost [K, M], present [K])."""
    oh = one_hot(labels, num_labels, probs.dtype) * valid[:, None]
    counts = oh.sum(0)
    cost = -(oh.T @ probs) / (counts[:, None] + 1e-4)
    return cost, counts > 0


def lin_assignment_things_loss(probs: torch.Tensor, labels: torch.Tensor,
                               stuff_mask: torch.Tensor, num_labels: int,
                               points_3d: Optional[torch.Tensor] = None,
                               outlier_rejection: bool = False) -> torch.Tensor:
    """probs [B, R, M] softmaxed slot probabilities; labels [B, R] instance
    ids; stuff_mask [B, R] bool; points_3d [B, R, 3] world points for the
    rejection cost. Returns the per-pixel loss map [B, R]. The matching is
    made on detached probabilities (it is integer-valued); the NLL carries
    the gradient."""
    out = []
    for b in range(probs.shape[0]):
        p, gt, stuff = probs[b], labels[b].to(torch.int64), stuff_mask[b]
        in_range = gt < num_labels
        things_mask = (gt > 0) & in_range
        valid = (stuff | things_mask) & in_range
        things_valid = things_mask.to(p.dtype)
        with torch.no_grad():
            cost, present = _label_slot_cost(p[:, 1:], gt, things_valid, num_labels)
            present = present & (torch.arange(num_labels, device=p.device) > 0)
            if outlier_rejection:
                pts = (points_3d[b] if points_3d is not None
                       else torch.zeros(p.shape[0], 3, dtype=p.dtype, device=p.device))
                centers = centers_from_points_with_labels(
                    pts, gt, things_valid, num_labels)
                cost = add_position_id_range_cost(cost, centers[:, 0], present)
            assign = hungarian_assign(cost, present)                  # [K]
            virt = torch.where(things_mask,
                               assign[torch.clamp(gt, 0, num_labels - 1)] + 1, 0)
            pred = torch.argmax(p, dim=-1)
            any_wrong = torch.any((virt != pred) & valid)
        nll = -torch.gather(safe_prob_log(p), 1, virt[:, None])[:, 0]
        out.append(torch.where(valid & any_wrong, nll, 0.0))
    return torch.stack(out)


def lin_assignment_loss(probs: torch.Tensor, labels: torch.Tensor,
                        num_labels: int) -> torch.Tensor:
    """The plain linear-assignment loss: per image, labels matched to slots
    over all pixels, an NLL toward the virtual labels if any pixel
    disagrees, averaged over the images. probs [B, R, M] softmaxed, labels
    [B, R]. Labels at or past ``num_labels`` add nothing. The reference
    builds the cost from a second softmax of the probabilities (the NLL
    reads them as they are), which can move the optimum in near ties; it is
    kept."""
    out = []
    for p, gt in zip(probs, labels.to(torch.int64)):
        in_range = gt < num_labels
        with torch.no_grad():
            cost, present = _label_slot_cost(torch.softmax(p, dim=-1), gt,
                                             in_range.to(p.dtype), num_labels)
            assign = hungarian_assign(cost, present)                    # [K]
            virt = assign[torch.clamp(gt, 0, num_labels - 1)].to(torch.int64)
            any_wrong = torch.any((virt != torch.argmax(p, dim=-1)) & in_range)
        nll = -torch.gather(safe_prob_log(p), 1, virt[:, None])[:, 0]
        nll = torch.where(in_range, nll, 0.0)
        denom = torch.clamp(in_range.sum(), min=1)
        out.append(torch.where(any_wrong, nll.sum() / denom, 0.0))
    return torch.stack(out).mean()
