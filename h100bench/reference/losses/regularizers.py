"""Regularizers (counterpart of ``pagnerf_tpu/losses/regularizers.py``):
the per-segment consistency of rendered labels."""
from __future__ import annotations

import torch

from .lin_assignment import one_hot
from .photometric import safe_prob_log


def segment_consistency_regularizer(probs: torch.Tensor, labels: torch.Tensor,
                                    num_segments: int, group=None) -> torch.Tensor:
    """probs [B, R, C] (softmaxed), labels [B, R] segment ids in
    [0, num_segments). For each segment, its most-voted predicted id other
    than 0 (or 0 if background has more than twice its votes) is the target
    of every pixel's NLL; averaged per segment, per image, over the batch.
    Under a data-parallel ``group`` the votes and the segment sizes are
    summed over the ranks first, and the result is this rank's share."""
    b, _, c = probs.shape
    seg = one_hot(labels.reshape(-1).to(torch.int64), num_segments,
                  probs.dtype).reshape(b, -1, num_segments)             # [B, R, K]
    with torch.no_grad():
        pred_oh = one_hot(torch.argmax(probs, dim=-1).reshape(-1), c,
                          probs.dtype).reshape(b, -1, c)               # [B, R, C]
        bins = seg.transpose(1, 2) @ pred_oh                            # [B, K, C]
        seg_counts = seg.sum(1)                                         # [B, K]
        if group is not None:
            raise NotImplementedError("the reference runs in one process")
            both = all_reduce(torch.cat([bins.reshape(b, -1), seg_counts], dim=1),
                              group, "segment_votes")
            bins = both[:, :-num_segments].reshape(b, num_segments, c)
            seg_counts = both[:, -num_segments:]
        present = seg_counts > 0
        best = torch.argmax(bins[..., 1:], dim=-1) + 1
        best_votes = torch.gather(bins, 2, best[..., None])[..., 0]
        best = torch.where(bins[..., 0] * 0.5 > best_votes, 0, best)
    per_image = []
    for i in range(b):
        tgt_logp = seg[i].T @ safe_prob_log(probs[i])                  # [K, C]
        nll = -torch.gather(tgt_logp, 1, best[i][:, None])[:, 0]
        nll = nll / torch.clamp(seg_counts[i], min=1.0)
        n_present = torch.clamp(present[i].sum(), min=1)
        per_image.append(torch.sum(torch.where(present[i], nll, 0.0)) / n_present)
    return torch.mean(torch.stack(per_image))




