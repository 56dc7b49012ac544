"""Regularizers (counterpart of ``pagnerf_tpu/losses/regularizers.py``).

Ported: ``segment_consistency_regularizer``. The sparsity and grid TV losses
are not ported yet; ``train.trainer`` refuses a config that asks for them.
"""
from __future__ import annotations

import torch

from .lin_assignment import one_hot
from .photometric import safe_prob_log


def segment_consistency_regularizer(probs: torch.Tensor, labels: torch.Tensor,
                                    num_segments: int) -> torch.Tensor:
    """probs [B, R, C] (softmaxed), labels [B, R] segment ids in
    [0, num_segments). For each segment, its most-voted predicted id other
    than 0 (or 0 if background has more than twice its votes) is the target
    of every pixel's NLL; averaged per segment, per image, over the batch."""
    per_image = []
    for p, lab in zip(probs, labels):
        c = p.shape[-1]
        seg = one_hot(lab.to(torch.int64), num_segments, p.dtype)       # [R, K]
        seg_counts = seg.sum(0)
        present = seg_counts > 0
        with torch.no_grad():
            pred_oh = one_hot(torch.argmax(p, dim=-1), c, p.dtype)      # [R, C]
            bins = seg.T @ pred_oh                                      # [K, C]
            best = torch.argmax(bins[:, 1:], dim=-1) + 1
            best_votes = torch.gather(bins, 1, best[:, None])[:, 0]
            best = torch.where(bins[:, 0] * 0.5 > best_votes, 0, best)
        tgt_logp = seg.T @ safe_prob_log(p)                             # [K, C]
        nll = -torch.gather(tgt_logp, 1, best[:, None])[:, 0]
        nll = nll / torch.clamp(seg_counts, min=1.0)
        n_present = torch.clamp(present.sum(), min=1)
        per_image.append(torch.sum(torch.where(present, nll, 0.0)) / n_present)
    return torch.mean(torch.stack(per_image))
