"""Photometric and semantic losses (counterpart of
``pagnerf_tpu/losses/photometric.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def rgb_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over rays and the three colour channels."""
    return torch.mean(torch.abs(pred[..., :3] - target[..., :3]))


def safe_prob_log(p: torch.Tensor) -> torch.Tensor:
    """log(p + 1e-27) with p clamped to >= 0 first. A rendered probability
    can come out a hair below zero from float cancellation, and log of a
    negative is NaN, which would poison the panoptic parameters for good; the
    clamp is the identity wherever p >= 0 and passes no gradient below it."""
    return torch.log(torch.clamp(p, min=0.0) + 1e-27)


def semantic_loss(probs_or_logits: torch.Tensor, targets: torch.Tensor,
                  sem_softmax: bool, temperature: float = 1.0,
                  conf: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Per-pixel semantic NLL, mean over valid pixels. probs_or_logits
    [N, C] (probabilities when ``sem_softmax``, else logits); targets [N]
    int; conf [N] optional weights. Targets outside [0, C) add nothing.
    Under a data-parallel ``group`` the valid count is the global one, so
    the result is this rank's share of the global mean."""
    if sem_softmax:
        logp = safe_prob_log(probs_or_logits) / temperature
    else:
        logp = torch.log_softmax(probs_or_logits / temperature, dim=-1)
    num_classes = probs_or_logits.shape[-1]
    valid = (targets >= 0) & (targets < num_classes)
    safe_targets = torch.where(valid, targets, 0).to(torch.int64)
    nll = -torch.gather(logp, 1, safe_targets[:, None])[:, 0]
    nll = torch.where(valid, nll, 0.0)
    if conf is not None:
        nll = nll * conf
    count = valid.sum()
    if group is not None:
        from ..parallel.sharding import all_reduce
        count = all_reduce(count.reshape(1), group, "sem_count")[0]
    return torch.sum(nll) / torch.clamp(count, min=1)
