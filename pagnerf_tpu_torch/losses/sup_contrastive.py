"""Supervised contrastive instance loss (counterpart of
``pagnerf_tpu/losses/sup_contrastive.py``): SupCon with the reference's
positive / negative weighting by ``pn_ratio`` and per-image anchor masks.
The anchor mask enters as weights; the similarity is one ``[R, R]`` matmul
per image."""
from __future__ import annotations

from typing import Optional

import torch


def sup_contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                         anchor_mask: Optional[torch.Tensor] = None,
                         temperature: float = 0.07, base_temperature: float = 0.07,
                         pn_ratio: float = 0.5) -> torch.Tensor:
    """features [B, R, D], labels [B, R], anchor_mask [B, R] bool (the pixels
    that may be anchors and contrast elements). Returns the loss summed over
    the valid anchors that have a positive, divided by the total anchor
    count. An image with no two masked-in pixels of different labels adds
    nothing; an image whose pixels are all masked stays finite, in the
    backward too."""
    pos_w = min(1.0, pn_ratio * 2.0)
    neg_w = min(1.0, (1.0 - pn_ratio) * 2.0)
    if anchor_mask is None:
        anchor_mask = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    feats = features / (torch.linalg.norm(features, dim=-1, keepdim=True) + 1e-12)
    sums, counts = [], []
    for x, lab, am in zip(feats, labels, anchor_mask):
        amf = am.to(x.dtype)                                      # [R]
        sim = (x @ x.T) / temperature                             # [R, R]
        # the row max over the masked-in columns, detached; a row with none
        # takes 0, not the dtype's lowest value (exp would overflow)
        neg_inf = torch.finfo(x.dtype).min
        with torch.no_grad():
            row_max = torch.where(am[None, :], sim, neg_inf).max(dim=1, keepdim=True).values
            row_max = torch.where(row_max <= neg_inf / 2, 0.0, row_max)
        logits = sim - row_max
        same = (lab[:, None] == lab[None, :]).to(x.dtype)
        eye = torch.eye(lab.shape[0], dtype=x.dtype, device=x.device)
        logits_mask = (1.0 - eye) * amf[None, :]                  # no self, no masked
        pos_mask = same * logits_mask
        exp_logits = torch.exp(logits) * logits_mask
        log_prob = pos_w * logits - neg_w * torch.log(exp_logits.sum(1, keepdim=True) + 1e-16)
        mean_log_prob_pos = (pos_mask * log_prob).sum(1) / (pos_mask.sum(1) + 1e-16)
        loss = -(temperature / base_temperature) * mean_log_prob_pos
        diff_pair = (lab[:, None] != lab[None, :]) & (am[:, None] & am[None, :])
        img_ok = diff_pair.any().to(x.dtype)
        w = amf * (pos_mask.sum(1) > 0).to(x.dtype) * img_ok
        sums.append(torch.sum(loss * w))
        counts.append(torch.sum(amf))
    return torch.stack(sums).sum() / torch.clamp(torch.stack(counts).sum(), min=1.0)
