"""Supervised contrastive instance loss (counterpart of
``pagnerf_tpu/losses/sup_contrastive.py``): SupCon with the reference's
positive / negative weighting by ``pn_ratio`` and per-image anchor masks.
The anchor mask enters as weights; the similarity is one ``[R, R]`` matmul
per image.

Under ray-axis data parallelism (``group``, ``parallel/sharding.py``) a
rank holds ``R / n`` rays of each image: it gathers the image's normalised
features, labels and mask over the ranks (``sharding.all_gather_rays``,
whose backward reduce-scatters the columns' gradient) and computes the rows
of its own anchors against every column, ``[R / n, R]``: the row max, the
log-sum-exp, the positives and the image's gate run over the gathered
columns, and its anchors' sum is divided by the global anchor count. The
ranks' losses sum to the one-process loss, and their gradients, summed, to
its gradients.
"""
from __future__ import annotations

from typing import Optional

import torch



def sup_contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                         anchor_mask: Optional[torch.Tensor] = None,
                         temperature: float = 0.07, base_temperature: float = 0.07,
                         pn_ratio: float = 0.5, group=None,
                         tag: str = "supcon") -> torch.Tensor:
    """features [B, R, D], labels [B, R], anchor_mask [B, R] bool (the pixels
    that may be anchors and contrast elements). Returns the loss summed over
    the valid anchors that have a positive, divided by the total anchor
    count. An image with no two masked-in pixels of different labels adds
    nothing; an image whose pixels are all masked stays finite, in the
    backward too. Under a data-parallel ``group`` the inputs are this
    rank's rays and the result is its share of the global loss (module
    docstring); the gathers are logged as ``tag``."""
    pos_w = min(1.0, pn_ratio * 2.0)
    neg_w = min(1.0, (1.0 - pn_ratio) * 2.0)
    masked = anchor_mask is not None
    if not masked:
        anchor_mask = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    feats = features / (torch.linalg.norm(features, dim=-1, keepdim=True) + 1e-12)
    cols, col_labels, col_mask, first = feats, labels, anchor_mask, 0
    rows = torch.arange(labels.shape[1], device=labels.device) + first
    sums, counts = [], []
    for x, c, lab, clab, am, cam in zip(feats, cols, labels, col_labels, anchor_mask,
                                        col_mask):
        amf, camf = am.to(x.dtype), cam.to(x.dtype)               # [r], [R]
        sim = (x @ c.T) / temperature                             # [r, R]
        # the row max over the masked-in columns, detached; a row with none
        # takes 0, not the dtype's lowest value (exp would overflow)
        neg_inf = torch.finfo(x.dtype).min
        with torch.no_grad():
            row_max = torch.where(cam[None, :], sim, neg_inf).max(dim=1, keepdim=True).values
            row_max = torch.where(row_max <= neg_inf / 2, 0.0, row_max)
        logits = sim - row_max
        same = (lab[:, None] == clab[None, :]).to(x.dtype)
        eye = (rows[:, None] == torch.arange(clab.shape[0], device=x.device)[None, :]
               ).to(x.dtype)
        logits_mask = (1.0 - eye) * camf[None, :]                 # no self, no masked
        pos_mask = same * logits_mask
        exp_logits = torch.exp(logits) * logits_mask
        log_prob = pos_w * logits - neg_w * torch.log(exp_logits.sum(1, keepdim=True) + 1e-16)
        mean_log_prob_pos = (pos_mask * log_prob).sum(1) / (pos_mask.sum(1) + 1e-16)
        loss = -(temperature / base_temperature) * mean_log_prob_pos
        diff_pair = (clab[:, None] != clab[None, :]) & (cam[:, None] & cam[None, :])
        img_ok = diff_pair.any().to(x.dtype)
        w = amf * (pos_mask.sum(1) > 0).to(x.dtype) * img_ok
        sums.append(torch.sum(loss * w))
        counts.append(torch.sum(camf))
    return torch.stack(sums).sum() / torch.clamp(torch.stack(counts).sum(), min=1.0)
