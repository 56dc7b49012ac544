"""The exact assignment of the instance losses, by SciPy's
``linear_sum_assignment`` on the host: rows are ground-truth instances, columns
embedding channels; a minimum-cost matching of the present rows."""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def lap_assign(cost: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """cost [B, K, M], present [B, K] -> [B, K] int64: each present row's
    column (the first M present rows of an image take part), 0 elsewhere."""
    c = cost.detach().float().cpu().numpy()
    p = present.detach().cpu().numpy().astype(bool)
    out = np.zeros(c.shape[:2], np.int64)
    for b in range(c.shape[0]):
        rows = np.nonzero(p[b])[0][:c.shape[2]]
        if len(rows):
            r, col = linear_sum_assignment(c[b][rows].astype(np.float64))
            out[b, rows[r]] = col
    return torch.from_numpy(out).to(cost.device)
