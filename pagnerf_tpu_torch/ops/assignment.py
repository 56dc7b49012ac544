"""Linear assignment on the host (counterpart of
``pagnerf_tpu/ops/assignment.py``).

The JAX package solves the label-to-slot assignment on the device with an
exact Jonker-Volgenant solver, because its TPU runtime has no host
callbacks. On the GPU a host call is allowed, so ``lap_assign`` is
``scipy.optimize.linear_sum_assignment`` over the present rows -- the same
solve as the JAX package's golden reference ``hungarian_host``, which its
tests hold the device solver to. It costs one device-to-host copy of the
small cost matrix per call. ``lap_assign.seconds`` sums the host time spent
here (copy included).
"""
from __future__ import annotations

import time

import numpy as np
import torch


def lap_assign(cost: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Minimum-cost assignment of the present rows of ``cost`` [K, M] to
    distinct columns. At most M present rows take part (the lowest-indexed
    ones, as the reference truncates its labels). Returns the column of each
    row [K] int64 on ``cost``'s device, 0 for rows that take no part."""
    from scipy.optimize import linear_sum_assignment
    t0 = time.perf_counter()
    c = cost.detach().float().cpu().numpy()
    p = present.detach().cpu().numpy().astype(bool)
    out = np.zeros(c.shape[0], np.int64)
    rows = np.nonzero(p)[0][:c.shape[1]]
    if rows.size:
        r_idx, c_idx = linear_sum_assignment(np.nan_to_num(c[rows]))
        out[rows[r_idx]] = c_idx
    result = torch.from_numpy(out).to(cost.device)
    lap_assign.seconds += time.perf_counter() - t0
    return result


lap_assign.seconds = 0.0
