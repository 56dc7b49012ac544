"""Level-of-detail weights (counterpart of ``pagnerf_tpu/utils/lod_annealing.py``).

``lod_weights`` is the coarse-to-fine annealing window: a tanh over the
levels that opens as training goes on, computed in float64 and returned as
float32, one weight per feature. The trainer sets it once per epoch from the
global step (``lod_anneling``); the NeF multiplies the grid features by it.
``constant_lod_weights`` is the all-ones weights of a run without annealing.
"""
from __future__ import annotations

import numpy as np


def lod_weights(step: int, num_lods: int, feature_dim: int, epochs: int,
                steps_per_epoch: int, base_lod: int = 0, max_lod: int = -1,
                spread: float = 1.0) -> np.ndarray:
    """Per-feature LoD weights [num_lods * feature_dim] at ``step``, with the
    window over ``epochs * steps_per_epoch`` steps."""
    max_lod = list(range(num_lods))[max_lod]
    num_levels = max_lod - base_lod
    total_steps = max(epochs * steps_per_epoch, 1)
    decay_pt = num_levels * step / total_steps
    x = np.arange(num_levels + 1, dtype=np.float64)
    window = 0.5 * (1.0 - np.tanh(4.0 * (x * spread - 0.5 - decay_pt)))
    w = np.ones(num_lods, dtype=np.float32)
    w[base_lod:] = window.astype(np.float32)
    return np.repeat(w, feature_dim)


def constant_lod_weights(num_lods: int, feature_dim: int) -> np.ndarray:
    """All-ones per-feature weights [num_lods * feature_dim], float32."""
    return np.ones(num_lods * feature_dim, dtype=np.float32)
