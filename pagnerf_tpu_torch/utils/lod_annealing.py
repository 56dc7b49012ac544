"""Level-of-detail weights (counterpart of ``pagnerf_tpu/utils/lod_annealing.py``).

Ported: ``constant_lod_weights``, the all-ones weights of a run without LoD
annealing (the flagship's ``lod_anneling: false``). The tanh annealing window
is not ported yet; ``train.trainer`` refuses a config that asks for it.
"""
from __future__ import annotations

import numpy as np


def constant_lod_weights(num_lods: int, feature_dim: int) -> np.ndarray:
    """All-ones per-feature weights [num_lods * feature_dim], float32."""
    return np.ones(num_lods * feature_dim, dtype=np.float32)
