"""Feature grids (counterpart of ``pagnerf_tpu/models/grids.py``).

Ported: ``PermutoGrid``. The hash, triplanar, dense and TensoRF grids are not
ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.permuto_encoding import PermutoEncodingSpec


class PermutoGrid(nn.Module):
    """Permutohedral encoding grid: coordsT [3, N] -> features [L*F, N] in
    ``compute_dtype``. Its parameter ``tables`` is [L, 2^capacity_log2, F]."""

    def __init__(self, num_lods: int = 24, feature_dim: int = 2,
                 capacity_log2: int = 18, coarsest_scale: float = 1.0,
                 finest_scale: float = 0.0001,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = PermutoEncodingSpec(num_lods, feature_dim, capacity_log2,
                                        coarsest_scale, finest_scale)
        self.compute_dtype = compute_dtype
        self.tables = nn.Parameter(torch.zeros(
            num_lods, self.spec.capacity, feature_dim))

    @property
    def output_dim(self) -> int:
        return self.spec.output_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.tables.copy_(self.spec.init(generator))

    def forward(self, coordsT: torch.Tensor) -> torch.Tensor:
        return self.spec.encode_T(self.tables, coordsT, self.compute_dtype)
