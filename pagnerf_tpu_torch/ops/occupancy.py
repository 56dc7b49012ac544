"""Dense occupancy grid (counterpart of ``pagnerf_tpu/ops/occupancy.py``).

A ``2^level``-per-axis bitmask over the [-1, 1]^3 scene cube, flattened, plus
the float density accumulator the prune updates. The render slice only
creates a fully visible grid and looks cells up; the prune update serves
training and is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

@dataclasses.dataclass
class OccupancyGrid:
    occupancy: torch.Tensor   # [res^3] float32 accumulator
    mask: torch.Tensor        # [res^3] bool visibility
    level: int

    @property
    def res(self) -> int:
        return 1 << self.level

    @staticmethod
    def create(level: int = 7, device="cpu") -> "OccupancyGrid":
        """Fully visible grid with a zero accumulator."""
        res = 1 << level
        return OccupancyGrid(
            occupancy=torch.zeros((res ** 3,), dtype=torch.float32, device=device),
            mask=torch.ones((res ** 3,), dtype=torch.bool, device=device),
            level=level)

    def cell_indices_T(self, coordsT: torch.Tensor) -> torch.Tensor:
        """coordsT [3, ...] in [-1, 1] -> flat cell indices [...] (int64).
        The float -> int conversion truncates toward zero, as the JAX
        package's ``astype(int32)`` does, before the clip."""
        res = self.res
        ijk = torch.clamp(((coordsT + 1.0) * 0.5 * res).to(torch.int32), 0, res - 1)
        ijk = ijk.to(torch.int64)
        return (ijk[0] * res + ijk[1]) * res + ijk[2]

    def _lookup(self, idx: torch.Tensor) -> torch.Tensor:
        """Mask lookup by flat cell index (any shape)."""
        return self.mask[idx.reshape(-1)].reshape(idx.shape)

    def occupied_at_T(self, coordsT: torch.Tensor) -> torch.Tensor:
        """Boolean visibility at world coords [3, ...]."""
        return self._lookup(self.cell_indices_T(coordsT))
