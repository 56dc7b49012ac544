"""Dense occupancy grid (counterpart of ``pagnerf_tpu/ops/occupancy.py``).

A ``2^level``-per-axis bitmask over the [-1, 1]^3 scene cube, flattened, plus
the float density accumulator the prune updates: one jittered point per cell
(``cell_centers_jittered_T``) is queried for density, and
``update_from_density`` decays the accumulator, takes the max with the new
density and re-thresholds the mask (optionally ANDed with the current mask
and dilated).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch
import torch.nn.functional as F

# The reference's prune constants (the JAX package's ``DENSITY_DECAY`` and
# ``MIN_DENSITY``).
DENSITY_DECAY = 0.6
MIN_DENSITY = (0.01 * 512) / (3.0 ** 0.5)


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

    def cell_centers_jittered_T(self, jitter: Union[torch.Generator, torch.Tensor]
                                ) -> torch.Tensor:
        """One uniformly jittered point per cell, feature-major [3, res^3] in
        [-1, 1]^3, ordered as ``cell_indices_T`` flattens cells. ``jitter`` is
        a [3, res^3] tensor of uniforms in [0, 1) (the JAX package draws it
        from its key) or a generator to draw one from."""
        res = self.res
        dev = self.mask.device
        if isinstance(jitter, torch.Generator):
            jitter = torch.rand((3, res ** 3), generator=jitter, device=dev)
        elif tuple(jitter.shape) != (3, res ** 3):
            raise ValueError(f"jitter must be [3, {res ** 3}], got {tuple(jitter.shape)}")
        ar = torch.arange(res, device=dev)
        ijk = torch.stack([g.reshape(-1) for g in
                           torch.meshgrid(ar, ar, ar, indexing="ij")])   # [3, N]
        return (ijk.to(torch.float32) + jitter) / res * 2.0 - 1.0

    def update_from_density(self, density: torch.Tensor, decay: float = DENSITY_DECAY,
                            min_density: float = MIN_DENSITY, dilate: int = 0,
                            monotone: bool = False) -> "OccupancyGrid":
        """occ <- max(occ * decay, density); mask <- occ > min_density, ANDed
        with the current mask when ``monotone`` (cells are only removed), then
        dilated ``dilate`` times by a 3^3 max (a cell next to a kept cell is
        kept). ``density`` is [res^3] in ``cell_centers_jittered_T`` order.
        ``min_density`` compares in float32, as the JAX package's weakly
        typed Python scalar does."""
        new_occ = torch.maximum(self.occupancy * decay, density.reshape(-1))
        mask = new_occ > torch.tensor(min_density, dtype=new_occ.dtype,
                                      device=new_occ.device)
        if monotone:
            mask = mask & self.mask
        if dilate > 0:
            res = self.res
            m = mask.reshape(1, 1, res, res, res).to(torch.float32)
            for _ in range(dilate):
                m = F.max_pool3d(m, kernel_size=3, stride=1, padding=1)
            mask = (m > 0).reshape(-1)
        return OccupancyGrid(occupancy=new_occ, mask=mask, level=self.level)
