"""Ray bundle (counterpart of ``pagnerf_tpu/core/rays.py``).

A dataclass of tensors: origins and directions ``[..., 3]`` plus the near and
far clipping distances (scalars or broadcastable tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass
class Rays:
    origins: torch.Tensor      # [..., 3]
    dirs: torch.Tensor         # [..., 3], unit norm by convention
    dist_min: Scalar
    dist_max: Scalar

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.origins.shape[:-1])

    @property
    def num_rays(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def reshape(self, *shape: int) -> "Rays":
        """Reshape the ray axes; the trailing vector axis of 3 is kept."""
        return dataclasses.replace(self, origins=self.origins.reshape(*shape, 3),
                                   dirs=self.dirs.reshape(*shape, 3))
