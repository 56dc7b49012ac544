"""Feature grids (counterpart of ``pagnerf_tpu/models/grids.py``).

Each grid takes coordinates ``coordsT`` [3, N] in [-1, 1] and returns the
levels' features concatenated, ``[num_lods * feature_dim, N]``, in
``compute_dtype``:

- ``PermutoGrid``: the permutohedral lattice (fused encode kernel).
- ``HashGrid``: the multiresolution hash grid (``ops/hash_encoding.py``: the
  index math in PyTorch, the gather kernels at V = 8).
- ``TriplanarGrid``: three axis-aligned feature planes per level, bilinear.
- ``DenseGrid``: a dense ``(res + 1)^3`` volume per level, trilinear.

The triplanar and dense grids are plain PyTorch, as the JAX package computes
them in XLA. ``build_grid`` maps the grid type names of the configs onto
these (and ``TensoRF`` onto ``models/tensorf.TensoRFGrid``), with the JAX
registry's aliases. Seeded inits follow the JAX package's distributions:
uniform [-1e-4, 1e-4) for the lattice and hash tables, flax's
``uniform(1e-4)``, i.e. [0, 1e-4), for the planes and volumes.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.hash_encoding import HashEncodingSpec
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


class HashGrid(nn.Module):
    """Multiresolution hash grid: ``tables`` [L, 2^log2_table_size, F],
    resolutions geometric from ``base_resolution`` to
    ``finest_resolution``."""

    def __init__(self, num_lods: int = 16, feature_dim: int = 2,
                 log2_table_size: int = 19, base_resolution: int = 16,
                 finest_resolution: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = HashEncodingSpec(num_lods, feature_dim, log2_table_size,
                                     base_resolution, finest_resolution)
        self.compute_dtype = compute_dtype
        self.tables = nn.Parameter(torch.zeros(num_lods, self.spec.table_size,
                                               feature_dim))

    @property
    def output_dim(self) -> int:
        return self.spec.output_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.tables.copy_(self.spec.init(generator))

    def forward(self, coordsT: torch.Tensor) -> torch.Tensor:
        return self.spec.encode_T(self.tables, coordsT, self.compute_dtype)


def build_grid(grid_type: str, **kwargs) -> nn.Module:
    """Grid type name -> grid module, with the JAX registry's aliases: the
    hash grid's ``HashGridTorch``, ``HashGridTinyCudaNN`` and
    ``CodebookOctreeGrid``, the dense grid's ``OctreeGrid`` and ``Occtree``,
    and ``TensoRF``. ``kwargs`` a grid does not take are dropped."""
    import inspect

    table = {"PermutoGrid": PermutoGrid, "HashGrid": HashGrid, "HashGridTorch": HashGrid,
             "HashGridTinyCudaNN": HashGrid, "CodebookOctreeGrid": HashGrid}
    if grid_type not in table:
        raise NotImplementedError(f"grid type '{grid_type}' not supported")
    cls = table[grid_type]
    valid = set(inspect.signature(cls.__init__).parameters) - {"self"}
    return cls(**{k: v for k, v in kwargs.items() if k in valid})
