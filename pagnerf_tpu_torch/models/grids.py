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

from ..ops.hash_encoding import _CORNERS, HashEncodingSpec
from ..ops.permuto_encoding import PermutoEncodingSpec

_INIT_SCALE = 1e-4


def _uniform_(param: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``uniform(scale)``: [0, scale)."""
    with torch.no_grad():
        param.copy_(torch.rand(param.shape, generator=generator) * _INIT_SCALE)


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


class TriplanarGrid(nn.Module):
    """Three axis-aligned feature planes per level, bilinear; level ``lod``
    has resolution ``2^(base_lod + lod)``. Parameters ``planes_{lod}``
    [3, F, R*R] (plane p spans the two axes other than p)."""

    def __init__(self, num_lods: int = 4, feature_dim: int = 8, base_lod: int = 5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_lods, self.feature_dim, self.base_lod = num_lods, feature_dim, base_lod
        self.compute_dtype = compute_dtype
        for lod in range(num_lods):
            res = 1 << (base_lod + lod)
            self.register_parameter(f"planes_{lod}",
                                    nn.Parameter(torch.zeros(3, feature_dim, res * res)))

    @property
    def output_dim(self) -> int:
        return self.num_lods * self.feature_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lod in range(self.num_lods):
            _uniform_(getattr(self, f"planes_{lod}"), generator)

    def forward(self, coordsT: torch.Tensor) -> torch.Tensor:
        outs = []
        for lod in range(self.num_lods):
            res = 1 << (self.base_lod + lod)
            planes = getattr(self, f"planes_{lod}")
            feats = 0.0
            for p, (a, b) in enumerate(((1, 2), (0, 2), (0, 1))):
                u = (coordsT[a] + 1.0) * 0.5 * (res - 1)                     # [N]
                v = (coordsT[b] + 1.0) * 0.5 * (res - 1)
                u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, res - 2)
                v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, res - 2)
                fu, fv = u - u0, v - v0

                def tap(du, dv, p=p, u0=u0, v0=v0):
                    return planes[p][:, (u0 + du) * res + (v0 + dv)]            # [F, N]
                feats = feats + (tap(0, 0) * (1 - fu) * (1 - fv)
                                 + tap(1, 0) * fu * (1 - fv)
                                 + tap(0, 1) * (1 - fu) * fv
                                 + tap(1, 1) * fu * fv)
            outs.append(feats.to(self.compute_dtype))
        return torch.cat(outs, dim=0)                                          # [L*F, N]


class DenseGrid(nn.Module):
    """Dense feature volumes, trilinear; level ``lod`` has resolution
    ``res = 2^(base_lod + lod)`` and a table ``table_{lod}`` of the
    ``(res + 1)^3`` lattice corners (row ``(z * (res + 1) + y) * (res + 1) +
    x``), padded to a multiple of ``128 // F`` rows as the JAX package pads
    it for its lane-packed gather."""

    def __init__(self, num_lods: int = 4, feature_dim: int = 4, base_lod: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_lods, self.feature_dim, self.base_lod = num_lods, feature_dim, base_lod
        self.compute_dtype = compute_dtype
        epr = max(128 // feature_dim, 1)
        for lod in range(num_lods):
            res = 1 << (base_lod + lod)
            entries = -(-((res + 1) ** 3) // epr) * epr
            self.register_parameter(f"table_{lod}",
                                    nn.Parameter(torch.zeros(entries, feature_dim)))

    @property
    def output_dim(self) -> int:
        return self.num_lods * self.feature_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lod in range(self.num_lods):
            _uniform_(getattr(self, f"table_{lod}"), generator)

    def forward(self, coordsT: torch.Tensor) -> torch.Tensor:
        corners = torch.as_tensor(_CORNERS.T, device=coordsT.device)           # [3, 8]
        x = torch.clamp(coordsT, -1, 1)
        outs = []
        for lod in range(self.num_lods):
            res = 1 << (self.base_lod + lod)
            table = getattr(self, f"table_{lod}").to(self.compute_dtype)
            cell = (x + 1.0) * (res / 2.0)                                     # [3, N]
            bl = torch.floor(cell)
            frac = cell - bl
            c = torch.clamp(bl.detach().to(torch.int64)[:, None, :] + corners[:, :, None],
                            0, res)                                            # [3, 8, N]
            idx = (c[0] * (res + 1) + c[1]) * (res + 1) + c[2]                 # [8, N]
            w = torch.where(corners[:, :, None].bool(), frac[:, None, :],
                            1.0 - frac[:, None, :])
            w = (w[0] * w[1] * w[2]).to(self.compute_dtype)                   # [8, N]
            feats = table[idx]                                                 # [8, N, F]
            outs.append(torch.sum(feats * w[..., None], dim=0).t())            # [F, N]
        return torch.cat(outs, dim=0)


def build_grid(grid_type: str, **kwargs) -> nn.Module:
    """Grid type name -> grid module, with the JAX registry's aliases: the
    hash grid's ``HashGridTorch``, ``HashGridTinyCudaNN`` and
    ``CodebookOctreeGrid``, the dense grid's ``OctreeGrid`` and ``Occtree``,
    and ``TensoRF``. ``kwargs`` a grid does not take are dropped."""
    import inspect

    from .tensorf import TensoRFGrid
    table = {"PermutoGrid": PermutoGrid, "HashGrid": HashGrid, "HashGridTorch": HashGrid,
             "HashGridTinyCudaNN": HashGrid, "TriplanarGrid": TriplanarGrid,
             "TensoRF": TensoRFGrid, "OctreeGrid": DenseGrid,
             "CodebookOctreeGrid": HashGrid, "Occtree": DenseGrid}
    if grid_type not in table:
        raise NotImplementedError(f"grid type '{grid_type}' not supported")
    cls = table[grid_type]
    valid = set(inspect.signature(cls.__init__).parameters) - {"self"}
    return cls(**{k: v for k, v in kwargs.items() if k in valid})
