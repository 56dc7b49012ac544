"""Plain multiresolution hash encoding: the index math of the port's
``ops/hash_encoding.py``, frozen here, with the gather and its gradients
left to autograd (no kernel, no hand-written backward).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# XOR-hash primes
_PRIMES = (1, 2654435761, 805459861)

# the 8 voxel-corner offsets in zyx bit order: index b -> (b>>2&1, b>>1&1, b&1)
_CORNERS = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                    dtype=np.int32)                                  # [8, 3]


def geometric_resolutions(base_resolution: int, finest_resolution: int,
                          num_levels: int) -> np.ndarray:
    """Per-level resolutions floor(base * b^i), b the geometric growth from
    base to finest over the levels."""
    if num_levels == 1:
        return np.array([base_resolution], dtype=np.int32)
    b = np.exp((np.log(finest_resolution) - np.log(base_resolution)) / (num_levels - 1))
    return np.floor(base_resolution * b ** np.arange(num_levels)).astype(np.int32)


def init_hash_table(generator: torch.Generator, num_levels: int, table_size: int,
                    feature_dim: int, init_std: float = 1e-4,
                    device="cpu") -> torch.Tensor:
    """[L, T, F] float32 tables, uniform in [-init_std, init_std)."""
    t = torch.rand((num_levels, table_size, feature_dim), generator=generator,
                   device=device)
    return t * (2 * init_std) - init_std


def hash_indices(coordsT: torch.Tensor, resolutions, log2_table_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """coordsT [3, N] -> (idx [L, 8, N] int32, weights [L, 8, N] float32), the
    weights differentiable in the coordinates. Each axis's two corner
    coordinates and weights are formed once and combined by broadcasting
    over the 2 x 2 x 2 corners (the JAX package forms the [3, 8, N] corners;
    the values are the same)."""
    res = torch.as_tensor(np.asarray(resolutions, np.float32), device=coordsT.device)
    x = torch.clamp(coordsT.float(), -1.0, 1.0)                       # [3, N]
    n = x.shape[1]
    cell = (x[None] + 1.0) * (res / 2.0)[:, None, None]                # [L, 3, N]
    bl = torch.floor(cell)
    frac = cell - bl
    b = bl.detach().to(torch.int64)
    mask = (1 << log2_table_size) - 1
    # per axis the masked product of the corner's 0 and 1 offsets [L, 2, N]:
    # the low bits of a XOR are the XOR of the low bits
    hx, hy, hz = (((torch.stack([b[:, a], b[:, a] + 1], dim=1) * _PRIMES[a]) & mask
                   ).to(torch.int32) for a in range(3))
    idx = (hx[:, :, None, None] ^ hy[:, None, :, None] ^ hz[:, None, None, :]
           ).reshape(-1, 8, n)
    # per axis (1 - frac, frac) [L, 2, N], multiplied in the order w0 * w1 * w2
    wx, wy, wz = (torch.stack([1.0 - frac[:, a], frac[:, a]], dim=1) for a in range(3))
    w = (wx[:, :, None, None] * wy[:, None, :, None]) * wz[:, None, None, :]
    return idx, w.reshape(-1, 8, n)


def hash_encode_levels(tables, coordsT, resolutions, compute_dtype=torch.float32):
    """Each of ``tables`` ([L, T, F]) at coords [3, N] -> features [L*F, N]
    a table: the 8 corners' rows weighted in float32, summed, rounded once.
    The coordinates' gradient comes from the first table only."""
    l, t, f = tables[0].shape
    idx, w = hash_indices(coordsT, resolutions, int(np.log2(t)))
    outs = []
    for k, tab in enumerate(tables):
        tab = tab.to(compute_dtype)
        ww = (w if k == 0 else w.detach()).to(compute_dtype).float()
        per = []
        for lvl in range(l):
            rows = tab[lvl][idx[lvl].to(torch.int64)].float()          # [8, N, F]
            per.append(torch.sum(rows * ww[lvl][..., None], dim=0).t().to(compute_dtype))
        outs.append(torch.cat(per, dim=0))
    return tuple(outs)


def hash_encode_T(tables, coordsT, resolutions, compute_dtype=torch.float32):
    return hash_encode_levels((tables,), coordsT, resolutions, compute_dtype)[0]


def hash_encode_dual_T(tables_a, tables_b, coordsT, resolutions, compute_dtype=torch.float32):
    return hash_encode_levels((tables_a, tables_b), coordsT, resolutions, compute_dtype)


class HashEncodingSpec:
    """Static spec of a hash grid: level count, feature width, table size
    2^log2_table_size and the geometric resolutions base -> finest."""

    def __init__(self, num_levels: int = 16, feature_dim: int = 2,
                 log2_table_size: int = 19, base_resolution: int = 16,
                 finest_resolution: int = 512):
        self.num_levels = num_levels
        self.feature_dim = feature_dim
        self.log2_table_size = log2_table_size
        self.table_size = self.capacity = 1 << log2_table_size
        self.resolutions = geometric_resolutions(base_resolution, finest_resolution,
                                                 num_levels)
        self.output_dim = num_levels * feature_dim

    def init(self, generator: torch.Generator, device="cpu") -> torch.Tensor:
        return init_hash_table(generator, self.num_levels, self.table_size,
                               self.feature_dim, device=device)

    def encode_T(self, tables, coordsT, compute_dtype=torch.float32):
        return hash_encode_T(tables, coordsT, self.resolutions, compute_dtype)

    def encode_dual_T(self, tables_a, tables_b, coordsT, compute_dtype=torch.float32):
        return hash_encode_dual_T(tables_a, tables_b, coordsT, self.resolutions,
                                  compute_dtype)
