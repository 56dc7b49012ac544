"""Multiresolution hash encoding (counterpart of
``pagnerf_tpu/ops/hash_encoding.py``).

Per level of resolution ``r`` a coordinate ``x`` in [-1, 1] falls in the voxel
of the ``(r + 1)^3`` lattice whose bottom-left corner is ``floor((x + 1) * r /
2)``; its 8 corners are hashed into a table of ``2^log2_table_size`` rows
(XOR of the coordinates times primes, uint32 wraparound) and weighted
trilinearly. The index math is plain PyTorch, as the JAX package computes it
in XLA outside any kernel; the gather of the 8 corners' features and its
backward (the table-gradient scatter and dbary) are the kernels of
``ops/table_gather.py`` at V = 8.

Exactness. The hash is computed in int64: a corner coordinate is at most
``r + 1`` and a prime below 2^32, so every product is below 2^42 and exact,
and the low bits of the XOR of the products are the uint32 hash's. The
weights repeat the JAX package's float32 operations in its order: ``cell =
(x + 1) * (r / 2)``, ``frac = cell - floor(cell)``, ``(w0 * w1) * w2``. The
corners are in zyx bit order: corner ``b`` is ``(b >> 2 & 1, b >> 1 & 1, b &
1)``.

Gradients: the tables' through the gather's scatter; the coordinates'
through the weights (``floor`` carries none) and dbary. The dual encode's B
side reads detached weights, so it carries no coordinate gradient.

Under ``PAGNERF_BF16_GATHER=1`` the gathers read float32 tables as rows
rounded to bfloat16 and dbary reads the same rows (``ops/table_gather.py``);
weights, features and table gradients stay float32.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import table_gather

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


def _spatial_hash_T(corner_idx: torch.Tensor, log2_table_size: int) -> torch.Tensor:
    """Corner coordinates [3, ...] (integers >= 0) -> int32 table rows [...]."""
    c = corner_idx.to(torch.int64)
    h = (c[0] * _PRIMES[0]) ^ (c[1] * _PRIMES[1]) ^ (c[2] * _PRIMES[2])
    return (h & ((1 << log2_table_size) - 1)).to(torch.int32)


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


# Accumulation of the table-gradient scatter per hash level, by the number of
# lattice corners (r + 1)^3 the level can address. Measured on the card at
# panoptic_nerf.yaml's microbatch (14 levels of 2^19 rows, resolutions 16 ->
# 512, N = 1,048,576; PERF.md): up to HASH_WINDOW_MIN_CORNERS (2^21, levels
# 0-7 there) a row takes hundreds to ~5e4 events from as many segments, so
# float32 rows would be redone in float64; GLOBAL's warp runs of one voxel
# merge as well as a window there and cost less. Beyond, consecutive samples
# cross into neighbouring voxels and share corners in other vertex slots,
# rows take at most ~70 flushes, and WINDOW merges them (1.4-2.6x fewer
# atomics than GLOBAL or FLOAT there).
HASH_WINDOW_MIN_CORNERS = 1 << 21


def scatter_modes(resolutions, capacity: int) -> Tuple[int, ...]:
    """The table-gradient scatter's mode per level of a hash grid (of
    ``capacity`` rows; the modes do not depend on it): GLOBAL up to
    ``HASH_WINDOW_MIN_CORNERS`` corners, WINDOW beyond. The choice moves
    time, never the scatter's accuracy contract."""
    return tuple(table_gather.GLOBAL if (int(r) + 1) ** 3 <= HASH_WINDOW_MIN_CORNERS
                 else table_gather.WINDOW for r in np.asarray(resolutions))


def hash_encode_T(tables: torch.Tensor, coordsT: torch.Tensor,
                  resolutions: Sequence[int] | np.ndarray,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """coords [3, N] in [-1, 1] against hash tables [L, T, F] -> features
    [L*F, N] (the levels' features concatenated), in ``compute_dtype``."""
    num_levels, table_size, feat_dim = tables.shape
    log2_t = int(np.log2(table_size))
    assert (1 << log2_t) == table_size, "table size must be a power of two"
    idx, w = hash_indices(coordsT, resolutions, log2_t)
    out = table_gather.multilevel_table_gather(
        tables.to(compute_dtype), idx, w.to(compute_dtype).contiguous(),
        modes=scatter_modes(resolutions, table_size))
    return out.reshape(num_levels * feat_dim, -1)


def hash_encode_dual_T(tables_a: torch.Tensor, tables_b: torch.Tensor,
                       coordsT: torch.Tensor, resolutions: Sequence[int] | np.ndarray,
                       compute_dtype=torch.float32):
    """Two same-spec table stacks at one shared lattice (the delta grid's
    fused encode) -> (featsA, featsB), each [L*F, N]; one dual gather, whose
    backward scatters both tables' gradients from one event stream and
    takes the coordinates' gradient from the A side only."""
    num_levels, table_size, feat_dim = tables_a.shape
    assert tables_b.shape == tables_a.shape, "dual encode needs same-spec tables"
    log2_t = int(np.log2(table_size))
    idx, w = hash_indices(coordsT, resolutions, log2_t)
    out_a, out_b = table_gather.dual_multilevel_table_gather(
        tables_a.to(compute_dtype), tables_b.to(compute_dtype), idx,
        w.to(compute_dtype).contiguous(), modes=scatter_modes(resolutions, table_size))
    return (out_a.reshape(num_levels * feat_dim, -1),
            out_b.reshape(num_levels * feat_dim, -1))


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
