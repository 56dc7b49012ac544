"""Plain permutohedral encoding: the lattice math of the port's
``ops/permuto_encoding.py`` (elevation, rank, simplex, direct and hashed
indices), frozen here, with the gather and its gradients left to autograd:
no kernel, no hand-written backward. The coordinate gradient flows through
the barycentric weights by autograd's own derivative of the lattice math.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import constant

_D = 3            # input dimensionality
_VERTS = _D + 1   # simplex vertices

# Hash primes (first coordinate prime 1 keeps parity with the reference hash family).
_PRIMES = (1, 2654435761, 805459861)


def _elevation_matrix() -> np.ndarray:
    """E: R^3 -> R^4 embedding onto the sum-zero hyperplane, scaled so lattice
    cells have unit size (the canonical elevation recurrence on the basis)."""
    inv_std_dev = np.sqrt(2.0 / 3.0) * _VERTS
    sf = np.array([inv_std_dev / np.sqrt((i + 1) * (i + 2)) for i in range(_D)])
    e = np.zeros((_VERTS, _D))
    for j in range(_D):
        vec = np.zeros(_D)
        vec[j] = sf[j]
        sm = 0.0
        col = np.zeros(_VERTS)
        for i in range(_D, 0, -1):
            cf = vec[i - 1]
            col[i] = sm - i * cf
            sm += cf
        col[0] = sm
        e[:, j] = col
    return e


_E = _elevation_matrix()  # [4, 3]


def _mul_mod32(k: torch.Tensor, prime: int) -> torch.Tensor:
    """(k * prime) mod 2^32 for int64 k in [0, 2^32), without int64 overflow:
    split k into 16-bit halves so every partial product stays below 2^48."""
    lo, hi = k & 0xFFFF, k >> 16
    return (lo * prime + (((hi * prime) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _hash_keys_T(keys: torch.Tensor, log2_capacity: int) -> torch.Tensor:
    """Feature-major hash: int keys [V, 3, N] -> int32 indices [V, N], with the
    uint32 wrap-around of the JAX package (negative keys wrap to 2^32 + k)."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    h = _mul_mod32(k[:, 0], _PRIMES[0])
    h = h ^ _mul_mod32(k[:, 1], _PRIMES[1])
    h = h ^ _mul_mod32(k[:, 2], _PRIMES[2])
    return (h & ((1 << log2_capacity) - 1)).to(torch.int32)


def direct_level_specs(scales, capacity: int, feature_dim: int):
    """Per-level direct (collision-free) indexing spec for coords in [-1, 1]^3.

    Every lattice key coordinate of remainder r is ``4*m + r``, so a level
    whose key box fits the table indexes entries directly as
    ``r*Dm^3 + flatten(m + Mm)``. Returns (Mm[L], Dm[L], direct_mask[L],
    rows_used[L]) exactly as the JAX package does (rows_used counts 128-lane
    rows, which the port does not use but keeps for parity)."""
    bound_base = float(np.abs(_E).sum(axis=1).max())
    mm, dm, mask, rows = [], [], [], []
    for s in np.asarray(scales):
        k_bound = int(np.ceil(bound_base / float(s))) + 8
        m_off = k_bound // 4 + 2
        d = 2 * m_off + 1
        cells = _VERTS * d ** 3
        if cells <= capacity:
            mm.append(m_off); dm.append(d); mask.append(True)
            rows.append(int(np.ceil(cells * feature_dim / 128.0)))
        else:
            mm.append(0); dm.append(1); mask.append(False); rows.append(0)
    return (np.asarray(mm, np.int32), np.asarray(dm, np.int32),
            np.asarray(mask), tuple(rows))


def _rank_from_el(el: torch.Tensor):
    """One level's (gr, rank) from its elevated coords el [4, N]: nearest
    remainder-0 point (wrap-adjusted) and differential rank, ties broken by
    coordinate index."""
    gr = torch.round(el / _VERTS) * _VERTS                        # half to even
    sum_val = torch.sum(gr, dim=0) / _VERTS                       # integer-valued

    diff = el - gr
    di = diff[:, None, :]                                         # coordinate i
    dj = diff[None, :, :]                                         # coordinate j
    idx4 = torch.arange(_VERTS, device=el.device)
    tie = (dj == di) & (idx4[None, :, None] < idx4[:, None, None])
    rank = torch.sum((dj > di) | tie, dim=1).to(torch.int32)      # [4, N]
    rank = rank + sum_val.to(torch.int32)[None, :]

    under = (rank < 0).to(torch.int32)
    over = (rank > _D).to(torch.int32)
    rank = rank + _VERTS * under - _VERTS * over
    gr = gr + _VERTS * under.to(gr.dtype) - _VERTS * over.to(gr.dtype)
    return gr, rank


def _rank_and_el(scaledT: torch.Tensor):
    """One level's (el, gr, rank) from scale-divided coords [3, N]: elevation
    ``el = E @ s``, then ``_rank_from_el``."""
    e = constant(_E, scaledT.dtype, scaledT.device)
    el = e @ scaledT                                              # [4, N]
    gr, rank = _rank_from_el(el)
    return el, gr, rank




def _simplex_from_rank(el: torch.Tensor, gr: torch.Tensor, rank: torch.Tensor):
    """Keys [4, 3, N] and bary [4, N] of the simplex given by el, gr, rank."""
    delta = (el - gr) / _VERTS                                    # [4, N]
    b = torch.arange(_VERTS + 1, dtype=torch.int32,
                     device=el.device)[:, None, None]             # [5, 1, 1]
    plus = ((_D - rank)[None] == b).to(delta.dtype)               # [5, 4, N]
    minus = ((_D + 1 - rank)[None] == b).to(delta.dtype)
    bary = torch.sum((plus - minus) * delta[None], dim=1)         # [5, N]
    bary0 = bary[0] + (1.0 + bary[_VERTS])
    bary = torch.cat([bary0[None], bary[1:_VERTS]])               # [4, N]

    r = torch.arange(_VERTS, dtype=torch.int32,
                     device=el.device)[:, None, None]             # [4, 1, 1]
    gri = gr.to(torch.int32)[None, :_D, :]                        # [1, 3, N]
    ranki = rank[None, :_D, :]
    sub = (ranki > (_D - r)).to(torch.int32) * _VERTS
    keys = gri + r - sub                                          # [4, 3, N]
    return keys, bary


def _index_keys_T(keys: torch.Tensor, log2_capacity: int, mm: int, dm: int,
                  direct: bool) -> torch.Tensor:
    """Direct or hashed table indices for one level: keys [V, 3, N] -> [V, N]."""
    if not direct:
        return _hash_keys_T(keys, log2_capacity)
    r = torch.arange(_VERTS, dtype=keys.dtype, device=keys.device)[:, None, None]
    m = torch.clamp(torch.div(keys - r, _VERTS, rounding_mode="floor"),
                    -mm, mm) + mm                                 # [V, 3, N]
    lin = (m[:, 0] * dm + m[:, 1]) * dm + m[:, 2]                 # [V, N]
    r_off = torch.arange(_VERTS, dtype=torch.int32,
                         device=keys.device)[:, None] * (dm * dm * dm)
    return (r_off + lin).to(torch.int32)


def _statics(scales, capacity: int, feat_dim: int):
    log2_c = int(np.log2(capacity))
    mm, dm, direct, _ = direct_level_specs(scales, capacity, feat_dim)
    inv_scales = (1.0 / np.asarray(scales)).astype(np.float32)
    return log2_c, inv_scales, mm, dm, direct


def _level_lattice(x: torch.Tensor, inv_s, log2_c, mm_l, dm_l, dir_l):
    """idx [4, N] int64 and bary [4, N] (differentiable in x) of one level."""
    scaled = x * constant(inv_s, torch.float32, x.device)
    el, gr, rank = _rank_and_el(scaled)
    keys, b = _simplex_from_rank(el, gr.detach(), rank)
    idx = _index_keys_T(keys, log2_c, int(mm_l), int(dm_l), bool(dir_l))
    return idx.to(torch.int64), b


def permuto_encode_levels(tables: Tuple[torch.Tensor, ...], coordsT: torch.Tensor,
                          scales, compute_dtype=torch.float32):
    """Each of ``tables`` ([L, C, F]) at the lattice of coords [3, N]:
    features [L*F, N] a table, one level at a time; the weights are rounded
    to the tables' dtype, each vertex's row weighted in float32, summed over
    the vertices and rounded once to ``compute_dtype``. The coordinates'
    gradient comes from the first table only: the others are read at
    stop-gradient weights (the delta grid at stop-gradient coordinates)."""
    l, c, f = tables[0].shape
    log2_c, inv_scales, mm, dm, direct = _statics(scales, c, f)
    x = coordsT.float()
    outs = [[] for _ in tables]
    for lvl in range(l):
        idx, b = _level_lattice(x, inv_scales[lvl], log2_c, mm[lvl], dm[lvl], direct[lvl])
        for k, (t, out) in enumerate(zip(tables, outs)):
            tl = t[lvl].to(compute_dtype)
            w = (b if k == 0 else b.detach()).to(tl.dtype).float()
            rows = tl[idx].float()                                   # [4, N, F]
            out.append(torch.sum(rows * w[..., None], dim=0).t().to(compute_dtype))
    return tuple(torch.cat(o, dim=0) for o in outs)


def permuto_encode_T(tables, coordsT, scales, compute_dtype=torch.float32):
    return permuto_encode_levels((tables,), coordsT, scales, compute_dtype)[0]


def permuto_encode_dual_T(tables_a, tables_b, coordsT, scales, compute_dtype=torch.float32):
    return permuto_encode_levels((tables_a, tables_b), coordsT, scales, compute_dtype)


class PermutoEncodingSpec:
    """Static spec of a permutohedral grid: level count, feature width, table
    capacity 2^capacity_log2 and geomspace scales coarsest -> finest."""

    def __init__(self, num_levels: int = 24, feature_dim: int = 2,
                 capacity_log2: int = 18, coarsest_scale: float = 1.0,
                 finest_scale: float = 0.0001):
        self.num_levels = num_levels
        self.feature_dim = feature_dim
        self.capacity_log2 = capacity_log2
        self.capacity = 1 << capacity_log2
        self.scales = np.geomspace(coarsest_scale, finest_scale, num=num_levels)
        self.output_dim = num_levels * feature_dim

    def init(self, generator: torch.Generator, init_std: float = 1e-4,
             device="cpu") -> torch.Tensor:
        """Uniform(-init_std, init_std) tables [L, C, F] in float32."""
        t = torch.rand((self.num_levels, self.capacity, self.feature_dim),
                       generator=generator, device=device)
        return t * (2 * init_std) - init_std

    def encode_T(self, tables, coordsT, compute_dtype=torch.float32):
        return permuto_encode_T(tables, coordsT, self.scales, compute_dtype)

    def encode_dual_T(self, tables_a, tables_b, coordsT,
                      compute_dtype=torch.float32):
        return permuto_encode_dual_T(tables_a, tables_b, coordsT, self.scales,
                                     compute_dtype)
