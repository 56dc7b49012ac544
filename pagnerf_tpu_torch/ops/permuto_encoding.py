"""Multiresolution permutohedral-lattice encoding (counterpart of
``pagnerf_tpu/ops/permuto_encoding.py``).

The lattice math (elevation, rounding, rank, barycentric weights, direct or
hashed vertex indices) is plain PyTorch in float32, written to give the JAX
package's indices exactly and its weights to float32 rounding. The table
gather behind it, and its backward, are hand-written CUDA kernels
(``ops/table_gather.py``).

Gradients: the encodes are differentiable in the tables (through the
gather's scatter backward) and in the coordinates. The coordinate gradient
runs through ``_Lattice``, an autograd Function around all levels' lattice
math that saves only the coordinates: its backward recomputes each level's
rank from x and turns ``dbary`` into ``dx`` (the JAX package's
``_lattice_levels_bwd``). Autograd through the rank masks would keep
``[L, 5, V, N]``-sized multiply partners alive, gigabytes at a training
microbatch's N.

Layout: sample tensors are feature-major, coordinates ``[3, N]``, indices and
weights ``[L, V=4, N]``, features ``[L*F, N]`` -- the JAX package's layout, so
tests compare like with like.
"""
from __future__ import annotations

import numpy as np
import torch

from . import table_gather

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


def _lattice_points(scale: float) -> int:
    """Lattice points of a level's key box over [-1, 1]^3 (``4 * Dm^3`` of
    ``direct_level_specs``, whether or not the level fits the table)."""
    k_bound = int(np.ceil(float(np.abs(_E).sum(axis=1).max()) / float(scale))) + 8
    return _VERTS * (2 * (k_bound // 4 + 2) + 1) ** 3


# A hashed level whose lattice has at most this many points per table row
# still repeats rows along a ray (its cells span several ray steps), so its
# table-gradient scatter merges warp runs and sums in float64 like a direct
# level (``table_gather.GLOBAL``) instead of one float32 atomic per event.
RUNS_POINTS_PER_ROW = 128


def scatter_plan(scales, capacity: int, feature_dim: int):
    """(rows_used, modes) of the table-gradient scatter per level: a direct
    level's reachable rows (``4 * Dm^3``) or 0 for a hashed level
    (``ops/table_gather.py::live_rows``), and the scatter kernel's
    accumulation: ``table_gather.level_modes`` of those rows, except GLOBAL
    for hashed levels of at most ``RUNS_POINTS_PER_ROW`` lattice points per
    row."""
    _, _, direct, _ = direct_level_specs(scales, capacity, feature_dim)
    points = [_lattice_points(s) for s in np.asarray(scales)]
    rows = tuple(p if dr else 0 for p, dr in zip(points, direct))
    modes = table_gather.level_modes(table_gather.live_rows(rows, len(rows), capacity),
                                     capacity)
    modes = tuple(table_gather.GLOBAL if m == table_gather.FLOAT
                  and p <= RUNS_POINTS_PER_ROW * capacity else m
                  for m, p in zip(modes, points))
    return rows, modes


def _rank_and_el(scaledT: torch.Tensor):
    """One level's (el, gr, rank) from scale-divided coords [3, N]: elevation,
    nearest remainder-0 point (wrap-adjusted) and differential rank, ties
    broken by coordinate index."""
    e = torch.as_tensor(_E, dtype=scaledT.dtype, device=scaledT.device)
    el = e @ scaledT                                              # [4, N]
    gr = torch.round(el / _VERTS) * _VERTS                        # half to even
    sum_val = torch.sum(gr, dim=0) / _VERTS                       # integer-valued

    diff = el - gr
    di = diff[:, None, :]                                         # coordinate i
    dj = diff[None, :, :]                                         # coordinate j
    idx4 = torch.arange(_VERTS, device=scaledT.device)
    tie = (dj == di) & (idx4[None, :, None] < idx4[:, None, None])
    rank = torch.sum((dj > di) | tie, dim=1).to(torch.int32)      # [4, N]
    rank = rank + sum_val.to(torch.int32)[None, :]

    under = (rank < 0).to(torch.int32)
    over = (rank > _D).to(torch.int32)
    rank = rank + _VERTS * under - _VERTS * over
    gr = gr + _VERTS * under.to(gr.dtype) - _VERTS * over.to(gr.dtype)
    return el, gr, rank


def simplex_vertices_and_weights_T(scaledT: torch.Tensor):
    """Enclosing simplex of points [3, N] (already divided by the level scale).

    Returns keys [4, 3, N] int32 (first 3 lattice coordinates of each vertex)
    and barycentric weights bary [4, N]."""
    el, gr, rank = _rank_and_el(scaledT)
    delta = (el - gr) / _VERTS                                    # [4, N]
    b = torch.arange(_VERTS + 1, dtype=torch.int32,
                     device=scaledT.device)[:, None, None]        # [5, 1, 1]
    plus = ((_D - rank)[None] == b).to(delta.dtype)               # [5, 4, N]
    minus = ((_D + 1 - rank)[None] == b).to(delta.dtype)
    bary = torch.sum((plus - minus) * delta[None], dim=1)         # [5, N]
    bary0 = bary[0] + (1.0 + bary[_VERTS])
    bary = torch.cat([bary0[None], bary[1:_VERTS]])               # [4, N]

    r = torch.arange(_VERTS, dtype=torch.int32,
                     device=scaledT.device)[:, None, None]        # [4, 1, 1]
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


def _lattice_levels(x: torch.Tensor, log2_c: int, inv_scales, mm, dm, direct):
    idx, bary = [], []
    for inv_s, mm_l, dm_l, dir_l in zip(inv_scales, mm, dm, direct):
        keys, b = simplex_vertices_and_weights_T(
            x * torch.tensor(inv_s, dtype=torch.float32, device=x.device))
        idx.append(_index_keys_T(keys, log2_c, int(mm_l), int(dm_l), bool(dir_l)))
        bary.append(b)
    return torch.stack(idx), torch.stack(bary)


def _lattice_levels_dx(x: torch.Tensor, inv_scales, dbary: torch.Tensor):
    """dx [3, N] of x [3, N] from dbary [L, V, N], one level at a time: with
    bary5[b] = sum_v (plus - minus)[b, v] * delta[v], delta = (el - gr) / 4 and
    el = E @ (x * inv_s), dx += inv_s * E^T @ ddelta / 4 (rank recomputed)."""
    e_t = torch.as_tensor(_E, dtype=x.dtype, device=x.device).T   # [3, 4]
    b5 = torch.arange(_VERTS + 1, dtype=torch.int32, device=x.device)[:, None, None]
    dx = torch.zeros_like(x)
    for inv_s, dbary_l in zip(inv_scales, dbary):
        s = torch.tensor(inv_s, dtype=torch.float32, device=x.device)
        _, _, rank = _rank_and_el(x * s)
        pm = (((_D - rank)[None] == b5).to(dbary_l.dtype)
              - ((_D + 1 - rank)[None] == b5).to(dbary_l.dtype))   # [5, 4, N]
        # bary = bary5[:V] with bary5[0] folded += bary5[V]: transpose the fold
        db5 = torch.cat([dbary_l, dbary_l[:1]], dim=0)             # [5, N]
        ddelta = torch.einsum("bvn,bn->vn", pm, db5) / _VERTS      # [4, N]
        dx = dx + (e_t @ ddelta) * s
    return dx


class _Lattice(torch.autograd.Function):
    """idx and bary of all levels; the coordinate gradient flows through bary
    only (idx is integer and piecewise constant). Saves x alone."""

    @staticmethod
    def forward(ctx, x, log2_c, inv_scales, mm, dm, direct):
        ctx.save_for_backward(x)
        ctx.inv_scales = inv_scales
        idx, bary = _lattice_levels(x, log2_c, inv_scales, mm, dm, direct)
        ctx.mark_non_differentiable(idx)
        return idx, bary

    @staticmethod
    def backward(ctx, _didx, dbary):
        (x,) = ctx.saved_tensors
        dx = None
        if dbary is not None and ctx.needs_input_grad[0]:
            dx = _lattice_levels_dx(x, ctx.inv_scales, dbary.to(x.dtype))
        return dx, None, None, None, None, None


def lattice_all_levels(x: torch.Tensor, log2_c: int, inv_scales, mm, dm,
                       direct):
    """idx [L, V, N] int32 and bary [L, V, N] float32 for coords x [3, N],
    one level at a time (the JAX package's per-level scan); differentiable
    in x through bary."""
    return _Lattice.apply(x, log2_c, inv_scales, mm, dm, direct)


def lattice(tables: torch.Tensor, coordsT: torch.Tensor, scales):
    """idx [L, V, N] int32 and bary [L, V, N] float32 of coords [3, N] for a
    table stack [L, C, F] with per-level scales [L]."""
    num_levels, capacity, feat_dim = tables.shape
    log2_c = int(np.log2(capacity))
    if (1 << log2_c) != capacity:
        raise ValueError(f"table capacity {capacity} is not a power of two")
    inv_scales = (1.0 / np.asarray(scales)).astype(np.float32)
    mm, dm, direct, _ = direct_level_specs(scales, capacity, feat_dim)
    return lattice_all_levels(coordsT.float(), log2_c, inv_scales, mm, dm,
                              direct)


def permuto_encode_T(tables: torch.Tensor, coordsT: torch.Tensor, scales,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """Encode coords [3, N] in [-1, 1]^3 against tables [L, C, F] with
    per-level scales [L]. Returns features [L*F, N] in ``compute_dtype``."""
    num_levels, capacity, feat_dim = tables.shape
    idx, bary = lattice(tables, coordsT, scales)
    out = table_gather.multilevel_table_gather(
        tables.to(compute_dtype).contiguous(), idx, bary.to(compute_dtype),
        *scatter_plan(scales, capacity, feat_dim))
    return out.reshape(num_levels * feat_dim, -1)


def permuto_encode_dual_T(tables_a: torch.Tensor, tables_b: torch.Tensor,
                          coordsT: torch.Tensor, scales,
                          compute_dtype=torch.float32):
    """Encode coords against two same-spec table stacks with one shared
    lattice (the delta grid reads the main grid's indices and weights).
    Returns (featsA [L*F, N], featsB [L*F, N])."""
    if tables_a.shape != tables_b.shape:
        raise ValueError("dual encode needs same-spec tables, got "
                         f"{tuple(tables_a.shape)} and {tuple(tables_b.shape)}")
    num_levels, capacity, feat_dim = tables_a.shape
    idx, bary = lattice(tables_a, coordsT, scales)
    out_a, out_b = table_gather.dual_multilevel_table_gather(
        tables_a.to(compute_dtype).contiguous(),
        tables_b.to(compute_dtype).contiguous(), idx, bary.to(compute_dtype),
        *scatter_plan(scales, capacity, feat_dim))
    return (out_a.reshape(num_levels * feat_dim, -1),
            out_b.reshape(num_levels * feat_dim, -1))


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
