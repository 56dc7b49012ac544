"""Multiresolution permutohedral-lattice encoding (counterpart of
``pagnerf_tpu/ops/permuto_encoding.py``).

The encodes (``permuto_encode_T``, ``permuto_encode_dual_T``) run through
``fused_encode`` / ``fused_encode_dual``: on the card one hand-written CUDA
kernel (``csrc/permuto_encode.cu``) computes each level's lattice in
registers -- elevation, rounding, rank, barycentric weights, direct or hashed
vertex indices -- and gathers and sums the table rows in the same thread, so
idx and bary reach device memory only when a backward needs them. Their
plain versions are the lattice math below (plain PyTorch in float32, written
to give the JAX package's indices exactly and its weights to float32
rounding) followed by the plain gathers of ``ops/table_gather.py``.

Gradients: the encodes are differentiable in the tables and in the
coordinates (``_Encode``). The table gradient is the table-gradient scatter
of ``ops/table_gather.py`` over the forward's idx and bary; the coordinate
gradient is ``encode_dx`` (from the A side of a dual encode only: the delta
grid reads stop-gradient weights): on the card one hand-written kernel
(``csrc/permuto_encode_bwd.cu``) forms dbary and turns it into dx in
registers; its plain version ``encode_dx_plain`` is ``gather_dbary_plain``
followed by ``_lattice_levels_dx`` (the JAX package's Pallas dbary and
``_lattice_levels_bwd``). It forms dx on the rank the
forward computed, kept in one byte per level and sample (``pack_rank``; the
kernel writes it beside idx and bary), not on a recomputed one: the card's
``E @ s`` rounds el in an order that cuBLAS picks by N, so a recomputed rank
may pick another simplex for a point on a boundary. ``_Lattice``, an autograd
Function around all levels' plain lattice math, saves the coordinates and
the rank alike: autograd through the rank masks would keep
``[L, 5, V, N]``-sized multiply partners alive, gigabytes at a training
microbatch's N.

Under ``PAGNERF_BF16_GATHER=1`` (``table_gather.bf16_gather``, read at each
encode) float32 tables are read as rows rounded to bfloat16: the kernel
takes a bfloat16 copy of the rows (the dual encode's packed copy made in
bfloat16, ``table_pack``) and float32 weights and writes float32 features;
the backward's ``encode_dx`` reads the same rounded rows (the copy the
forward read), and the table gradients stay float32. ``compute_dtype=bfloat16`` is another function: its weights
and features are bfloat16 too.

Layout: sample tensors are feature-major, coordinates ``[3, N]``, indices and
weights ``[L, V=4, N]``, features ``[L*F, N]`` -- the JAX package's layout, so
tests compare like with like.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import constant
from . import table_gather
from .table_pack import packed_tables, rows_as

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


_RANK_SHIFTS = (0, 2, 4, 6)


def pack_rank(rank: torch.Tensor) -> torch.Tensor:
    """Ranks [..., 4, N] with entries in 0..3 -> one byte per sample [..., N]
    (uint8, 2 bits per coordinate, coordinate i at bits 2i), the layout the
    encode kernel writes."""
    shifts = constant(_RANK_SHIFTS, torch.int32, rank.device)
    return torch.sum(rank.to(torch.int32) << shifts[:, None],
                     dim=-2).to(torch.uint8)


def unpack_rank(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_rank``: uint8 [..., N] -> int32 ranks [..., 4, N]."""
    shifts = constant(_RANK_SHIFTS, torch.int32, packed.device)
    return (packed.to(torch.int32).unsqueeze(-2) >> shifts[:, None]) & 3


def simplex_vertices_and_weights_T(scaledT: torch.Tensor):
    """Enclosing simplex of points [3, N] (already divided by the level scale).

    Returns keys [4, 3, N] int32 (first 3 lattice coordinates of each vertex)
    and barycentric weights bary [4, N]."""
    return _simplex_from_rank(*_rank_and_el(scaledT))


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


def _lattice_levels(x: torch.Tensor, log2_c: int, inv_scales, mm, dm, direct):
    """idx [L, V, N] int32, bary [L, V, N] float32 and the packed rank [L, N]
    uint8 (``pack_rank``) of coords x [3, N], one level at a time."""
    idx, bary, ranks = [], [], []
    for inv_s, mm_l, dm_l, dir_l in zip(inv_scales, mm, dm, direct):
        scaled = x * constant(inv_s, torch.float32, x.device)
        el, gr, rank = _rank_and_el(scaled)
        keys, b = _simplex_from_rank(el, gr, rank)
        idx.append(_index_keys_T(keys, log2_c, int(mm_l), int(dm_l), bool(dir_l)))
        bary.append(b)
        ranks.append(pack_rank(rank))
    return torch.stack(idx), torch.stack(bary), torch.stack(ranks)


def _lattice_levels_dx(x: torch.Tensor, inv_scales, dbary: torch.Tensor,
                       rank: torch.Tensor):
    """dx [3, N] of x [3, N] from dbary [L, V, N], one level at a time: with
    bary5[b] = sum_v (plus - minus)[b, v] * delta[v], delta = (el - gr) / 4 and
    el = E @ (x * inv_s), dx += inv_s * E^T @ ddelta / 4. ``rank`` [L, N]
    (``pack_rank``) is the rank of the simplex the forward gathered, so dx is
    formed on that simplex whatever order another product would round el in.
    x gives only dx's shape, dtype and device: the rank stands for it."""
    e_t = constant(_E, x.dtype, x.device).T                     # [3, 4]
    b5 = torch.arange(_VERTS + 1, dtype=torch.int32, device=x.device)[:, None, None]
    dx = torch.zeros_like(x)
    for inv_s, dbary_l, rank_l in zip(inv_scales, dbary, rank):
        s = constant(inv_s, torch.float32, x.device)
        rank_l = unpack_rank(rank_l)
        pm = (((_D - rank_l)[None] == b5).to(dbary_l.dtype)
              - ((_D + 1 - rank_l)[None] == b5).to(dbary_l.dtype))   # [5, 4, N]
        # bary = bary5[:V] with bary5[0] folded += bary5[V]: transpose the fold
        db5 = torch.cat([dbary_l, dbary_l[:1]], dim=0)             # [5, N]
        ddelta = torch.einsum("bvn,bn->vn", pm, db5) / _VERTS      # [4, N]
        dx = dx + (e_t @ ddelta) * s
    return dx


class _Lattice(torch.autograd.Function):
    """idx and bary of all levels; the coordinate gradient flows through bary
    only (idx is integer and piecewise constant). Saves x and the packed rank
    (one byte per level and sample)."""

    @staticmethod
    def forward(ctx, x, log2_c, inv_scales, mm, dm, direct):
        ctx.inv_scales = inv_scales
        idx, bary, rank = _lattice_levels(x, log2_c, inv_scales, mm, dm, direct)
        ctx.save_for_backward(x)
        ctx.rank = rank
        ctx.mark_non_differentiable(idx)
        return idx, bary

    @staticmethod
    def backward(ctx, _didx, dbary):
        (x,) = ctx.saved_tensors
        dx = None
        if dbary is not None and ctx.needs_input_grad[0]:
            dx = _lattice_levels_dx(x, ctx.inv_scales, dbary.to(x.dtype), ctx.rank)
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
    _, capacity, feat_dim = tables.shape
    st = level_statics(scales, capacity, feat_dim)
    return lattice_all_levels(coordsT.float(), st.log2_c, st.inv_scales, st.mm,
                              st.dm, st.direct)


# ------------------------------------------------------------ fused encode
_LAYOUT_SINGLE, _LAYOUT_DUAL, _LAYOUT_PACKED = 1, 2, 3


class LevelStatics(NamedTuple):
    """What one encode needs of its scale schedule: the lattice's per-level
    statics (as ``_lattice_levels`` takes them) and the backward's
    table-gradient scatter plan (``scatter_plan``)."""
    log2_c: int
    inv_scales: np.ndarray
    mm: np.ndarray
    dm: np.ndarray
    direct: np.ndarray
    rows_used: Tuple[int, ...]
    modes: Tuple[int, ...]


@functools.lru_cache(maxsize=64)
def _statics(scales: Tuple[float, ...], capacity: int, feat_dim: int) -> LevelStatics:
    log2_c = int(np.log2(capacity))
    if (1 << log2_c) != capacity:
        raise ValueError(f"table capacity {capacity} is not a power of two")
    mm, dm, direct, _ = direct_level_specs(scales, capacity, feat_dim)
    inv_scales = (1.0 / np.asarray(scales)).astype(np.float32)
    return LevelStatics(log2_c, inv_scales, mm, dm, direct,
                        *scatter_plan(scales, capacity, feat_dim))


def level_statics(scales, capacity: int, feat_dim: int) -> LevelStatics:
    """``LevelStatics`` of a scale schedule [L] for tables [L, C, F]."""
    return _statics(tuple(float(s) for s in np.asarray(scales)), capacity, feat_dim)


def _check_encode(x: torch.Tensor, tables: Tuple[torch.Tensor, ...], scales) -> LevelStatics:
    """Contract of the fused encodes: coordinates [3, N] float32, tables
    [L, C, F] float32 or bfloat16 (a dual encode's two of one shape and
    dtype) with F in (1, 2, 4), C a power of two, one scale per level and at
    most ``table_gather.MAX_LEVELS`` levels; all contiguous, on one device."""
    t0 = tables[0]
    if t0.dim() != 3:
        raise ValueError(f"tables must be [L, C, F], got {tuple(t0.shape)}")
    l, c, f = t0.shape
    if f not in table_gather._FEATS:
        raise ValueError(f"feature width {f} not supported; use one of {table_gather._FEATS}")
    if t0.dtype not in table_gather._DTYPE_CODE:
        raise TypeError(f"tables must be float32 or bfloat16, got {t0.dtype}")
    for t in tables[1:]:
        if t.shape != t0.shape or t.dtype != t0.dtype:
            raise ValueError("dual tables must share shape and dtype, got "
                             f"{tuple(t0.shape)} {t0.dtype} and {tuple(t.shape)} {t.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"coordinates must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != _D:
        raise ValueError(f"coordinates must be [{_D}, N], got {tuple(x.shape)}")
    n_scales = len(np.asarray(scales))
    if n_scales != l:
        raise ValueError(f"{n_scales} scales for {l} table levels")
    if l > table_gather.MAX_LEVELS:
        raise ValueError(f"the encode kernel takes at most {table_gather.MAX_LEVELS} "
                         f"levels, got {l}")
    table_gather._check_device((x, *tables))
    return level_statics(scales, c, f)


@functools.cache
def _encode_kernel():
    from . import _build
    fn = _build.load("permuto_encode").pagnerf_permuto_encode
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [f32p] * 2 + [i32p] * 3
                   + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def encode_level_order(levels: int):
    """(group size, order) of the encode kernel's levels: the levels run in
    groups of that many consecutive entries of ``order``, a group's blocks
    alternating (``permuto_encode.cu::block_work``)."""
    from . import _build
    fn = _build.load("permuto_encode").pagnerf_permuto_encode_level_order
    fn.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    fn.restype = ctypes.c_int
    order = (ctypes.c_int32 * levels)()
    group = fn(levels, order)
    return group, list(order)


def _launch_encode(x: torch.Tensor, tables: Tuple[torch.Tensor, ...],
                   st: LevelStatics, with_lattice: bool, packed: bool, kernel=None,
                   bf16_rows: bool = False):
    """One launch of the encode kernel -> (outs, idx, bary, rank); idx, bary
    and the packed rank [L, N] uint8 (``pack_rank``) are written only
    ``with_lattice``, else None. ``kernel``: another build of the C entry
    ``pagnerf_permuto_encode`` with the same interface (``profile_encode
    --parent``). ``bf16_rows``: float32 tables read as bfloat16 rows (a kept
    copy), float32 outputs."""
    l, c, f = tables[0].shape
    n = x.shape[1]
    dev = x.device
    outs = tuple(torch.empty((l, f, n), dtype=tables[0].dtype, device=dev)
                 for _ in tables)
    idx = bary = rank = None
    if with_lattice:
        idx = torch.empty((l, _VERTS, n), dtype=torch.int32, device=dev)
        bary = torch.empty((l, _VERTS, n), dtype=torch.float32, device=dev)
        rank = torch.empty((l, n), dtype=torch.uint8, device=dev)
    if n == 0:
        return outs, idx, bary, rank
    rows = torch.bfloat16 if bf16_rows else tables[0].dtype
    if len(tables) == 1:
        layout, src = _LAYOUT_SINGLE, ((rows_as(tables[0], rows),) if bf16_rows else tables)
    elif packed:
        layout, src = _LAYOUT_PACKED, (packed_tables(*tables, rows),)
    else:
        layout, src = _LAYOUT_DUAL, tuple(t.to(rows) for t in tables)
    as_c = lambda a, t: (t * len(a))(*a)
    elev = np.asarray(_E, dtype=np.float32).reshape(-1)
    fn = kernel or _encode_kernel()
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), src[0].data_ptr(), src[-1].data_ptr(),
                 outs[0].data_ptr(), outs[-1].data_ptr(), ptr(idx), ptr(bary), ptr(rank),
                 as_c(elev, ctypes.c_float), as_c(st.inv_scales, ctypes.c_float),
                 as_c(st.mm, ctypes.c_int32), as_c(st.dm, ctypes.c_int32),
                 as_c(st.direct.astype(np.int32), ctypes.c_int32),
                 l, c, n, f, layout, table_gather._READ_CODE[(rows, tables[0].dtype)],
                 table_gather._stream(dev))
    table_gather._raise_on(err, "permuto_encode")
    return outs, idx, bary, rank


# ------------------------------------------------- the coordinate gradient
def encode_dx_plain(rows: torch.Tensor, idx: torch.Tensor, rank: torch.Tensor,
                    g: torch.Tensor, inv_scales, dtype=None) -> torch.Tensor:
    """Plain version of ``encode_dx``: ``gather_dbary_plain`` of table A's
    rows, dbary rounded to ``dtype`` (the tables' dtype; default the rows')
    and widened, then ``_lattice_levels_dx`` on the forward's rank."""
    f = g.shape[1]
    table = rows if rows.shape[2] == f else rows[..., :f]
    dbary = table_gather.gather_dbary_plain(table, idx, g)
    like = g.new_empty((_D, idx.shape[2]))
    return _lattice_levels_dx(like, inv_scales, dbary.to(dtype or rows.dtype).float(), rank)


def _check_encode_dx(rows, idx, rank, g, inv_scales, dtype) -> None:
    """Contract of ``encode_dx``: idx [L, 4, N] int32, rank [L, N] uint8, g
    [L, F, N] float32 with F in (1, 2, 4), rows [L, C, F] or the packed
    [L, C, 2F], rows and tables float32 / float32, bfloat16 / bfloat16 or
    bfloat16 / float32 (the bf16 read), one scale per level, at most
    ``table_gather.MAX_LEVELS`` levels; all contiguous, on one device."""
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 3 or idx.shape[1] != _VERTS:
        raise ValueError(f"idx must be [L, {_VERTS}, N], got {tuple(idx.shape)}")
    l, _, n = idx.shape
    if l > table_gather.MAX_LEVELS:
        raise ValueError(f"the encode_dx kernel takes at most {table_gather.MAX_LEVELS} "
                         f"levels, got {l}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if g.dim() != 3 or g.shape[0] != l or g.shape[2] != n or g.shape[1] not in table_gather._FEATS:
        raise ValueError(f"g must be [L={l}, F, N={n}] with F in {table_gather._FEATS}, "
                         f"got {tuple(g.shape)}")
    f = g.shape[1]
    if rank.dtype != torch.uint8:
        raise TypeError(f"rank must be uint8, got {rank.dtype}")
    if tuple(rank.shape) != (l, n):
        raise ValueError(f"rank must be [L={l}, N={n}], got {tuple(rank.shape)}")
    if rows.dim() != 3 or rows.shape[0] != l or rows.shape[2] not in (f, 2 * f):
        raise ValueError(f"rows must be [L={l}, C, {f}] or packed [L={l}, C, {2 * f}], "
                         f"got {tuple(rows.shape)}")
    if (rows.dtype, dtype) not in table_gather._READ_CODE:
        raise TypeError(f"rows {rows.dtype} for tables {dtype} not supported")
    if len(np.asarray(inv_scales)) != l:
        raise ValueError(f"{len(np.asarray(inv_scales))} scales for {l} levels")
    table_gather._check_device((rows, idx, rank, g))


@functools.cache
def _encode_dx_kernel():
    from . import _build
    fn = _build.load("permuto_encode_bwd").pagnerf_encode_dx
    f32p = ctypes.POINTER(ctypes.c_float)
    fn.argtypes = [ctypes.c_void_p] * 5 + [f32p] * 2 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def encode_dx(rows: torch.Tensor, idx: torch.Tensor, rank: torch.Tensor, g: torch.Tensor,
              inv_scales, dtype=None, kernel=None) -> torch.Tensor:
    """Coordinate gradient dx [3, N] float32 of an encode from the lattice
    its forward kept -- idx [L, 4, N] int32 and the packed rank [L, N] uint8
    (``pack_rank``) -- the cotangent g [L, F, N] of its A side and table A's
    rows: a stack [L, C, F], or the dual kernels' packed [L, C, 2F] rows
    (``table_pack.packed_tables``), of which A's half is read; float32, or
    bfloat16 for bfloat16 tables (``dtype``, default the rows': dbary is
    rounded to it) or for the bf16 table read (``dtype`` float32).
    ``inv_scales`` [L]: each level's 1 / scale. CUDA tensors launch the
    encode_dx kernel (``csrc/permuto_encode_bwd.cu``, counted in
    ``.launches``; ``kernel``: another build of its C entry
    ``pagnerf_encode_dx``, ``profile_encode_dx --parent``); CPU tensors take
    ``encode_dx_plain``."""
    dtype = dtype or rows.dtype
    _check_encode_dx(rows, idx, rank, g, inv_scales, dtype)
    if idx.device.type == "cpu":
        return encode_dx_plain(rows, idx, rank, g, inv_scales, dtype)
    l, c, w = rows.shape
    n, f = idx.shape[2], g.shape[1]
    dx = torch.empty((_D, n), dtype=torch.float32, device=idx.device)
    if n == 0:
        return dx
    as_c = lambda a: (ctypes.c_float * len(a))(*a)
    fn = kernel or _encode_dx_kernel()
    with torch.cuda.device(idx.device):
        err = fn(rows.data_ptr(), idx.data_ptr(), rank.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 as_c(np.asarray(_E, dtype=np.float32).reshape(-1)),
                 as_c(np.asarray(inv_scales, dtype=np.float32)), l, c, n, f, w,
                 table_gather._READ_CODE[(rows.dtype, dtype)], table_gather._stream(idx.device))
    table_gather._raise_on(err, "permuto_encode_bwd encode_dx")
    table_gather.KERNELS["encode_dx"].launches += table_gather.launched()
    return dx


def _dx_rows(tables: Tuple[torch.Tensor, ...], bf16: bool) -> torch.Tensor:
    """The rows of table A that ``encode_dx`` reads for an encode of
    ``tables``: table A itself, or under the bf16 read the bfloat16 copy the
    forward read -- on the card a dual encode's packed copy, A's half --
    kept, so the backward makes no copy of its own."""
    if not bf16:
        return tables[0]
    if len(tables) == 2 and tables[0].device.type == "cuda":
        return packed_tables(*tables, torch.bfloat16)
    return rows_as(tables[0], torch.bfloat16)


class _Encode(torch.autograd.Function):
    """Single or dual fused encode. Forward: the kernel on the card, the
    plain lattice + gathers on the CPU; idx, bary and the packed rank are
    kept only when a gradient will be asked for (``grad``: grad mode was on
    at the call). Backward: the (dual) table-gradient scatter, and for the
    coordinates ``encode_dx`` from the A side on the forward's rank (one
    kernel on the card: dbary and the lattice backward together)."""

    @staticmethod
    def forward(ctx, x, st, grad, bf16, *tables):
        keep = grad and any(ctx.needs_input_grad)
        if x.device.type == "cpu":
            idx, bary, rank = _lattice_levels(x, st.log2_c, st.inv_scales, st.mm,
                                              st.dm, st.direct)
            w = bary.to(tables[0].dtype)
            outs = tuple(table_gather.multilevel_gather_plain(t, idx, w, bf16)
                         for t in tables)
        else:
            outs, idx, bary, rank = _launch_encode(x, tables, st, keep, packed=True,
                                                   bf16_rows=bf16)
            wrapper = fused_encode if len(tables) == 1 else fused_encode_dual
            n = table_gather.launched()
            wrapper.launches += n
            wrapper.launches_with_idx_bary += n * int(keep)
        if keep:
            ctx.save_for_backward(x, idx, bary, tables[0])
            ctx.rank = rank
            ctx.st = st
            ctx.dtypes = tuple(t.dtype for t in tables)
            ctx.dx_rows = _dx_rows(tables, bf16) if ctx.needs_input_grad[0] else None
        return outs

    @staticmethod
    def backward(ctx, *gs):
        x, idx, bary, table_a = ctx.saved_tensors
        st = ctx.st
        l, c, f = table_a.shape
        gs = [torch.zeros((l, f, x.shape[1]), dtype=torch.float32, device=x.device)
              if g is None else g.float().contiguous() for g in gs]
        # the weights the forward multiplied by (rounded to the table dtype)
        w = bary.to(table_a.dtype).float()
        dtables = [None] * len(gs)
        if any(ctx.needs_input_grad[3:]):
            if len(gs) == 1:
                dts = (table_gather.multilevel_table_grad(idx, w, gs[0], c, st.rows_used,
                                                          st.modes),)
            else:
                dts = table_gather.dual_multilevel_table_grad(idx, w, gs[0], gs[1], c,
                                                              st.rows_used, st.modes)
            dtables = [d.to(dt) for d, dt in zip(dts, ctx.dtypes)]
        dx = None
        if ctx.needs_input_grad[0]:
            dx = encode_dx(ctx.dx_rows, idx, ctx.rank, gs[0], st.inv_scales, table_a.dtype)
        return (dx, None, None, None, *dtables)


def fused_encode(tables: torch.Tensor, coordsT: torch.Tensor, scales) -> torch.Tensor:
    """Encode coords [3, N] float32 against tables [L, C, F] (float32 or
    bfloat16) with per-level scales [L] -> features [L, F, N] in the tables'
    dtype; differentiable in tables and coords. CUDA tensors launch the
    fused encode kernel (counted in ``.launches``); CPU tensors take
    ``encode_plain``'s lattice and gather. Under ``PAGNERF_BF16_GATHER=1``
    float32 tables are read as bfloat16 rows (module docstring)."""
    st = _check_encode(coordsT, (tables,), scales)
    (out,) = _Encode.apply(coordsT, st, torch.is_grad_enabled(),
                           table_gather.bf16_rows(tables), tables)
    return out


def fused_encode_dual(tables_a: torch.Tensor, tables_b: torch.Tensor,
                      coordsT: torch.Tensor, scales):
    """Two same-spec table stacks at one shared lattice -> (out_a, out_b),
    each [L, F, N]; out_a is bit-equal to ``fused_encode(tables_a, ...)``.
    One launch (counted in ``.launches``) reads both tables of a vertex with
    one load from a packed [L, C, 2F] copy (``packed_tables``, rebuilt only
    when a table changed). CPU tensors take
    ``dual_encode_plain``'s path. Differentiable in both tables and in the
    coordinates, whose gradient comes from the A side only; the bf16 read as
    in ``fused_encode``."""
    st = _check_encode(coordsT, (tables_a, tables_b), scales)
    return _Encode.apply(coordsT, st, torch.is_grad_enabled(),
                         table_gather.bf16_rows(tables_a), tables_a, tables_b)


def encode_plain(tables: torch.Tensor, coordsT: torch.Tensor, scales,
                 bf16_rows: bool = False) -> torch.Tensor:
    """Plain version of ``fused_encode``: ``lattice_all_levels``, the weights
    rounded to the tables' dtype, then ``multilevel_gather_plain``
    (``bf16_rows``: the bf16 read's rows)."""
    idx, bary = lattice(tables, coordsT, scales)
    return table_gather.multilevel_gather_plain(tables, idx, bary.to(tables.dtype), bf16_rows)


def dual_encode_plain(tables_a: torch.Tensor, tables_b: torch.Tensor,
                      coordsT: torch.Tensor, scales, bf16_rows: bool = False):
    """Plain version of ``fused_encode_dual``: one lattice, two plain gathers."""
    idx, bary = lattice(tables_a, coordsT, scales)
    return table_gather.dual_gather_plain(tables_a, tables_b, idx,
                                          bary.to(tables_a.dtype), bf16_rows)


# ``launches_with_idx_bary``: the launches among them that wrote idx/bary
# (and the rank) for a backward
fused_encode.launches = fused_encode.launches_with_idx_bary = 0
fused_encode_dual.launches = fused_encode_dual.launches_with_idx_bary = 0
encode_dx.launches = 0
table_gather.KERNELS.update(encode=fused_encode, dual_encode=fused_encode_dual,
                            encode_dx=encode_dx)


def permuto_encode_T(tables: torch.Tensor, coordsT: torch.Tensor, scales,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """Encode coords [3, N] in [-1, 1]^3 against tables [L, C, F] with
    per-level scales [L]. Returns features [L*F, N] in ``compute_dtype``."""
    num_levels, _, feat_dim = tables.shape
    out = fused_encode(tables.to(compute_dtype).contiguous(),
                       coordsT.float().contiguous(), scales)
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
    num_levels, _, feat_dim = tables_a.shape
    out_a, out_b = fused_encode_dual(tables_a.to(compute_dtype).contiguous(),
                                     tables_b.to(compute_dtype).contiguous(),
                                     coordsT.float().contiguous(), scales)
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
