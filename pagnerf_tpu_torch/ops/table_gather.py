"""Multi-level table gather and its gradients (counterpart of
``pagnerf_tpu/ops/table_gather.py``, ``pallas_gather.py`` and
``pallas_scatter.py``).

Forward:

    out[l, f, n] = sum_v bary[l, v, n] * tables[l, idx[l, v, n], f]

``multilevel_table_gather`` (one table stack) and
``dual_multilevel_table_gather`` (two stacks read at shared indices and
weights: the main grid and the delta grid) are differentiable with respect to
the tables and the weights (``torch.autograd.Function``). Their backward:

    dtables[l, c, f] = sum_{v, n : idx[l, v, n] = c} bary[l, v, n] * g[l, f, n]
    dbary[l, v, n]   = sum_f g[l, f, n] * tables[l, idx[l, v, n], f]

The dual backward scatters both tables' gradients from one event stream and
takes ``dbary`` from the A side only: the B side reads stop-gradient weights
(the delta grid is queried at detached coordinates). ``dbary`` is computed
only when autograd asks for it, i.e. when the coordinates need a gradient.

Each of the five functions -- gather, dual gather, table-gradient scatter,
dual scatter, dbary -- has a hand-written CUDA kernel (``csrc/permuto_gather.cu``
for the forward, ``csrc/permuto_scatter.cu`` for the backward) and a plain
PyTorch version beside it here, at V = 4 vertices (the permutohedral
lattice's simplices) and V = 8 (the hash grid's voxel corners). The encodes
of ``ops/permuto_encoding.py`` do not call the gathers: their fused kernel
(``csrc/permuto_encode.cu``) computes the lattice and gathers in one launch,
and its backward calls the scatters here and, for the coordinates, its own
``encode_dx`` (dbary and the lattice backward in one kernel). The hash encodes of
``ops/hash_encoding.py`` compute their indices and weights in PyTorch and
call the gathers at V = 8, whose backward is the scatters and dbary. A
wrapper launches the kernel for CUDA tensors (and counts the launch in its
``.launches``) and takes the plain version for CPU tensors; a CUDA tensor
the kernel does not take raises.

The scatter kernel holds each entry within 64 eps_f32 of its sum of
|bary * g| to its plain version (a float64 sum rounded once), however many
events share a table row: per level it sums in float64, or in float32 on rows
of at most 120 addends (of at most 106 merged flushes in the window mode) and
in float64 again beyond (``level_modes``, ``csrc/permuto_scatter.cu``
"Accuracy"). ``rows_used`` bounds a level to its
live rows (a direct-indexed level's index range); the permutohedral encodes
pass it with the modes from ``permuto_encoding.scatter_plan``, the hash
encodes their modes from ``hash_encoding.scatter_modes``.

Contract of the gathers: tables ``[L, C, F]`` with F in (1, 2, 4), ``idx
[L, V, N]`` int32 with V in (4, 8) and entries in ``[0, C)``, ``bary
[L, V, N]``; tables and bary in one dtype, float32 or bfloat16; all
contiguous, on one device.
Outputs ``[L, F, N]`` in that dtype; products and sums run in float32 and
round once.

The bf16 table-read path (the JAX package's ``PAGNERF_BF16_GATHER=1``,
``pagnerf_tpu/ops/table_gather.py:52-62``; ``bf16_gather`` reads the
variable at each call, as the JAX package does): float32 tables' rows are
rounded to bfloat16 and widened exactly, then weighted by float32 bary,
summed in float32 and written in float32; dbary is formed from the same
rounded rows; the table gradients are unchanged (they are built from idx,
bary and g) and stay float32. The kernels read a bfloat16 copy of the rows
(``table_pack``: the dual kernels' packed copy in bfloat16, the single
ones' ``rows_as``), kept while the tables are unchanged; the plain versions
take ``bf16_rows=True``. Tables that are bfloat16 already read as they are. The backward kernels take float32 only: for bfloat16 tables the
backward widens g, bary and the tables to float32 first, and casts the
float32 table gradient to the table dtype, as the JAX package's ``_ml_bwd``
does. The kernels do not check that idx lies in ``[0, C)``; the lattice
(``ops/permuto_encoding.py``) and the hash (``ops/hash_encoding.py``)
guarantee it.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from . import table_pack

VERTS = (4, 8)     # the vertex counts V the kernels take
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' code of (table rows, bary and outputs)
_READ_CODE = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
              (torch.bfloat16, torch.float32): 2}
_FEATS = (1, 2, 4)


def bf16_gather() -> bool:
    """``PAGNERF_BF16_GATHER`` is "1": float32 tables are read as rows
    rounded to bfloat16 (module docstring). Read at each call of a gather or
    encode, as the JAX package reads it."""
    return os.environ.get("PAGNERF_BF16_GATHER", "0") == "1"


def bf16_rows(tables: torch.Tensor) -> bool:
    """Whether a gather or encode of ``tables`` reads bfloat16-rounded rows
    of float32 tables now."""
    return tables.dtype == torch.float32 and bf16_gather()


# --------------------------------------------------------------- plain versions
def _flat_rows(idx: torch.Tensor, capacity: int) -> torch.Tensor:
    """Level-offset flat row of every event: idx [L, V, N] -> [L*V*N] int64."""
    offs = torch.arange(idx.shape[0], device=idx.device,
                        dtype=torch.int64)[:, None, None] * capacity
    return (idx.to(torch.int64) + offs).reshape(-1)


def _gather_rows(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tables [L, C, F], idx [L, V, N] -> float32 features [L, V, N, F]."""
    l, c, f = tables.shape
    feats = torch.index_select(tables.reshape(l * c, f), 0, _flat_rows(idx, c))
    return feats.reshape(*idx.shape, f).float()


def _weighted_sum(feats: torch.Tensor, bary: torch.Tensor, dtype) -> torch.Tensor:
    """feats [L, V, N, F] float32 (contiguous), bary [L, V, N] -> [L, F, N]:
    weight in float32, sum over V, round once to ``dtype``."""
    out = torch.sum(feats * bary.float()[..., None], dim=1)         # [L, N, F]
    return out.permute(0, 2, 1).contiguous().to(dtype)


def _rows(tables: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The rows a gather reads: the tables, or rounded to bfloat16."""
    return tables.to(torch.bfloat16) if bf16 else tables


def multilevel_gather_plain(tables: torch.Tensor, idx: torch.Tensor,
                            bary: torch.Tensor, bf16_rows: bool = False) -> torch.Tensor:
    """Plain PyTorch version: gather, weight in float32, sum over V, round
    once. tables [L, C, F], idx/bary [L, V, N] -> [L, F, N] in the tables'
    dtype; ``bf16_rows``: the rows rounded to bfloat16 first."""
    return _weighted_sum(_gather_rows(_rows(tables, bf16_rows), idx), bary, tables.dtype)


def dual_gather_plain(tables_a: torch.Tensor, tables_b: torch.Tensor,
                      idx: torch.Tensor, bary: torch.Tensor, bf16_rows: bool = False):
    """Plain PyTorch dual version: two single gathers at shared idx/bary."""
    return (multilevel_gather_plain(tables_a, idx, bary, bf16_rows),
            multilevel_gather_plain(tables_b, idx, bary, bf16_rows))


def dual_gather_packed_plain(packed: torch.Tensor, idx: torch.Tensor,
                             bary: torch.Tensor, bf16_rows: bool = False):
    """Plain PyTorch version of the dual kernel on its packed rows: packed
    [L, C, 2F] (``table_pack.packed_tables``), idx/bary [L, V, N] -> (out_a,
    out_b), each [L, F, N]; one row gathered a vertex, each table's half
    weighted in float32, summed over V and rounded once as
    ``multilevel_gather_plain`` does, on the same layout, so the outputs
    are bit-equal to ``dual_gather_plain`` on the two tables (the sum's
    order over V may depend on the layout it is given)."""
    f = packed.shape[2] // 2
    feats = _gather_rows(_rows(packed, bf16_rows), idx)              # [L, V, N, 2F]
    return tuple(_weighted_sum(feats[..., half].contiguous(), bary, packed.dtype)
                 for half in (slice(0, f), slice(f, 2 * f)))


def live_rows(rows_used, levels: int, capacity: int) -> Tuple[int, ...]:
    """Per-level live rows of the table gradient: ``rows_used[l]`` rows of
    ``[C, F]`` (a direct-indexed level's index range), or all ``capacity``
    rows where it is 0 or ``rows_used`` is None. Events at rows at or beyond
    a level's live rows are dropped, as the JAX ``table_grad_matmul_T(...,
    rows_used)`` drops them (its ``rows_used`` counts 128-lane rows, i.e.
    ``128 / F`` of these)."""
    if rows_used is None:
        return (capacity,) * levels
    rows = tuple(int(r) for r in rows_used)
    if len(rows) != levels or any(r < 0 for r in rows):
        raise ValueError(f"rows_used must hold {levels} counts >= 0, got {rows_used}")
    return tuple(min(r, capacity) if r > 0 else capacity for r in rows)


def table_grad_plain(idx: torch.Tensor, bary: torch.Tensor, g: torch.Tensor,
                     capacity: int, rows_used=None) -> torch.Tensor:
    """Plain table gradient: ``index_add_`` of the float32 products
    ``bary * g`` at level-offset flat rows, summed in float64 and rounded once
    to float32, as the kernel sums (in another order). idx/bary [L, V, N],
    g [L, F, N] -> [L, C, F] float32. Events beyond a level's ``rows_used``
    (see ``live_rows``) are dropped."""
    l, v, n = idx.shape
    f = g.shape[1]
    vals = bary.float()[..., None] * g.float().permute(0, 2, 1)[:, None]  # [L,V,N,F]
    vals = vals.reshape(-1, f).double()
    if rows_used is not None:
        rows = torch.tensor(live_rows(rows_used, l, capacity), device=idx.device)
        keep = (idx < rows[:, None, None]).reshape(-1, 1)
        vals = torch.where(keep, vals, torch.zeros_like(vals))
    out = torch.zeros((l * capacity, f), dtype=torch.float64, device=idx.device)
    out.index_add_(0, _flat_rows(idx, capacity), vals)
    return out.reshape(l, capacity, f).float()


def dual_table_grad_plain(idx: torch.Tensor, bary: torch.Tensor,
                          g_a: torch.Tensor, g_b: torch.Tensor, capacity: int,
                          rows_used=None):
    """Plain dual table gradient: two single scatters of one event stream."""
    return (table_grad_plain(idx, bary, g_a, capacity, rows_used),
            table_grad_plain(idx, bary, g_b, capacity, rows_used))


def gather_dbary_plain(tables: torch.Tensor, idx: torch.Tensor,
                       g: torch.Tensor, bf16_rows: bool = False) -> torch.Tensor:
    """Plain weight gradient: dot over F of the gathered rows with g, in
    float32. tables [L, C, F], idx [L, V, N], g [L, F, N] -> [L, V, N] float32;
    ``bf16_rows``: the rows rounded to bfloat16 first."""
    feats = _gather_rows(_rows(tables, bf16_rows), idx)              # [L, V, N, F]
    return torch.sum(feats * g.float().permute(0, 2, 1)[:, None], dim=-1)


# ------------------------------------------------------------------ checks
def _check_device(tensors) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if tensors[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tensors[0].device}")


def _check_tables(t0: torch.Tensor, idx: torch.Tensor) -> None:
    if t0.dim() != 3:
        raise ValueError(f"tables must be [L, C, F], got {tuple(t0.shape)}")
    l, _, f = t0.shape
    if f not in _FEATS:
        raise ValueError(f"feature width {f} not supported; use one of {_FEATS}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 3 or idx.shape[0] != l or idx.shape[1] not in VERTS:
        raise ValueError(f"idx must be [L={l}, V, N] with V in {VERTS}, got "
                         f"{tuple(idx.shape)}")


def _check(tables: Tuple[torch.Tensor, ...], idx: torch.Tensor,
           bary: torch.Tensor) -> None:
    """Contract of the forward gathers."""
    t0 = tables[0]
    _check_tables(t0, idx)
    if t0.dtype not in _DTYPE_CODE:
        raise TypeError(f"tables must be float32 or bfloat16, got {t0.dtype}")
    for t in tables[1:]:
        if t.shape != t0.shape or t.dtype != t0.dtype:
            raise ValueError("dual tables must share shape and dtype")
    if bary.dtype != t0.dtype:
        raise TypeError(f"bary dtype {bary.dtype} != tables dtype {t0.dtype}")
    if bary.shape != idx.shape:
        raise ValueError(f"idx and bary must both be [L, V, N], got "
                         f"{tuple(idx.shape)} and {tuple(bary.shape)}")
    _check_device((*tables, idx, bary))


def _check_grad(idx: torch.Tensor, bary: torch.Tensor, gs, capacity: int) -> None:
    """Contract of the table-gradient scatters: idx [L, V, N] int32 (V in
    ``VERTS``), float32 bary [L, V, N] and cotangents [L, F, N]."""
    g0 = gs[0]
    if g0.dim() != 3 or g0.shape[1] not in _FEATS:
        raise ValueError(f"g must be [L, F, N] with F in {_FEATS}, got "
                         f"{tuple(g0.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 3 or idx.shape[1] not in VERTS or bary.shape != idx.shape:
        raise ValueError(f"idx and bary must both be [L, V, N] with V in {VERTS}, got "
                         f"{tuple(idx.shape)} and {tuple(bary.shape)}")
    l, _, n = idx.shape
    for g in gs:
        if g.shape != (l, g0.shape[1], n):
            raise ValueError(f"g must be [L={l}, F, N={n}], got {tuple(g.shape)}")
    for t in (bary, *gs):
        if t.dtype != torch.float32:
            raise TypeError(f"bary and g must be float32, got {t.dtype}")
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    _check_device((idx, bary, *gs))


def _check_dbary(tables: torch.Tensor, idx: torch.Tensor, g: torch.Tensor) -> None:
    """Contract of dbary: float32 or bfloat16 tables [L, C, F] and float32
    g [L, F, N]."""
    _check_tables(tables, idx)
    l, _, f = tables.shape
    if tables.dtype not in _DTYPE_CODE or g.dtype != torch.float32:
        raise TypeError(f"tables must be float32 or bfloat16 and g float32, got "
                        f"{tables.dtype} and {g.dtype}")
    if g.shape != (l, f, idx.shape[2]):
        raise ValueError(f"g must be [L={l}, F={f}, N={idx.shape[2]}], got "
                         f"{tuple(g.shape)}")
    _check_device((tables, idx, g))


# ------------------------------------------------------------------ kernels
@functools.cache
def _kernel():
    from . import _build
    fn = _build.load("permuto_gather").pagnerf_permuto_gather
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scatter_kernels():
    """(table_grad, table_grad_scratch, dbary, scatter_rows) of
    ``csrc/permuto_scatter.cu``."""
    from . import _build
    lib = _build.load("permuto_scatter")
    i32p = ctypes.POINTER(ctypes.c_int32)
    grad = lib.pagnerf_table_grad
    grad.argtypes = [ctypes.c_void_p] * 7 + [i32p] * 2 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
    grad.restype = ctypes.c_int
    scratch = lib.pagnerf_table_grad_scratch
    scratch.argtypes = [i32p] * 2 + [ctypes.c_int64] * 5
    scratch.restype = ctypes.c_int64
    dbary = lib.pagnerf_gather_dbary
    dbary.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
    dbary.restype = ctypes.c_int
    rows = lib.pagnerf_scatter_rows
    rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    rows.restype = ctypes.c_int
    return grad, scratch, dbary, rows


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _launch(src: torch.Tensor, num_tables: int, idx: torch.Tensor,
            bary: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gather kernel on ``src``: one table stack [L, C, F]
    (``num_tables`` 1) or the packed rows [L, C, 2F] of two (2), in bary's
    dtype or (the bf16 read) bfloat16 rows with float32 bary; outputs in
    bary's dtype."""
    l, c, w = src.shape
    f = w // num_tables
    n = idx.shape[2]
    outs = tuple(torch.empty((l, f, n), dtype=bary.dtype, device=idx.device)
                 for _ in range(num_tables))
    if n == 0:
        return outs
    fn = _kernel()
    with torch.cuda.device(idx.device):
        err = fn(src.data_ptr(), idx.data_ptr(), bary.data_ptr(), outs[0].data_ptr(),
                 outs[-1].data_ptr(), l, c, n, f, num_tables,
                 _READ_CODE[(src.dtype, bary.dtype)], idx.shape[1], _stream(idx.device))
    _raise_on(err, "permuto_gather")
    return outs


# Per-level accumulation of the scatter kernel (``csrc/permuto_scatter.cu``,
# "Accuracy"): SHARED sums a block's events per row in shared memory, then
# one float64 atomic per touched row; GLOBAL one float64 atomic per warp run
# of equal rows; FLOAT one float32 vector atomic per event, with an addend
# count that sends rows of more than 120 addends to an exact float64 redo.
# WINDOW first merges each thread's run of consecutive samples in
# registers, equal rows in any vertex slot ("Window levels"), then adds into
# FLOAT's float32 rows, one vector atomic per merged row.
SHARED, FLOAT, GLOBAL, WINDOW = 0, 1, 2, 3
MODES = (SHARED, FLOAT, GLOBAL, WINDOW)
SHARED_MAX_ROWS = 1 << 14     # live rows of the levels SHARED serves by default
MAX_LEVELS = 64               # levels one scatter or encode launch takes


def level_modes(rows: Tuple[int, ...], capacity: int, modes=None) -> Tuple[int, ...]:
    """The scatter kernel's accumulation per level: ``modes`` as given, or by
    default SHARED for a direct-indexed level of at most ``SHARED_MAX_ROWS``
    live rows (a few rows there take ~1e5 events each), GLOBAL for a larger
    direct level, FLOAT for a hashed level (live rows = capacity). The choice
    moves time, never the result's accuracy contract."""
    if modes is None:
        return tuple(FLOAT if r >= capacity else SHARED if r <= SHARED_MAX_ROWS
                     else GLOBAL for r in rows)
    modes = tuple(int(m) for m in modes)
    if len(modes) != len(rows) or any(m not in MODES for m in modes):
        raise ValueError(f"modes must hold {len(rows)} of SHARED={SHARED}, "
                         f"FLOAT={FLOAT}, GLOBAL={GLOBAL}, WINDOW={WINDOW}; got {modes}")
    return modes


def _launch_grad(idx: torch.Tensor, bary: torch.Tensor, gs, capacity: int,
                 rows_used=None, modes=None):
    """One scatter over all levels into float32 outputs that the kernels
    write whole; ``modes`` as in ``level_modes``."""
    l, v, n = idx.shape
    f = gs[0].shape[1]
    if l > MAX_LEVELS:
        raise ValueError(f"the scatter kernel takes at most {MAX_LEVELS} levels, got {l}")
    rows = live_rows(rows_used, l, capacity)
    modes = level_modes(rows, capacity, modes)
    if n == 0:
        return tuple(torch.zeros((l, capacity, f), dtype=torch.float32,
                                 device=idx.device) for _ in gs)
    c_modes = (ctypes.c_int32 * l)(*modes)
    c_rows = (ctypes.c_int32 * l)(*rows)
    grad, scratch_bytes, _, _ = _scatter_kernels()
    nbytes = scratch_bytes(c_modes, c_rows, l, capacity, n, f, len(gs))
    if nbytes < 0:
        raise ValueError(f"scatter kernel refuses modes {modes} / rows {rows}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=idx.device)
    outs = tuple(torch.empty((l, capacity, f), dtype=torch.float32,
                             device=idx.device) for _ in gs)
    with torch.cuda.device(idx.device):
        err = grad(idx.data_ptr(), bary.data_ptr(), gs[0].data_ptr(),
                   gs[-1].data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(),
                   scratch.data_ptr(), c_modes, c_rows, l, capacity, n, f, len(gs), v,
                   _stream(idx.device))
    _raise_on(err, "permuto_scatter table_grad")
    return outs


# ------------------------------------------------------------ kernel wrappers
def multilevel_table_grad(idx: torch.Tensor, bary: torch.Tensor, g: torch.Tensor,
                          capacity: int, rows_used=None, modes=None) -> torch.Tensor:
    """Table gradient [L, C, F] float32 from idx [L, V, N] int32, bary [L, V, N]
    and g [L, F, N] (both float32); ``rows_used`` as in ``live_rows``,
    ``modes`` as in ``level_modes``. CUDA tensors launch the scatter kernel
    (counted in ``.launches``); CPU tensors take ``table_grad_plain``."""
    _check_grad(idx, bary, (g,), capacity)
    if idx.device.type == "cpu":
        level_modes(live_rows(rows_used, idx.shape[0], capacity), capacity, modes)
        return table_grad_plain(idx, bary, g, capacity, rows_used)
    (out,) = _launch_grad(idx, bary, (g,), capacity, rows_used, modes)
    KERNELS["table_grad"].launches += launched()
    return out


def dual_multilevel_table_grad(idx: torch.Tensor, bary: torch.Tensor,
                               g_a: torch.Tensor, g_b: torch.Tensor,
                               capacity: int, rows_used=None, modes=None):
    """Both tables' gradients from one event stream -> (dT_a, dT_b), each
    [L, C, F] float32. One kernel launch (counted in ``.launches``) reads
    idx and bary once for both; CPU tensors take ``dual_table_grad_plain``."""
    _check_grad(idx, bary, (g_a, g_b), capacity)
    if idx.device.type == "cpu":
        level_modes(live_rows(rows_used, idx.shape[0], capacity), capacity, modes)
        return dual_table_grad_plain(idx, bary, g_a, g_b, capacity, rows_used)
    out = _launch_grad(idx, bary, (g_a, g_b), capacity, rows_used, modes)
    KERNELS["dual_table_grad"].launches += launched()
    return out


def multilevel_gather_dbary(tables: torch.Tensor, idx: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """Weight gradient [L, V, N] float32 from tables [L, C, F] (float32, or
    bfloat16 rows: the bf16 read's), idx [L, V, N] int32 and float32 g
    [L, F, N]. CUDA tensors launch the dbary kernel (counted in
    ``.launches``); CPU tensors take ``gather_dbary_plain``."""
    _check_dbary(tables, idx, g)
    if idx.device.type == "cpu":
        return gather_dbary_plain(tables, idx, g)
    l, c, f = tables.shape
    v, n = idx.shape[1:]
    out = torch.empty((l, v, n), dtype=torch.float32, device=idx.device)
    if n == 0:
        return out
    _, _, dbary, _ = _scatter_kernels()
    with torch.cuda.device(idx.device):
        err = dbary(tables.data_ptr(), idx.data_ptr(), g.data_ptr(),
                    out.data_ptr(), l, c, n, f, v, _DTYPE_CODE[tables.dtype],
                    _stream(idx.device))
    _raise_on(err, "permuto_scatter dbary")
    KERNELS["dbary"].launches += launched()
    return out


# ------------------------------------------------------------ autograd
def dbary_rows(tables: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The rows the dbary of a gather (or encode) of ``tables`` reads: the
    bf16 read's bfloat16 rows (kept, ``table_pack.rows_as``), or float32."""
    if bf16:
        return table_pack.rows_as(tables, torch.bfloat16)
    return tables.float().contiguous()


class _Gather(torch.autograd.Function):
    """Single-table gather; backward = table scatter (+ dbary on request)."""

    @staticmethod
    def forward(ctx, tables, idx, bary, rows_used, modes, bf16):
        ctx.save_for_backward(tables, idx, bary)
        ctx.plan = (rows_used, modes)
        ctx.bf16 = bf16
        if tables.device.type == "cpu":
            return multilevel_gather_plain(tables, idx, bary, bf16)
        src = table_pack.rows_as(tables, torch.bfloat16) if bf16 else tables
        (out,) = _launch(src, 1, idx, bary)
        KERNELS["gather"].launches += launched()
        return out

    @staticmethod
    def backward(ctx, g):
        tables, idx, bary = ctx.saved_tensors
        g = g.float().contiguous()
        dtables = dbary = None
        if ctx.needs_input_grad[0]:
            dtables = multilevel_table_grad(idx, bary.float().contiguous(), g,
                                            tables.shape[1], *ctx.plan).to(tables.dtype)
        if ctx.needs_input_grad[2]:
            dbary = multilevel_gather_dbary(dbary_rows(tables, ctx.bf16), idx,
                                            g).to(bary.dtype)
        return dtables, None, dbary, None, None, None


class _DualGather(torch.autograd.Function):
    """Dual-table gather at shared idx/bary; backward = one dual scatter for
    both tables, dbary from the A side only (B's weights are stop-gradient)."""

    @staticmethod
    def forward(ctx, tables_a, tables_b, idx, bary, rows_used, modes, bf16):
        ctx.save_for_backward(tables_a, idx, bary)
        ctx.plan = (rows_used, modes)
        ctx.capacity = tables_b.shape[1]
        ctx.dtype_b = tables_b.dtype
        ctx.bf16 = bf16
        if tables_a.device.type == "cpu":
            # a fresh pack: the kept copy sees a table's in-place writes only
            # through its version counter, which writes through ``.data``
            # (as gradcheck's perturbations) do not move
            return dual_gather_packed_plain(torch.cat((tables_a, tables_b), dim=2), idx, bary,
                                            bf16)
        src = table_pack.packed_tables(tables_a, tables_b,
                                       torch.bfloat16 if bf16 else tables_a.dtype)
        out = _launch(src, 2, idx, bary)
        KERNELS["dual_gather"].launches += launched()
        return out

    @staticmethod
    def backward(ctx, g_a, g_b):
        tables_a, idx, bary = ctx.saved_tensors
        l, c, f = tables_a.shape
        n = idx.shape[2]
        zeros = lambda: torch.zeros((l, f, n), dtype=torch.float32, device=idx.device)
        g_a = zeros() if g_a is None else g_a.float().contiguous()
        g_b = zeros() if g_b is None else g_b.float().contiguous()
        dta = dtb = dbary = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dta, dtb = dual_multilevel_table_grad(
                idx, bary.float().contiguous(), g_a, g_b, ctx.capacity, *ctx.plan)
            dta, dtb = dta.to(tables_a.dtype), dtb.to(ctx.dtype_b)
        if ctx.needs_input_grad[3]:
            dbary = multilevel_gather_dbary(dbary_rows(tables_a, ctx.bf16), idx,
                                            g_a).to(bary.dtype)
        return dta, dtb, None, dbary, None, None, None


def multilevel_table_gather(tables: torch.Tensor, idx: torch.Tensor,
                            bary: torch.Tensor, rows_used=None,
                            modes=None) -> torch.Tensor:
    """tables [L, C, F], idx [L, V, N] int32, bary [L, V, N] -> [L, F, N],
    differentiable in tables and bary. CUDA tensors launch the kernel
    (counted in ``.launches``); CPU tensors take ``multilevel_gather_plain``.
    ``rows_used`` (per level, see ``live_rows``; it must cover every index of
    its level) and ``modes`` (``level_modes``) go to the backward's
    table-gradient scatter. Under ``PAGNERF_BF16_GATHER=1`` float32 tables
    are read as bfloat16 rows (module docstring)."""
    _check((tables,), idx, bary)
    return _Gather.apply(tables, idx, bary, rows_used, modes, bf16_rows(tables))


def dual_multilevel_table_gather(tables_a: torch.Tensor, tables_b: torch.Tensor,
                                 idx: torch.Tensor, bary: torch.Tensor,
                                 rows_used=None, modes=None):
    """Two same-shape table stacks at shared idx/bary -> (out_a, out_b), each
    [L, F, N], bit-identical to two single gathers. One kernel launch reads
    both tables' entries of a vertex with one load from the packed [L, C,
    2F] rows of ``table_pack.packed_tables`` (kept while the tables are
    unchanged; counted in ``.launches``); CPU tensors take
    ``dual_gather_packed_plain`` on a packed copy made for the call. Differentiable in both tables and in bary,
    whose gradient comes from the A side only; ``rows_used`` and ``modes``
    as in ``multilevel_table_gather``, and so is the bf16 read."""
    _check((tables_a, tables_b), idx, bary)
    return _DualGather.apply(tables_a, tables_b, idx, bary, rows_used, modes,
                             bf16_rows(tables_a))


multilevel_table_gather.launches = 0
dual_multilevel_table_gather.launches = 0
multilevel_table_grad.launches = 0
dual_multilevel_table_grad.launches = 0
multilevel_gather_dbary.launches = 0

# ops/permuto_encoding.py adds its fused encodes ("encode", "dual_encode")
# when it is imported. The wrappers count their launches through this table,
# so a caller that replaces one of the module's names (a spy that records
# calls) leaves the counts on the wrapper objects here.
KERNELS = {"gather": multilevel_table_gather,
           "dual_gather": dual_multilevel_table_gather,
           "table_grad": multilevel_table_grad,
           "dual_table_grad": dual_multilevel_table_grad,
           "dbary": multilevel_gather_dbary}


def launched() -> int:
    """What a wrapper adds to its count after it launched its kernel: 1, or
    0 while a CUDA graph capture records the launch instead (the graph's
    replays run the kernel without the wrapper)."""
    return 0 if torch.cuda.is_current_stream_capturing() else 1


def reset_launches() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "launches_with_idx_bary"):
            fn.launches_with_idx_bary = 0
