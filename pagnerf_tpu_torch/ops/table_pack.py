"""The copies of table stacks that the kernels read in place of the tables.

The dual encode (``csrc/permuto_encode.cu``) and the dual gather
(``csrc/permuto_gather.cu``) read the main grid's and the delta grid's
features of a vertex with one load from a packed [L, C, 2F] copy of the two
[L, C, F] stacks, whose row c is table a's row c followed by table b's (the
JAX package's dual gather packs its rows so, ``pagnerf_tpu/ops/
pallas_gather.py:119``). Both kernels take the copy from here, so at most one
lives at a time.

The bf16 table-read path (``PAGNERF_BF16_GATHER=1``, ``ops/table_gather.py``)
reads float32 tables' rows rounded to bfloat16: the dual kernels from the
packed copy made in bfloat16, the single ones from a bfloat16 copy of one
stack (``rows_as``), of which at most one lives at a time too.
"""
from __future__ import annotations

import weakref
from typing import Optional

import torch

# The one packed copy and the one single-stack copy: (weak references to
# the tables, their keys and the copy's dtype at the copy, the copy).
_packed_copy = None
_rows_copy = None


def _table_key(t: torch.Tensor):
    return (t.data_ptr(), t._version, tuple(t.shape), t.dtype, t.device)


def _keys(tables, dtype) -> tuple:
    return tuple(_table_key(t) for t in tables) + (dtype,)


def _hit(slot, tables, dtype) -> Optional[torch.Tensor]:
    """The copy in ``slot`` if it was made from these same tensors,
    unchanged, in ``dtype``; else None."""
    if slot is not None:
        refs, keys, copy = slot
        if keys == _keys(tables, dtype) and all(r() is t for r, t in zip(refs, tables)):
            return copy
    return None


def _slot(tables, dtype, copy) -> tuple:
    return tuple(weakref.ref(t) for t in tables), _keys(tables, dtype), copy


def packed_tables(tables_a: torch.Tensor, tables_b: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.cat((tables_a, tables_b), dim=2)`` [L, C, 2F] in ``dtype``
    (default the tables'), the rows the dual kernels read with one load a
    vertex. One copy is kept and returned again while both tables are the
    same tensors, unchanged, and the dtype the same: an in-place update (the
    optimizer's ``add_``, a checkpoint's ``copy_``) bumps a table's
    ``_version``, a new tensor fails the identity check, and either
    rebuilds the copy. At most one copy lives at a time. (A CUDA graph's
    replay writes the tables without the host code that bumps their
    versions; the trainer bumps them around its captures and replays.)"""
    global _packed_copy
    dtype = dtype or tables_a.dtype
    packed = _hit(_packed_copy, (tables_a, tables_b), dtype)
    if packed is None:
        _packed_copy = None              # frees the old copy before the new one
        with torch.no_grad():
            packed = torch.cat((tables_a.to(dtype), tables_b.to(dtype)), dim=2)
        _packed_copy = _slot((tables_a, tables_b), dtype, packed)
    return packed


def rows_as(tables: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``tables.to(dtype)``, kept as ``packed_tables`` keeps its copy (one
    at a time, rebuilt when the table changes)."""
    global _rows_copy
    copy = _hit(_rows_copy, (tables,), dtype)
    if copy is None:
        _rows_copy = None
        with torch.no_grad():
            copy = tables.to(dtype)
        _rows_copy = _slot((tables,), dtype, copy)
    return copy
