"""The packed rows of two table stacks that the dual kernels read.

The dual encode (``csrc/permuto_encode.cu``) and the dual gather
(``csrc/permuto_gather.cu``) read the main grid's and the delta grid's
features of a vertex with one load from a packed [L, C, 2F] copy of the two
[L, C, F] stacks, whose row c is table a's row c followed by table b's (the
JAX package's dual gather packs its rows so, ``pagnerf_tpu/ops/
pallas_gather.py:119``). Both kernels take the copy from here, so at most one
lives at a time.
"""
from __future__ import annotations

import weakref

import torch

# The one packed copy: (weak references to the two tables, their keys at
# the copy, the copy).
_packed_copy = None


def _table_key(t: torch.Tensor):
    return (t.data_ptr(), t._version, tuple(t.shape), t.dtype, t.device)


def packed_tables(tables_a: torch.Tensor, tables_b: torch.Tensor) -> torch.Tensor:
    """``torch.cat((tables_a, tables_b), dim=2)`` [L, C, 2F], the rows the
    dual kernels read with one load a vertex. One copy is kept and returned
    again while both tables are the same tensors, unchanged: an in-place
    update (the optimizer's ``add_``, a checkpoint's ``copy_``) bumps a
    table's ``_version``, a new tensor fails the identity check, and either
    rebuilds the copy. At most one copy lives at a time. (A CUDA graph's
    replay writes the tables without the host code that bumps their
    versions; the trainer bumps them around its captures and replays.)"""
    global _packed_copy
    keys = (_table_key(tables_a), _table_key(tables_b))
    if _packed_copy is not None:
        refs, old_keys, packed = _packed_copy
        if (old_keys == keys and refs[0]() is tables_a and refs[1]() is tables_b):
            return packed
    _packed_copy = None                  # frees the old copy before the new one
    with torch.no_grad():
        packed = torch.cat((tables_a, tables_b), dim=2)
    _packed_copy = ((weakref.ref(tables_a), weakref.ref(tables_b)), keys, packed)
    return packed
