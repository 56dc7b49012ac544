"""Row scatter-add (counterpart of ``pagnerf_tpu/ops/pallas_scatter.py:84
scatter_rows_matmul``):

    out[r, :] = sum_{m : row[m] = r} vals[m, :]

``row`` [M] int32, ``vals`` [M, 128] float32, ``out`` [num_rows, 128]
float32. Rows outside ``[0, num_rows)`` (the -1 padding) are dropped; M = 0
gives zeros. The TPU kernel rounds ``vals`` to bfloat16 for the MXU and sums
in float32; here the float32 values are summed exactly as given, in float64,
and rounded once, so each entry is within one float32 rounding of the exact
sum (the contract is 64 eps_f32 of its sum of |vals|).

``scatter_rows`` launches the CUDA kernel ``pagnerf_scatter_rows`` of
``csrc/permuto_scatter.cu`` for CUDA tensors (counted in ``.launches``) and
takes ``scatter_rows_plain`` for CPU tensors. Nothing on the training or
render path calls it, as in the JAX package, where it is a test reference.
"""
from __future__ import annotations

import torch

from . import table_gather

WIDTH = 128


def scatter_rows_plain(row: torch.Tensor, vals: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Plain version: float64 ``index_add_`` of the in-range rows, rounded
    once to float32."""
    keep = (row >= 0) & (row < num_rows)
    out = torch.zeros((num_rows, vals.shape[1]), dtype=torch.float64,
                      device=vals.device)
    out.index_add_(0, row[keep].long(), vals[keep].double())
    return out.float()


def _check(row: torch.Tensor, vals: torch.Tensor, num_rows: int) -> None:
    if row.dtype != torch.int32:
        raise TypeError(f"row must be int32, got {row.dtype}")
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if row.dim() != 1 or vals.dim() != 2 or vals.shape != (row.shape[0], WIDTH):
        raise ValueError(f"row must be [M] and vals [M, {WIDTH}], got "
                         f"{tuple(row.shape)} and {tuple(vals.shape)}")
    if not isinstance(num_rows, int) or num_rows <= 0:
        raise ValueError(f"num_rows must be a positive int, got {num_rows!r}")
    table_gather._check_device((row, vals))


def scatter_rows(row: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Sum ``vals`` [M, 128] float32 into rows ``row`` [M] int32 of a
    [num_rows, 128] float32 output; out-of-range rows are dropped. CUDA
    tensors launch the kernel (counted in ``.launches``; M = 0 launches
    nothing and returns zeros); CPU tensors take ``scatter_rows_plain``."""
    _check(row, vals, num_rows)
    if row.device.type == "cpu":
        return scatter_rows_plain(row, vals, num_rows)
    out = torch.empty((num_rows, WIDTH), dtype=torch.float32, device=row.device)
    m = row.shape[0]
    if m == 0:
        return out.zero_()
    acc = torch.empty((num_rows, WIDTH), dtype=torch.float64, device=row.device)
    _, _, _, kernel = table_gather._scatter_kernels()
    with torch.cuda.device(row.device):
        err = kernel(row.data_ptr(), vals.data_ptr(), out.data_ptr(), acc.data_ptr(),
                     m, num_rows, table_gather._stream(row.device))
    table_gather._raise_on(err, "permuto_scatter scatter_rows")
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0
