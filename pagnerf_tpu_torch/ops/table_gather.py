"""Multi-level table gather (counterpart of ``pagnerf_tpu/ops/table_gather.py``
and ``pagnerf_tpu/ops/pallas_gather.py``), forward only.

    out[l, f, n] = sum_v bary[l, v, n] * tables[l, idx[l, v, n], f]

``multilevel_table_gather`` (one table stack) and
``dual_multilevel_table_gather`` (two stacks read at shared indices and
weights: the main grid and the delta grid) launch the CUDA kernel
``csrc/permuto_gather.cu`` for CUDA tensors and take the plain PyTorch
version beside it (``multilevel_gather_plain`` / ``dual_gather_plain``) for
CPU tensors. There is no other fallback: a CUDA tensor the kernel does not
take raises.

Contract (both paths): tables ``[L, C, F]`` with F in (1, 2, 4), ``idx
[L, 4, N]`` int32 with entries in ``[0, C)``, ``bary [L, 4, N]``; tables and
bary in one dtype, float32 or bfloat16; all contiguous, on one device.
Outputs ``[L, F, N]`` in that dtype. Products and sums run in float32 and
round once to the output dtype. The kernel does not check that idx lies in
``[0, C)``; the lattice (``ops/permuto_encoding.py``) guarantees it.

Forward only: the table and weight gradients are the next slice's kernels,
so these functions raise if autograd would need a gradient of their inputs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

VERTS = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FEATS = (1, 2, 4)


def multilevel_gather_plain(tables: torch.Tensor, idx: torch.Tensor,
                            bary: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, weight in float32, sum over V, round
    once. tables [L, C, F], idx/bary [L, V, N] -> [L, F, N]."""
    l, c, f = tables.shape
    offs = torch.arange(l, device=idx.device, dtype=torch.int64)[:, None, None] * c
    rows = (idx.to(torch.int64) + offs).reshape(-1)                  # [L*V*N]
    feats = torch.index_select(tables.reshape(l * c, f), 0, rows)    # [L*V*N, F]
    feats = feats.reshape(*idx.shape, f).float()                     # [L, V, N, F]
    out = torch.sum(feats * bary.float()[..., None], dim=1)         # [L, N, F]
    return out.permute(0, 2, 1).contiguous().to(tables.dtype)


def dual_gather_plain(tables_a: torch.Tensor, tables_b: torch.Tensor,
                      idx: torch.Tensor, bary: torch.Tensor):
    """Plain PyTorch dual version: two single gathers at shared idx/bary."""
    return (multilevel_gather_plain(tables_a, idx, bary),
            multilevel_gather_plain(tables_b, idx, bary))


def _check(tables: Tuple[torch.Tensor, ...], idx: torch.Tensor,
           bary: torch.Tensor) -> None:
    t0 = tables[0]
    if t0.dim() != 3:
        raise ValueError(f"tables must be [L, C, F], got {tuple(t0.shape)}")
    l, _, f = t0.shape
    if f not in _FEATS:
        raise ValueError(f"feature width {f} not supported; use one of {_FEATS}")
    if t0.dtype not in _DTYPE_CODE:
        raise TypeError(f"tables must be float32 or bfloat16, got {t0.dtype}")
    for t in tables[1:]:
        if t.shape != t0.shape or t.dtype != t0.dtype:
            raise ValueError("dual tables must share shape and dtype")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if bary.dtype != t0.dtype:
        raise TypeError(f"bary dtype {bary.dtype} != tables dtype {t0.dtype}")
    if idx.dim() != 3 or idx.shape[:2] != (l, VERTS) or bary.shape != idx.shape:
        raise ValueError(f"idx and bary must both be [L={l}, {VERTS}, N], got "
                         f"{tuple(idx.shape)} and {tuple(bary.shape)}")
    devices = {t.device for t in (*tables, idx, bary)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    if not all(t.is_contiguous() for t in (*tables, idx, bary)):
        raise ValueError("tables, idx and bary must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*tables, bary)):
        raise RuntimeError("the table gather is forward only; run it under "
                           "torch.no_grad() or torch.inference_mode()")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t0.device}")


@functools.cache
def _kernel():
    from . import _build
    fn = _build.load("permuto_gather").pagnerf_permuto_gather
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(tables: Tuple[torch.Tensor, ...], idx: torch.Tensor,
            bary: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    l, c, f = tables[0].shape
    n = idx.shape[2]
    outs = tuple(torch.empty((l, f, n), dtype=tables[0].dtype,
                             device=idx.device) for _ in tables)
    if n == 0:
        return outs
    fn = _kernel()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = fn(tables[0].data_ptr(), tables[-1].data_ptr(), idx.data_ptr(),
                 bary.data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(),
                 l, c, n, f, len(tables), _DTYPE_CODE[tables[0].dtype], stream)
    if err != 0:
        raise RuntimeError(f"permuto_gather kernel launch failed: cudaError_t {err}")
    return outs


def multilevel_table_gather(tables: torch.Tensor, idx: torch.Tensor,
                            bary: torch.Tensor) -> torch.Tensor:
    """tables [L, C, F], idx [L, 4, N] int32, bary [L, 4, N] -> [L, F, N].
    CUDA tensors launch the kernel (counted in ``.launches``); CPU tensors
    take ``multilevel_gather_plain``."""
    _check((tables,), idx, bary)
    if tables.device.type == "cpu":
        return multilevel_gather_plain(tables, idx, bary)
    (out,) = _launch((tables,), idx, bary)
    multilevel_table_gather.launches += 1
    return out


def dual_multilevel_table_gather(tables_a: torch.Tensor, tables_b: torch.Tensor,
                                 idx: torch.Tensor, bary: torch.Tensor):
    """Two same-shape table stacks at shared idx/bary -> (out_a, out_b), each
    [L, F, N], bit-identical to two single gathers. One kernel launch reads
    both tables' entries of a vertex in one pass (counted in ``.launches``);
    CPU tensors take ``dual_gather_plain``."""
    _check((tables_a, tables_b), idx, bary)
    if tables_a.device.type == "cpu":
        return dual_gather_plain(tables_a, tables_b, idx, bary)
    out = _launch((tables_a, tables_b), idx, bary)
    dual_multilevel_table_gather.launches += 1
    return out


multilevel_table_gather.launches = 0
dual_multilevel_table_gather.launches = 0
