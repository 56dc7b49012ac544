"""Exact linear assignment on the device (counterpart of
``pagnerf_tpu/ops/assignment.py:41 lap_assign``).

The label-to-slot matching of the instance losses is solved per image by
Jonker-Volgenant shortest augmenting paths with dual potentials: for each
present row in order, a Dijkstra over the columns settles the cheapest
unsettled column (``argmin``, ties to the lowest index) and relaxes the
unsettled ones through the owner of the settled one, until it settles a
free column (at most M + 1 steps); the potentials take the dual update and
the alternating path flips. The result is exact, as scipy's
``linear_sum_assignment`` (the same algorithm), and since every float32
operation follows the JAX package's in its order, the matchings equal the
JAX package's, ties included.

``lap_assign`` takes a batch (cost [B, K, M] float32, present [B, K] bool;
a [K, M] cost is a batch of one) and returns [B, K] int64 columns, 0 for a
row that takes no part; at most M present rows take part, the lowest-indexed
ones. For CUDA tensors it launches the kernel ``pagnerf_lap_assign`` of
``csrc/lap_assign.cu`` (one thread block per image; counted in
``.launches``), which reads nothing back to the host, so the trainer's
fused step can hold it in a CUDA graph. CPU tensors take
``lap_assign_plain``, the same algorithm with Python loops (it reads the
argmin and the path back at every step).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import table_gather

_BIG = 1e30


def _solve_plain(cost: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """One image: cost [K, M] float32, present [K] bool -> [K] int64. Adds
    its Dijkstra steps to ``lap_assign_plain.steps``."""
    k, m = cost.shape
    dev = cost.device
    u = torch.zeros(k, dtype=torch.float32, device=dev)
    v = torch.zeros(m, dtype=torch.float32, device=dev)
    row4col = torch.full((m,), -1, dtype=torch.int64, device=dev)
    col4row = torch.full((k,), -1, dtype=torch.int64, device=dev)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    active, taken = [], 0
    for p in present.tolist():
        active.append(bool(p) and taken < m)
        taken += int(bool(p))
    for r in range(k):
        if not active[r]:
            continue
        # Dijkstra from row r over the columns
        sp = (cost[r] - u[r]) - v
        path = torch.full((m,), r, dtype=torch.int64, device=dev)
        sc = torch.zeros(m, dtype=torch.bool, device=dev)
        sink, lowest = -1, torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(m + 1):
            lap_assign_plain.steps += 1
            cand = torch.where(sc, big, sp)
            j = int(torch.argmin(cand))
            lowest = cand[j]
            sc[j] = True
            owner = int(row4col[j])
            if owner < 0:
                sink = j
                break
            nd = ((lowest + cost[owner]) - u[owner]) - v
            better = ~sc & (nd < sp)
            sp = torch.where(better, nd, sp)
            path = torch.where(better, owner, path)
        # dual update: the tree's rows (owners of settled columns), row r,
        # the settled columns
        own = col4row.clamp(0, m - 1)
        tree = (col4row >= 0) & sc[own]
        u = u + torch.where(tree, lowest - sp[own], 0.0)
        u[r] = u[r] + lowest
        v = v - torch.where(sc, lowest - sp, 0.0)
        # flip the alternating path back from the free column
        j, steps = sink, 0
        while j >= 0 and steps <= m:
            i = int(path[j])
            nxt = -1 if i == r else int(col4row[i])
            row4col[j] = i
            col4row[i] = j
            j, steps = nxt, steps + 1
    act = torch.tensor(active, dtype=torch.bool, device=dev)
    return torch.where(act, col4row.clamp(min=0), 0)


def lap_assign_plain(cost: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Plain version: cost [B, K, M], present [B, K] -> [B, K] int64, one
    image after the other. ``lap_assign_plain.steps`` counts the call's
    Dijkstra steps (columns settled): the work the data asked for."""
    lap_assign_plain.steps = 0
    out = torch.zeros(cost.shape[:2], dtype=torch.int64, device=cost.device)
    for b in range(cost.shape[0]):
        out[b] = _solve_plain(cost[b].float(), present[b])
    return out


lap_assign_plain.steps = 0


@functools.cache
def _kernel():
    from . import _build
    fn = _build.load("lap_assign").pagnerf_lap_assign
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(k: int, m: int) -> int:
    """Dynamic shared memory of one block: u, col4row [K]; v, sp, row4col,
    path, settled [M] (4 bytes each)."""
    return 8 * k + 20 * m


def lap_assign(cost: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Minimum-cost assignment of each image's present rows of ``cost``
    [B, K, M] float32 (finite; callers map non-finite costs first) to
    distinct columns; ``present`` [B, K] bool. Returns [B, K] int64 (0 for
    rows that take no part). A [K, M] cost and [K] present give [K]. CUDA
    tensors launch the kernel (counted in ``.launches``); CPU tensors take
    ``lap_assign_plain``."""
    single = cost.dim() == 2
    if single:
        cost, present = cost[None], present[None]
    if cost.dim() != 3 or present.shape != cost.shape[:2]:
        raise ValueError(f"cost must be [B, K, M] and present [B, K], got "
                         f"{tuple(cost.shape)} and {tuple(present.shape)}")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    if present.dtype != torch.bool:
        raise TypeError(f"present must be bool, got {present.dtype}")
    cost, present = cost.contiguous(), present.contiguous()
    table_gather._check_device((cost, present))
    if cost.device.type == "cpu":
        out = lap_assign_plain(cost, present)
    else:
        b, k, m = cost.shape
        if smem_bytes(k, m) > 48 * 1024:
            raise ValueError(f"lap_assign: K = {k}, M = {m} need "
                             f"{smem_bytes(k, m)} bytes of shared memory (at most 49152)")
        out = torch.empty((b, k), dtype=torch.int64, device=cost.device)
        if b:
            with torch.cuda.device(cost.device):
                err = _kernel()(cost.data_ptr(), present.data_ptr(), out.data_ptr(),
                                b, k, m, table_gather._stream(cost.device))
            table_gather._raise_on(err, "lap_assign")
            lap_assign.launches += table_gather.launched()
    return out[0] if single else out


lap_assign.launches = 0
