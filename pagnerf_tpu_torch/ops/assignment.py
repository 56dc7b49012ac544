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
``csrc/lap_assign.cu`` (one warp per image, up to ``MAX_WARPS`` images a
block, the present rows' costs staged in shared memory where they fit:
``launch_geometry``; counted in ``.launches``), which reads nothing back to
the host, so the trainer's fused step can hold it in a CUDA graph. CPU tensors take
``lap_assign_plain``, the same algorithm with Python loops (it reads the
argmin and the path back at every step).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

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
def _kernels():
    """(solve, empty) C entries of ``csrc/lap_assign.cu``."""
    from . import _build
    lib = _build.load("lap_assign")
    solve, empty = lib.pagnerf_lap_assign, lib.pagnerf_lap_assign_empty
    solve.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    empty.argtypes = [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    solve.restype = empty.restype = ctypes.c_int
    return solve, empty


# The kernel's limits (``csrc/lap_assign.cu``): shared memory of one block,
# images a block holds, columns a warp keeps in registers (8 a lane).
SMEM_MAX = 232448
MAX_WARPS = 4
REG_COLUMNS = 256


def smem_bytes(k: int, m: int, staged: bool) -> int:
    """Shared memory of one image's warp: u, col4row and the present rows'
    indices (4 bytes each) for min(K, M) rows; sp, v, path, row4col and the
    settled flags (4 bytes each) of M columns rounded up to 32 when M is
    above ``REG_COLUMNS`` (else they live in registers); and, staged, the
    min(K, M) x M float32 cost rows."""
    p = min(k, m)
    cols = 20 * (-(-m // 32) * 32) if m > REG_COLUMNS else 0
    return 12 * p + cols + (4 * p * m if staged else 0)


def launch_geometry(b: int, k: int, m: int) -> Tuple[int, bool, int]:
    """The kernel's plan for B images of [K, M] costs: (images a block holds,
    whether the present rows' costs are staged in shared memory, shared
    bytes of one image's warp). The rows are staged wherever one image's
    fit in ``SMEM_MAX``; a block holds as many images (at most
    ``MAX_WARPS``, at most B) as fit with theirs. Raises ``ValueError``
    where one image's state alone does not fit."""
    if k <= 0 or m <= 0:
        raise ValueError(f"lap_assign: K and M must be positive, got K = {k}, M = {m}")
    staged = smem_bytes(k, m, True) <= SMEM_MAX
    per_warp = smem_bytes(k, m, staged)
    if per_warp > SMEM_MAX:
        raise ValueError(f"lap_assign: K = {k}, M = {m} need {per_warp} bytes of "
                         f"shared memory for one image (at most {SMEM_MAX})")
    warps = max(1, min(MAX_WARPS, b, SMEM_MAX // max(per_warp, 1)))
    return warps, staged, per_warp


def _checked(cost: torch.Tensor, present: torch.Tensor):
    """The wrapper's checks; (cost, present) as [B, K, M] / [B, K],
    contiguous, and whether a [K, M] cost was given."""
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
    return cost, present, single


def lap_assign(cost: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Minimum-cost assignment of each image's present rows of ``cost``
    [B, K, M] float32 (finite; callers map non-finite costs first) to
    distinct columns; ``present`` [B, K] bool. Returns [B, K] int64 (0 for
    rows that take no part). A [K, M] cost and [K] present give [K]. CUDA
    tensors launch the kernel at ``launch_geometry``'s plan (counted in
    ``.launches``); CPU tensors take ``lap_assign_plain``."""
    cost, present, single = _checked(cost, present)
    if cost.device.type == "cpu":
        out = lap_assign_plain(cost, present)
    else:
        b, k, m = cost.shape
        warps, staged, _ = launch_geometry(b, k, m)
        out = torch.empty((b, k), dtype=torch.int64, device=cost.device)
        if b:
            with torch.cuda.device(cost.device):
                err = _kernels()[0](cost.data_ptr(), present.data_ptr(), out.data_ptr(),
                                    b, k, m, warps, int(staged),
                                    table_gather._stream(cost.device))
            table_gather._raise_on(err, "lap_assign")
            lap_assign.launches += table_gather.launched()
    return out[0] if single else out


lap_assign.launches = 0


def empty_launch(cost: torch.Tensor, present: torch.Tensor) -> None:
    """The floor under ``lap_assign``'s time: an empty kernel launched
    through the same checks at the same plan (blocks, threads, shared
    memory), on CUDA tensors. Counted nowhere."""
    cost, present, _ = _checked(cost, present)
    if cost.device.type != "cuda":
        raise ValueError("empty_launch needs CUDA tensors")
    b, k, m = cost.shape
    warps, staged, _ = launch_geometry(b, k, m)
    with torch.cuda.device(cost.device):
        err = _kernels()[1](b, k, m, warps, int(staged), table_gather._stream(cost.device))
    table_gather._raise_on(err, "lap_assign empty")
