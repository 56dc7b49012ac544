"""The yardstick's work counts and the card's published peaks.

Every count is of a layer's function, from its inputs and outputs, never
from what one implementation keeps in between: the lattice indices, weights
and ranks that a forward may store for its backward count nowhere, so a
change that fuses or recomputes them keeps the same yardstick.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit: 67
TFLOP/s in float32 outside the tensor cores (both configurations compute in
float32 and PyTorch leaves TF32 off), 3.35 TB/s of HBM.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Sequence

import numpy as np
import torch

F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# the permutohedral lattice of one level and sample: the elevation E @ x
# (4 x 3 multiply-adds), the distances to the remainder-0 point and the
# barycentric weights (4 subtractions and divisions, 5 weight sums of 4
# terms); its backward the transposes of the same products
LATTICE_FLOPS = 24 + 8 + 20
LATTICE_BWD_FLOPS = LATTICE_FLOPS
# the hash grid's corner weights of one level and sample: 3 x (scale, floor,
# fraction) and the 8 products of three factors
HASH_WEIGHT_FLOPS = 9 + 16
PERMUTO_VERTICES, HASH_CORNERS = 4, 8


def least_seconds(flops: float, bytes_: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / F32_FLOPS_PER_S, bytes_ / HBM_BYTES_PER_S)


def permuto_reachable_rows(scales: Sequence[float], capacity: int) -> np.ndarray:
    """Rows of each level's table that coordinates in [-1, 1]^3 can reach:
    the lattice points of a directly indexed level (``4 Dm^3``), the whole
    table of a hashed one."""
    from .reference.ops.permuto_encoding import _E
    bound = float(np.abs(_E).sum(axis=1).max())
    rows = []
    for s in np.asarray(scales, np.float64):
        k_bound = int(np.ceil(bound / float(s))) + 8
        points = 4 * (2 * (k_bound // 4 + 2) + 1) ** 3
        rows.append(min(points, capacity))
    return np.asarray(rows, np.int64)


def encode_fwd_work(n: int, reachable: np.ndarray, feat: int, tables: int,
                    itemsize: int = 4) -> Dict[str, float]:
    """The encode of ``n`` coordinates against ``tables`` stacks of one
    lattice: the coordinates read once, each table's rows read at most
    once (a level's reachable rows, or the 4 n its vertices can touch),
    the features written once; the lattice and each table's weighted sum."""
    levels = len(reachable)
    rows = np.minimum(reachable, PERMUTO_VERTICES * n).sum()
    bytes_ = 12.0 * n + tables * (rows * feat * itemsize + levels * feat * 4.0 * n)
    flops = n * levels * (LATTICE_FLOPS + tables * 2 * PERMUTO_VERTICES * feat)
    return {"bytes": float(bytes_), "flops": float(flops)}


def encode_bwd_work(n: int, reachable: np.ndarray, capacity: int, feat: int, tables: int,
                    coords_grad: bool, itemsize: int = 4) -> Dict[str, float]:
    """The encode's backward: the cotangents and the coordinates read once,
    every table's gradient written once in full; with a coordinate gradient
    also table A's rows read once and dx written once. The products of the
    table gradients, and of dx: the weights' gradient and the lattice's
    backward."""
    levels = len(reachable)
    bytes_ = 12.0 * n + tables * levels * feat * 4.0 * n + tables * levels * capacity * feat * 4.0
    flops = n * levels * tables * 2 * PERMUTO_VERTICES * feat
    if coords_grad:
        rows = np.minimum(reachable, PERMUTO_VERTICES * n).sum()
        bytes_ += rows * feat * itemsize + 12.0 * n
        flops += n * levels * (2 * PERMUTO_VERTICES * feat + LATTICE_BWD_FLOPS)
    return {"bytes": float(bytes_), "flops": float(flops)}


def encode_flops_per_sample(kind: str, levels: int, feat: int, tables: int,
                            grad: bool, coords_grad: bool) -> float:
    """The model FLOPs of one sample's encode, forward and (``grad``) backward."""
    if kind == "hash":
        fwd = levels * (HASH_WEIGHT_FLOPS + tables * 2 * HASH_CORNERS * feat)
        bwd = levels * tables * 2 * HASH_CORNERS * feat
        if coords_grad:
            bwd += levels * (2 * HASH_CORNERS * feat + HASH_WEIGHT_FLOPS)
    else:
        fwd = levels * (LATTICE_FLOPS + tables * 2 * PERMUTO_VERTICES * feat)
        bwd = levels * tables * 2 * PERMUTO_VERTICES * feat
        if coords_grad:
            bwd += levels * (2 * PERMUTO_VERTICES * feat + LATTICE_BWD_FLOPS)
    return float(fwd + (bwd if grad else 0))


def decoder_flops_per_sample(nef: torch.nn.Module, channels: FrozenSet[str]) -> float:
    """The forward FLOPs of one sample through the decoders and heads that
    ``channels`` evaluate: 2 Cin Cout for each linear layer the reference
    NeF runs, found by running it on a few samples."""
    from .reference.models.decoder import DenseT
    total = [0]
    hooks = [m.register_forward_hook(lambda mod, inp, out: total.__setitem__(
        0, total[0] + 2 * mod.kernel.shape[0] * mod.kernel.shape[1]))
        for m in nef.modules() if isinstance(m, DenseT)]
    try:
        dev = next(nef.parameters()).device
        x = torch.zeros(3, 4, device=dev)
        d = torch.full((3, 4), 3 ** -0.5, device=dev)
        with torch.no_grad():
            nef(x, d, frozenset(channels), None)
    finally:
        for h in hooks:
            h.remove()
    return float(total[0])


def step_flops_per_sample(decoder_fwd: float, encode: float, grad: bool) -> float:
    """One kept sample's model FLOPs: the decoders forward, twice again in
    the backward (the gradients of the activations and of the weights),
    and the encodes."""
    return decoder_fwd * (3.0 if grad else 1.0) + encode
