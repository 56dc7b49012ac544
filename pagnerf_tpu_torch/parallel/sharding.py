"""Ray-axis data parallelism over ``torch.distributed`` (counterpart of
``pagnerf_tpu/parallel/sharding.py``).

One process per rank. Parameters, optimizer state, the occupancy grid and
the LoD weights are replicated; each ``[B, R, ...]`` pixel mode and the
camera-space base rays are split along R, selected by key
(``RAY_SHARDED_KEYS``); per-image arrays (``cam_idx``, view matrices) are
replicated. Where the JAX package lets GSPMD insert the reductions, the
trainer here makes every reduction over the ray axis global by hand
(``train/trainer.py``): each rank's loss is its share of the global loss,
and the gradients are summed once per step.

Every collective goes through ``all_reduce`` or ``broadcast`` below, which
log (tag, elements) in ``RayGroup.log``: the collective audit of
``entry.dryrun_multichip`` reads that log.

Backends: NCCL with one rank per card; gloo on the CPU (the tests); gloo
with several ranks on one card only when asked (``ranks_per_device``). The
trainer's fused step captures NCCL collectives into its CUDA graph; gloo
cannot be captured, so the fused step refuses it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.multiview import PIXEL_MODES

# Batch keys whose axis 1 is the ray axis: the pixel modes and the base
# rays. Dispatch is by key: a replicated per-image array whose second axis
# happens to equal the ray count is not split.
RAY_SHARDED_KEYS = frozenset(PIXEL_MODES) | {"base_rays_origins", "base_rays_dirs"}
_RAY_LEN_KEYS = ("base_rays_origins", "rays_origins", "rgb", "imgs")

# Gradients are summed in buckets of at most this many elements per dtype.
BUCKET_ELEMS = 1 << 24
# A rank's packed buffer is this share of B/n, rounded up to a multiple of
# 8 (``RayGroup.share_buffer``); a rank whose kept samples exceed it is
# cut by a local water-fill and counted (``pack_overflows``; the trainer
# logs a non-zero count at each epoch's readback).
PACK_SHARE_MARGIN = 1.25


@dataclasses.dataclass
class RayGroup:
    """A process group over the ray axis: this process's ``rank`` of
    ``world``, its ``device``, the ``backend``, and ``log``, the (tag,
    elements) of every collective since the last ``log.clear()``.
    ``pack_overflows`` counts, on the device, the packed layouts whose
    rank share overflowed its buffer (read at the step's readback), and
    ``pack_share_max`` the largest share of kept samples a rank's rays
    took, over B / n."""

    rank: int
    world: int
    device: torch.device
    backend: str
    log: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    _overflows: Optional[torch.Tensor] = None
    _share: Optional[torch.Tensor] = None

    @property
    def capturable(self) -> bool:
        """NCCL collectives can be captured into a CUDA graph; gloo's cannot."""
        return self.backend == "nccl"

    def share_buffer(self, budget: int) -> int:
        """The packed buffer of one rank whose rays would take ``budget``
        samples in one process: ``PACK_SHARE_MARGIN`` x ``budget``, a
        multiple of 8, at most the global ``budget x world``."""
        share = int(np.ceil(PACK_SHARE_MARGIN * budget / 8.0)) * 8
        return min(max(share, 8), budget * self.world)

    @property
    def pack_overflows(self) -> torch.Tensor:
        if self._overflows is None:
            self._overflows = torch.zeros((), dtype=torch.int64, device=self.device)
        return self._overflows

    @property
    def pack_share_max(self) -> torch.Tensor:
        if self._share is None:
            self._share = torch.zeros((), dtype=torch.float32, device=self.device)
        return self._share


def devices_present(device_type: str) -> int:
    """Devices a group can place one rank each on: the cards, or the CPU's
    cores."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return os.cpu_count() or 1


def make_group(n: int, rank: int, init_method: str, device: str = "cuda",
               ranks_per_device: int = 1) -> RayGroup:
    """Join rank ``rank`` of an ``n``-rank group (the counterpart of
    ``make_mesh``) through ``init_method`` (``file://<path>`` or
    ``tcp://localhost:<port>``).

    ``device="cuda"``: NCCL, rank r on card r. ``ranks_per_device > 1``
    puts that many ranks on each card over gloo (asked for explicitly: one
    card's check of the collectives). ``device="cpu"``: gloo. Refuses a group
    larger than the devices present (times ``ranks_per_device``)."""
    dev_type = torch.device(device).type
    if ranks_per_device < 1 or (ranks_per_device > 1 and dev_type != "cuda"):
        raise ValueError("ranks_per_device > 1 places several ranks on one card; "
                         "it needs device='cuda'")
    avail = devices_present(dev_type) * ranks_per_device
    if n > avail:
        raise ValueError(
            f"requested a {n}-rank group but only {avail} device(s) are available "
            f"— a silently smaller group would train at reduced parallelism")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a {n}-rank group")
    backend = "nccl" if dev_type == "cuda" and ranks_per_device == 1 else "gloo"
    if dev_type == "cuda":
        dev = torch.device("cuda", rank // ranks_per_device)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
    return RayGroup(rank=rank, world=n, device=dev, backend=backend)


# ------------------------------------------------------------ collectives
def all_reduce(t: torch.Tensor, group: RayGroup, tag: str,
               op: dist.ReduceOp = dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed (or ``op``) over the ranks, in place; logged as ``tag``.
    Every collective of a step goes through here or ``broadcast``."""
    group.log.append((tag, t.numel()))
    dist.all_reduce(t, op=op)
    return t


def broadcast(t: torch.Tensor, group: RayGroup, tag: str, src: int = 0) -> torch.Tensor:
    group.log.append((tag, t.numel()))
    dist.broadcast(t, src=src)
    return t


def _buckets(tensors: Sequence[torch.Tensor], limit: int) -> Iterable[List[int]]:
    """Indices of ``tensors`` in runs of one dtype and at most ``limit``
    elements (a larger tensor alone)."""
    run, size, dtype = [], 0, None
    for i, t in enumerate(tensors):
        if run and (t.dtype != dtype or size + t.numel() > limit):
            yield run
            run, size = [], 0
        run.append(i)
        size += t.numel()
        dtype = t.dtype
    if run:
        yield run


def all_reduce_coalesced(tensors: Sequence[torch.Tensor], group: RayGroup, tag: str,
                         bucket_elems: int = BUCKET_ELEMS) -> List[torch.Tensor]:
    """The sums over the ranks of ``tensors``, in flat buckets (one
    collective per bucket, not per tensor)."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _buckets(tensors, bucket_elems):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce(flat, group, tag)
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def replicate(tensors: Sequence[torch.Tensor], group: RayGroup,
              tag: str = "replicate") -> None:
    """Give every rank rank 0's values of ``tensors``, in place (the
    counterpart of ``replicate_tree``): one broadcast per bucket."""
    tensors = list(tensors)
    for idx in _buckets(tensors, BUCKET_ELEMS):
        # bools travel as bytes (not every backend sends bool)
        flat = broadcast(torch.cat([tensors[i].detach().reshape(-1).to(
            torch.uint8 if tensors[i].dtype == torch.bool else tensors[i].dtype)
            for i in idx]), group, tag)
        with torch.no_grad():
            for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
                tensors[i].copy_(part.view(tensors[i].shape))


def assert_replicated(tensors: Sequence[torch.Tensor], group: RayGroup, tag: str) -> None:
    """Raise unless ``tensors`` hold the same values on every rank: a
    checksum per tensor (its sum and its index-weighted sum, float64),
    reduced by max and by min, must agree."""
    sums = []
    for t in tensors:
        x = t.detach().reshape(-1).to(torch.float64)
        w = torch.arange(1, x.numel() + 1, dtype=torch.float64, device=x.device)
        sums += [x.sum(), (x * w).sum()]
    hi = torch.stack(sums)
    lo = hi.clone()
    all_reduce(hi, group, tag, dist.ReduceOp.MAX)
    all_reduce(lo, group, tag, dist.ReduceOp.MIN)
    if not torch.equal(hi, lo):
        raise RuntimeError(f"{tag}: the ranks hold different values")


# -------------------------------------------------------------- batches
class ShardedBatch(dict):
    """A rank's share of a batch (numpy arrays): its rays of every
    ray-sharded key, the per-image arrays whole. ``ray_len_global`` is the
    global ray count R; this rank's rays are ``ray_slice`` of it."""

    def __init__(self, arrays: Dict, ray_len_global: int, group: RayGroup):
        super().__init__(arrays)
        self.ray_len_global = ray_len_global
        local = ray_len_global // group.world
        self.ray_slice = slice(group.rank * local, (group.rank + 1) * local)


def _ray_len(arrs: Dict[str, np.ndarray]) -> int:
    n = next((arrs[k].shape[1] for k in _RAY_LEN_KEYS if k in arrs and arrs[k].ndim >= 2),
             None)
    if n is None:
        raise ValueError("batch has no recognised ray-mode array to size the ray axis from")
    return n


def shard_ray_batch(batch: Dict, group: RayGroup) -> ShardedBatch:
    """This rank's share of a global host batch: each ray-sharded key's
    ``[:, rank * R/n : (rank + 1) * R/n]``, the rest whole. Raises if the
    ray axis R does not divide by the group's size, or a ray-sharded key's
    axis 1 is not R."""
    arrs = {k: np.asarray(v) for k, v in batch.items()}
    ray_len = _ray_len(arrs)
    if ray_len % group.world != 0:
        raise ValueError(
            f"ray axis {ray_len} is not divisible by the {group.world}-rank group "
            f"— pick num_rays_sampled_per_img as a multiple of the group size")
    local = ray_len // group.world
    sl = slice(group.rank * local, (group.rank + 1) * local)
    out = {}
    for k, arr in arrs.items():
        if k in RAY_SHARDED_KEYS and arr.ndim >= 2:
            if arr.shape[1] != ray_len:
                raise ValueError(f"ray-sharded batch key {k!r} has axis-1 size "
                                 f"{arr.shape[1]}, expected the ray count {ray_len}")
            out[k] = np.ascontiguousarray(arr[:, sl])
        else:
            out[k] = arr
    return ShardedBatch(out, ray_len, group)


def shard_ray_batch_host_local(local_batch: Dict, group: RayGroup) -> ShardedBatch:
    """A batch each rank sampled itself: its ray-sharded keys hold only its
    R/n rays (an independent draw per rank; ray batches are iid pixels, so
    the union is a global random batch), its per-image arrays must be the
    same on every rank. Nothing crosses ranks. Raises on a ray-sharded key
    whose axis 1 is not the local ray count."""
    arrs = {k: np.asarray(v) for k, v in local_batch.items()}
    local = _ray_len(arrs)
    for k, arr in arrs.items():
        if k in RAY_SHARDED_KEYS and arr.ndim >= 2 and arr.shape[1] != local:
            raise ValueError(f"ray-sharded batch key {k!r} has local axis-1 size "
                             f"{arr.shape[1]}, expected the local ray count {local}")
    return ShardedBatch(arrs, local * group.world, group)


def local_rows(x: torch.Tensor, batch: ShardedBatch) -> torch.Tensor:
    """This rank's rows of a [B * R, ...] per-ray draw of the global batch
    (image-major): [B * R/n, ...]."""
    r = batch.ray_len_global
    return x.reshape(-1, r, *x.shape[1:])[:, batch.ray_slice].reshape(-1, *x.shape[1:])
