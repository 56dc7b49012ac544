"""Counters of the traced run, taken in the benchmark's own wrappers around
the program's calls (the program is not edited): the samples the march keeps
and the model FLOPs on them, and the encodes' work by the yardstick's counts.

The wrappers add their counts on the device, into one float64 tensor made
before any step, so that a CUDA graph captured through them replays the
additions with the step. A wrapper runs only in the traced run.
"""
from __future__ import annotations

import contextlib
from typing import Dict, FrozenSet

import torch

from . import counts

SLOTS = ("model_flops", "kept_samples", "encode_fwd_bytes", "encode_fwd_flops",
         "encode_bwd_bytes", "encode_bwd_flops")


class Probes:
    """Install with ``install(settings, ref_nef, dev)``; ``read()`` returns
    the counters (a host read); ``uninstall()`` puts the program back."""

    def __init__(self, settings: Dict, ref_nef: torch.nn.Module, dev):
        self.acc = torch.zeros(len(SLOTS), dtype=torch.float64, device=dev)
        self.kind = "hash" if settings["grid_type"].startswith("Hash") or \
            settings["grid_type"] == "CodebookOctreeGrid" else "permuto"
        self.levels, self.feat = settings["num_lods"], settings["feature_dim"]
        self.capacity = (1 << max(settings["codebook_bitwidth"], 4) if self.kind == "hash"
                         else 1 << settings["capacity_log_2"])
        spec = ref_nef.grid.spec
        self.reachable = (counts.permuto_reachable_rows(spec.scales, self.capacity)
                          if self.kind == "permuto" else None)
        self.ref_nef = ref_nef
        self._dec: Dict[FrozenSet[str], float] = {}
        self._pending = None
        self._ctx = None
        self._saved = []

    def _add(self, slot: str, value) -> None:
        i = SLOTS.index(slot)
        if isinstance(value, torch.Tensor):
            self.acc[i].add_(value.to(torch.float64))
        else:
            self.acc[i].add_(float(value))

    def decoder_flops(self, channels) -> float:
        key = frozenset(channels)
        if key not in self._dec:
            self._dec[key] = counts.decoder_flops_per_sample(self.ref_nef, key)
        return self._dec[key]

    # ------------------------------------------------------------ wrappers
    def _raymarch(self, fn):
        def wrapped(*a, **k):
            rm = fn(*a, **k)
            self._pending = torch.sum(rm.mask, dtype=torch.int64)
            return rm
        return wrapped

    def _pack(self, fn):
        def wrapped(*a, **k):
            ps = fn(*a, **k)
            self._pending = ps.offsets[-1].to(torch.int64)
            return ps
        return wrapped

    def _nef_eval(self, fn):
        def wrapped(nef_fn, coordsT, ray_dT, channels, chunk):
            kept = self._pending if self._pending is not None else coordsT.shape[1]
            grad = torch.is_grad_enabled()
            self._ctx = (kept, grad, bool(coordsT.requires_grad))
            try:
                out = fn(nef_fn, coordsT, ray_dT, channels, chunk)
            finally:
                self._ctx = None
                self._pending = None
            f = counts.step_flops_per_sample(self.decoder_flops(channels), 0.0, grad)
            self._add("model_flops", kept * f if isinstance(kept, torch.Tensor)
                      else float(kept) * f)
            self._add("kept_samples", kept)
            return out
        return wrapped

    def _encode(self, fn, tables: int):
        def wrapped(*a, **k):
            t_a, coordsT = a[0], a[tables]
            n = int(coordsT.shape[1])
            grad = torch.is_grad_enabled() and t_a.requires_grad
            coords_grad = torch.is_grad_enabled() and coordsT.requires_grad
            if self._ctx is not None:
                kept = self._ctx[0]
                f = counts.encode_flops_per_sample(self.kind, self.levels, self.feat, tables,
                                                   grad, coords_grad)
                self._add("model_flops", kept * f if isinstance(kept, torch.Tensor)
                          else float(kept) * f)
            if self.kind == "permuto":
                fw = counts.encode_fwd_work(n, self.reachable, self.feat, tables)
                self._add("encode_fwd_bytes", fw["bytes"])
                self._add("encode_fwd_flops", fw["flops"])
                if grad:
                    bw = counts.encode_bwd_work(n, self.reachable, self.capacity, self.feat,
                                                tables, coords_grad)
                    self._add("encode_bwd_bytes", bw["bytes"])
                    self._add("encode_bwd_flops", bw["flops"])
            return fn(*a, **k)
        return wrapped

    def install(self) -> None:
        from pagnerf_tpu_torch.models import tracer
        from pagnerf_tpu_torch.ops import hash_encoding, permuto_encoding
        plan = [(tracer, "raymarch", self._raymarch), (tracer, "pack_samples", self._pack),
                (tracer, "_chunked_nef_eval", self._nef_eval),
                (permuto_encoding, "permuto_encode_T", lambda f: self._encode(f, 1)),
                (permuto_encoding, "permuto_encode_dual_T", lambda f: self._encode(f, 2)),
                (hash_encoding, "hash_encode_T", lambda f: self._encode(f, 1)),
                (hash_encoding, "hash_encode_dual_T", lambda f: self._encode(f, 2))]
        for mod, name, wrap in plan:
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, wrap(orig))

    def uninstall(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved = []

    def read(self) -> Dict[str, float]:
        return dict(zip(SLOTS, (float(v) for v in self.acc.cpu().tolist())))


@contextlib.contextmanager
def installed(probes):
    if probes is None:
        yield None
        return
    probes.install()
    try:
        yield probes
    finally:
        probes.uninstall()


def difference(after: Dict[str, float], before: Dict[str, float]) -> Dict[str, float]:
    return {k: after[k] - before.get(k, 0.0) for k in after}


