"""Checkpoints (counterpart of ``pagnerf_tpu/train/checkpoint.py``).

The state is what the JAX package keeps: the parameters, the optimizer's
state (its kind, each group's count and the kind's moments: Adam's ``mu``
and ``nu``, RMSprop's ``nu``, none for SGD), the occupancy (accumulator, mask, level), the LoD
weights, the epoch (the next one to run), the global step and the prune
flags (``pruned``, ``real_pruned``, ``occ_frac``). No random-generator state
is kept: a resumed trainer re-seeds, as the JAX one does.

The file is written with ``torch.save`` to a temporary name and moved into
place with ``os.replace`` (atomic on POSIX: a run killed mid-save never
leaves a truncated ``model.ckpt``), and read with ``torch.load(...,
weights_only=True)``, which loads tensors and plain containers only and runs
no pickled code. ``convert.state_from_jax`` gives the same layout from a
checkpoint of the JAX package.

Formats (``--model-format``): ``full`` and ``state_dict`` restore everything;
``params_only`` the parameters (every one must be present with its shape);
``params_only_ignore_missmatch`` the parameters whose name and shape match,
keeping the others.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Mapping, Optional

import torch

from ..ops.occupancy import OccupancyGrid
from .optimizer import MOMENTS, MaskedOptimizer

log = logging.getLogger(__name__)

FORMATS = ("full", "params_only", "state_dict", "params_only_ignore_missmatch")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def trainer_state(trainer) -> Dict:
    """The trainer's checkpoint state (tensors on the host)."""
    opt = trainer.opt
    return {
        "params": {n: _cpu(p) for n, p in trainer.params.items()},
        "opt_state": {k: ({n: _cpu(t) for n, t in v.items()} if k in ("mu", "nu") else v)
                      for k, v in opt.state().items()},
        "occupancy": _cpu(trainer.occ.occupancy),
        "occ_mask": _cpu(trainer.occ.mask),
        "occ_level": int(trainer.occ.level),
        "lod_weights": _cpu(trainer.lod_w),
        "epoch": int(trainer.epoch),
        "global_step": int(trainer.global_step),
        # the prune flags key the post-prune stages (packed budget, no seed
        # refreshes); without them a resumed run trains the pre-prune stage
        "pruned": int(bool(trainer._pruned)),
        "real_pruned": int(bool(trainer._real_pruned)),
        "occ_frac": float(trainer._occ_frac),
    }


def save_checkpoint(path: str, trainer, save_as_new: bool = False) -> str:
    """Write ``trainer``'s state to ``path`` (``save_as_new``: to
    ``<base>_epoch<epoch><ext>``); returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if save_as_new:
        base, ext = os.path.splitext(path)
        path = f"{base}_epoch{trainer.epoch}{ext}"
    tmp = f"{path}.tmp"
    torch.save(trainer_state(trainer), tmp)
    os.replace(tmp, path)
    log.info("saved checkpoint to %s", path)
    return path


def _first_real_prune_epoch(cfg) -> Optional[int]:
    """The epoch whose end runs the first real (non-seed) prune, or None."""
    cands = []
    if cfg.prune_at_start:
        cands.append(0)
    if cfg.prune_at_epoch >= 0:
        cands.append(cfg.prune_at_epoch)
    if cfg.prune_every > 0:
        cands.append(cfg.prune_every)
    return min(cands) if cands else None


def derive_real_pruned(cfg, epoch: int, pruned: bool) -> bool:
    """Whether the real prune has run by a checkpoint at ``epoch`` (the
    next epoch to run), for a state without ``real_pruned``: it runs at the
    end of its epoch P, so ``epoch > P`` means it ran."""
    if not pruned:
        return False
    p = _first_real_prune_epoch(cfg)
    return p is not None and epoch > p


def _partial_merge(current: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor],
                   ignore_mismatch: bool) -> Dict[str, torch.Tensor]:
    """``current`` with each entry replaced by ``loaded``'s of the same name
    and shape; a mismatched or missing one raises, or with
    ``ignore_mismatch`` keeps the current value."""
    merged = {}
    for name, cur in current.items():
        if name in loaded:
            cand = loaded[name]
            if tuple(cand.shape) == tuple(cur.shape):
                merged[name] = cand
            elif ignore_mismatch:
                log.warning("shape mismatch at %s: %s vs %s -- keeping current",
                            name, tuple(cand.shape), tuple(cur.shape))
                merged[name] = cur
            else:
                raise ValueError(f"shape mismatch at {name}: "
                                 f"{tuple(cand.shape)} vs {tuple(cur.shape)}")
        else:
            if not ignore_mismatch:
                raise KeyError(f"missing parameter {name} in checkpoint")
            merged[name] = cur
    return merged


def _restore_optimizer(trainer, opt_state: Mapping) -> None:
    """The saved optimizer state, or, where its kind, groups, parameters or
    shapes differ from the trainer's optimizer, a fresh optimizer of the
    trainer's own kind (the JAX package's "incompatible; reinitialised").
    A state saved without its kind is Adam's."""
    opt = trainer.opt
    keys = MOMENTS[opt.cfg.optimizer_type]
    if (opt_state.get("kind", "adam") != opt.kind or set(opt_state["count"]) != set(opt.count)
            or any(key not in opt_state or set(opt_state[key]) != set(getattr(opt, key))
                   or any(tuple(opt_state[key][n].shape) != tuple(t.shape)
                          for n, t in getattr(opt, key).items()) for key in keys)):
        log.warning("optimizer state incompatible; reinitialised")
        trainer.opt = MaskedOptimizer(trainer.opt_cfg, trainer.params)
        return
    # in place: a captured training step keeps reading the same tensors
    with torch.no_grad():
        for key in keys:
            for n, m in getattr(opt, key).items():
                m.copy_(opt_state[key][n].to(torch.float32))
    opt.count = {g: int(opt_state["count"][g]) for g in opt.count}


def _match_tensorf_resolution(trainer, params: Mapping[str, torch.Tensor]) -> None:
    """A TensoRF grid saved after ``maybe_upsample_tensorf`` has finer
    factors than a freshly built one: resize the trainer's grid to the
    saved resolution first (the JAX trainer reads it from the parameters'
    shapes)."""
    nef = trainer.pipeline.nef
    saved = params.get("nef.grid.density_plane")
    if saved is None or not hasattr(nef.grid, "upsample"):
        return
    if saved.shape[-1] != nef.grid.resolution:
        nef.grid.upsample(int(saved.shape[-1]))
        trainer.params = dict(trainer.pipeline.named_parameters())
        trainer.opt.params = dict(trainer.params)
        trainer.opt.reset_moments()


def load_state(trainer, state: Mapping, model_format: str = "full") -> None:
    """Restore ``state`` (``trainer_state``'s layout) into ``trainer`` in one
    of the ``FORMATS``."""
    if model_format not in FORMATS:
        raise ValueError(f"model_format must be one of {FORMATS}, got {model_format!r}")
    _match_tensorf_resolution(trainer, state["params"])
    ignore = model_format == "params_only_ignore_missmatch"
    merged = _partial_merge(trainer.params, state["params"], ignore)
    with torch.no_grad():
        for name, p in trainer.params.items():
            p.copy_(merged[name].to(p.device, p.dtype))
    if model_format not in ("full", "state_dict"):
        return
    dev = trainer.device
    trainer.occ = OccupancyGrid(occupancy=state["occupancy"].to(dev, torch.float32),
                                mask=state["occ_mask"].to(dev, torch.bool),
                                level=int(state["occ_level"]))
    trainer.lod_w = state["lod_weights"].to(dev, torch.float32)
    trainer.epoch = int(state["epoch"])
    trainer.global_step = int(state["global_step"])
    if "pruned" in state:
        trainer._pruned = bool(state["pruned"])
        trainer._occ_frac = float(state["occ_frac"])
    else:
        # a state without the flags: any prune leaves the mask below full
        occ_frac = float(trainer.occ.mask.float().mean())
        trainer._pruned = occ_frac < 1.0
        trainer._occ_frac = occ_frac
    if "real_pruned" in state:
        trainer._real_pruned = bool(state["real_pruned"])
    else:
        trainer._real_pruned = derive_real_pruned(trainer.cfg, trainer.epoch,
                                                  trainer._pruned)
    _restore_optimizer(trainer, state["opt_state"])


def load_checkpoint(path: str, trainer, model_format: str = "full") -> None:
    """Read a checkpoint written by ``save_checkpoint`` (tensors and plain
    containers only) and restore it in ``model_format``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    load_state(trainer, state, model_format)
    log.info("loaded checkpoint %s (format=%s)", path, model_format)
