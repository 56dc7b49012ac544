"""Optimizer: per-group learning rates and the masked update
(counterpart of ``pagnerf_tpu/train/optimizer.py``).

Parameters are grouped by name (``label_for_path``: decoder, sem, inst,
delta_grid, grid, rest, extrinsics) with per-group learning rates: the grids
at lr x 100, the extrinsics at 1e-4. Each group has its own step count, as
optax's ``multi_transform`` keeps one count per group, and runs the
``optimizer_type`` of the config, as the JAX package's ``_group_tx`` builds
it:
- ``adam``: Adam (eps = 1e-15); with ``weight_decay`` > 0 the ``grid`` and
  ``delta_grid`` groups run ``optax.adamw`` instead, whose update is
  ``-lr * (adam_step + weight_decay * p)``;
- ``sgd``: ``optax.sgd``, ``-lr * g``, no momentum, no state but the count;
- ``rmsprop``: ``optax.rmsprop`` at its defaults, ``nu = 0.9 nu + 0.1 g^2``
  and ``-lr * g * rsqrt(nu + 1e-8)``: no momentum, not centred, no bias
  correction.
``weight_decay`` acts only under ``adam``: sgd and rmsprop ignore it, as
the JAX package's do. ``torch.optim`` cannot stand in: it keeps a count
per parameter and skips parameters whose gradient is None, so Adam's bias
correction drifts from the JAX package's after a frozen span or a stage
that leaves a head unused. Here a missing gradient is a zero gradient, as
it is in JAX.

``MaskedOptimizer.update`` is ``masked_update``:
- frozen parameters (``frozen_fn(name)``) keep their values and their
  moments, while their group's count advances;
- a global-norm clip (``clip_grad_norm > 0``) scales all gradients after the
  freeze zeroing;
- a step with any non-finite gradient changes nothing: parameters, moments
  and counts stay bit-identical.

The learning rate of each group follows its schedule (``lr_schedule``):
constant, or with ``use_lr_scheduler`` the ``step``, ``one_cycle`` and
``panoptic_step`` schedules of the JAX package. As optax's
``scale_by_schedule`` does, the rate of an update is read at the group's
count *before* the update increments it, while Adam's bias correction uses
the incremented count. The counts run on across ``reset_moments``; a skipped
step changes no count, so it moves no schedule either.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The JAX package's optimizer settings, same names and defaults."""

    optimizer_type: str = "adam"
    lr: float = 0.001
    eps: float = 1e-15
    weight_decay: float = 0.0
    grid_lr_weight: float = 100.0
    delta_grid_lr_weight: float = 100.0
    extrinsics_lr: float = 0.0001
    use_lr_scheduler: bool = False
    lr_scheduler_type: str = "step"
    lr_step_size: int = 0
    lr_step_gamma: float = 0.1
    lr_warmup_epochs: int = 0
    lr_div_factor: float = 10000.0
    num_epochs: int = 800
    steps_per_epoch: int = 1
    clip_grad_norm: float = 0.0


GROUPS = ("decoder", "sem", "inst", "delta_grid", "grid", "rest", "extrinsics")
_B1, _B2 = 0.9, 0.999


def label_for_path(path: str) -> str:
    """Group of a parameter path ('/'- or '.'-joined), with the reference's
    precedence of name matches."""
    if path.startswith("extrinsics"):
        return "extrinsics"
    if "decoder" in path:
        return "decoder"
    if "inst" in path:
        return "inst"
    if "sem" in path:
        return "sem"
    if "delta_grid" in path:
        return "delta_grid"
    if "grid" in path:
        return "grid"
    return "rest"


def group_lr(cfg: OptimizerConfig, group: str) -> float:
    """The group's base learning rate."""
    return {"decoder": cfg.lr, "sem": cfg.lr, "inst": cfg.lr, "rest": cfg.lr,
            "grid": cfg.lr * cfg.grid_lr_weight,
            "delta_grid": cfg.lr * cfg.delta_grid_lr_weight,
            "extrinsics": cfg.extrinsics_lr if cfg.extrinsics_lr >= 0 else cfg.lr,
            }[group]


Schedule = Callable[[int], float]


def _staircase_decay(init: float, transition_steps: int, rate: float) -> Schedule:
    """``optax.exponential_decay(init, transition_steps, rate, staircase=True)``
    as XLA compiles it: float32 throughout, and the division of the count by
    the constant ``transition_steps`` a product with its float32 reciprocal,
    so at some multiples of it (41, 47, 55, 61, ... steps) the floor, and the
    decay, come one step late."""
    init32, rate32 = np.float32(init), np.float32(rate)
    recip = np.float32(1.0) / np.float32(transition_steps)

    def lr(count: int) -> float:
        if count <= 0:
            return float(init32)
        p = np.floor(np.float32(count) * recip)
        return float(init32 * np.power(rate32, p))
    return lr


def _linear_onecycle(transition_steps: int, peak: float, pct_start: float,
                     div_factor: float, final_div_factor: float) -> Schedule:
    """``optax.linear_onecycle_schedule`` (``pct_final`` 0.85) as XLA
    compiles its piecewise-linear form: the boundaries and values in float64
    on the host, then per interval one float32 slope ``(end - start) * (1 /
    interval)`` and one fused multiply-add ``(count - bound) * slope +
    start``; past the last boundary the last value."""
    scales = {int(pct_start * transition_steps): div_factor,
              int(0.85 * transition_steps): 1.0 / div_factor,
              transition_steps: 1.0 / final_div_factor}
    bounds, factors = zip(*sorted(scales.items()))
    bounds = (0,) + bounds
    values = np.cumprod(np.array((peak / div_factor,) + factors))
    starts = values[:-1].astype(np.float32)
    slopes = ((values[1:] - values[:-1]).astype(np.float32)
              * (np.float32(1.0) / np.diff(bounds).astype(np.float32)))
    last = np.float32(values[-1])

    def lr(count: int) -> float:
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                x = float(np.float32(count - bounds[i]))
                # one rounding of x * slope + start (x * slope is exact in float64)
                return float(np.float32(x * float(slopes[i]) + float(starts[i])))
        return float(last) if count >= bounds[-1] else 0.0
    return lr


def lr_schedule(cfg: OptimizerConfig, group: str) -> Schedule:
    """The group's learning rate as a function of its count (the JAX
    package's ``_schedule``): constant without ``use_lr_scheduler``;
    ``step`` decays every group by ``lr_step_gamma`` every ``lr_step_size``
    epochs; ``one_cycle`` runs over ``num_epochs + 1`` epochs; ``panoptic_step``
    decays only the sem, inst and delta_grid groups."""
    base = group_lr(cfg, group)
    const = float(np.float32(base))
    if not cfg.use_lr_scheduler:
        return lambda count: const
    spe = max(cfg.steps_per_epoch, 1)
    kind = cfg.lr_scheduler_type
    if kind == "step" or (kind == "panoptic_step"
                          and group in ("sem", "inst", "delta_grid")):
        if cfg.lr_step_size <= 0:
            return lambda count: const
        return _staircase_decay(base, cfg.lr_step_size * spe, cfg.lr_step_gamma)
    if kind == "panoptic_step":
        return lambda count: const
    if kind == "one_cycle":
        return _linear_onecycle((cfg.num_epochs + 1) * spe, base,
                                cfg.lr_warmup_epochs / max(cfg.num_epochs, 1),
                                cfg.lr_div_factor, cfg.lr_div_factor)
    raise ValueError(f"unknown lr scheduler {kind!r}")


OPTIMIZER_TYPES = ("adam", "sgd", "rmsprop")
# the moments each optimizer type keeps per parameter, beside the counts
MOMENTS = {"adam": ("mu", "nu"), "sgd": (), "rmsprop": ("nu",)}
DECAYED_GROUPS = ("grid", "delta_grid")
_RMS_DECAY, _RMS_EPS = 0.9, 1e-8


class MaskedOptimizer:
    """The config's optimizer over named parameters, one step count per
    group (the JAX package's ``build_optimizer`` + ``masked_update``).
    ``mu`` and ``nu`` hold the moments of the type (``MOMENTS``); a type
    that keeps none has them empty. ``kind`` names the state checkpoints
    keep: ``adamw`` for adam with weight decay (its decayed groups' optax
    state has one more entry, so the JAX package reinitialises an adam
    state loaded into it, and back), else ``optimizer_type``."""

    def __init__(self, cfg: OptimizerConfig,
                 params: Mapping[str, torch.Tensor]):
        if cfg.optimizer_type not in OPTIMIZER_TYPES:
            raise ValueError(f"unknown optimizer '{cfg.optimizer_type}'")
        self.cfg = cfg
        self.kind = ("adamw" if cfg.optimizer_type == "adam" and cfg.weight_decay > 0
                     else cfg.optimizer_type)
        self.params = dict(params)
        self.group = {name: label_for_path(name) for name in self.params}
        self.schedule = {g: lr_schedule(cfg, g) for g in GROUPS}
        self.count = {g: 0 for g in GROUPS}
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self.reset_moments()

    def _decay(self, group: str) -> float:
        """The group's weight decay: adamw's, on the grid groups only."""
        return self.cfg.weight_decay if (self.kind == "adamw"
                                         and group in DECAYED_GROUPS) else 0.0

    @torch.no_grad()
    def update(self, grads: Mapping[str, Optional[torch.Tensor]],
               frozen_fn: Optional[Callable[[str], bool]] = None,
               clip_norm: float = 0.0) -> bool:
        """One masked step; returns False (and changes nothing) when a
        gradient is not finite. A name missing from ``grads`` or mapped to
        None has a zero gradient."""
        frozen = {n for n in self.params if frozen_fn is not None and frozen_fn(n)}
        g = {}
        for n, p in self.params.items():
            gn = grads.get(n)
            g[n] = (torch.zeros_like(p) if gn is None or n in frozen
                    else gn.to(p.dtype))
        if clip_norm and clip_norm > 0:
            gnorm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            scale = clip_norm / torch.clamp(gnorm, min=clip_norm)
            g = {n: x * scale for n, x in g.items()}
        finite = all(bool(torch.isfinite(x).all()) for x in g.values())
        if not finite:
            return False
        # the rate at the count before this update, as optax reads it
        neg_lr = {grp: torch.tensor(-self.lr(grp), dtype=torch.float32)
                  for grp in GROUPS}
        for grp in GROUPS:
            self.count[grp] += 1
        for n, p in self.params.items():
            if n in frozen:
                continue
            grp = self.group[n]
            if self.kind == "sgd":
                step = g[n]
            elif self.kind == "rmsprop":
                nu = (g[n] * g[n]) * (1 - _RMS_DECAY) + self.nu[n] * _RMS_DECAY
                step = torch.rsqrt(nu + _RMS_EPS) * g[n]
                self.nu[n] = nu
            else:
                t = self.count[grp]
                mu = g[n] * (1 - _B1) + self.mu[n] * _B1
                nu = (g[n] * g[n]) * (1 - _B2) + self.nu[n] * _B2
                bc1 = 1 - torch.tensor(_B1, dtype=torch.float32) ** t
                bc2 = 1 - torch.tensor(_B2, dtype=torch.float32) ** t
                step = (mu / bc1.to(mu.device)) / (
                    torch.sqrt(nu / bc2.to(nu.device)) + self.cfg.eps)
                wd = self._decay(grp)
                if wd:
                    step = step + p * wd
                self.mu[n], self.nu[n] = mu, nu
            p.add_(step * neg_lr[grp].to(step.device))
        return True

    def lr(self, group: str) -> float:
        """The group's learning rate for its next update."""
        return self.schedule[group](self.count[group])

    def reset_moments(self) -> None:
        """Zero every moment and keep each group's count, as the JAX
        trainer's ``_reinit_opt_state`` does after a prune: a fresh optimizer
        would restart the counts, and with them any schedule read from them.
        The moments take the parameters' current shapes (the TensoRF
        upsampling replaces its factors)."""
        for key in MOMENTS[self.cfg.optimizer_type]:
            setattr(self, key, {n: torch.zeros_like(p) for n, p in self.params.items()})

    def state(self) -> Dict:
        """The kind, the counts and the kind's moments (for tests and
        checkpoints)."""
        return {"kind": self.kind, "count": dict(self.count),
                **{key: getattr(self, key) for key in MOMENTS[self.cfg.optimizer_type]}}
