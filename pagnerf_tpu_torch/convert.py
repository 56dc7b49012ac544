"""Carry the JAX package's parameters over to the port.

``params_from_flax`` takes the tree that ``Pipeline.init`` returns there
(``{"nef": {...}, "extrinsics": [num_cams, 9]}``), as nested dicts of numpy
arrays, and returns a state dict for the port's pipeline. The port's
modules use the same names and layouts as the flax tree (``DenseT`` kernels
``[Cin, Cout]``, grid tables ``[L, C, F]`` under ``grid/tables`` and
``delta_grid/tables`` for the permutohedral and hash grids, the triplanar
grid's ``planes_{lod}`` and the dense grid's ``table_{lod}``, the TensoRF
grid's ``density_plane`` / ``density_line`` / ``app_plane`` / ``app_line``
and its bias-free ``basis_mat``, the baselines' ``DenseT`` and
``BasicDecoder`` names down to ``decoder_color/DenseT_<i>``, extrinsics as
R6 + t), so the conversion is a flatten.

``state_from_jax`` takes a whole checkpoint of the JAX package (parameters,
optimizer state, occupancy, flags), so a run checkpointed there continues
in the port.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of arrays -> flat ``{"nef.grid.tables": tensor, ...}``."""
    state: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            state.update(params_from_flax(value, prefix=name + "."))
        else:
            state[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def state_from_jax(state: Mapping) -> Dict:
    """A checkpoint state of the JAX package (the dict that
    ``flax.serialization.msgpack_restore`` reads from its file: nested dicts
    of numpy arrays and Python numbers) -> the port's checkpoint state
    (``train.checkpoint.trainer_state``'s layout), for
    ``train.checkpoint.load_state``.

    The optax state is ``multi_transform``'s: per group an inner state of
    (Adam: count, mu, nu; schedule: count). Adam's moments cover only the
    group's parameters; the port keeps one moment per parameter and one
    count per group, so both counts of a group must agree (they advance
    together, and the JAX trainer's prune carries them over together)."""
    params = params_from_flax(state["params"])
    mu: Dict[str, torch.Tensor] = {}
    nu: Dict[str, torch.Tensor] = {}
    count: Dict[str, int] = {}
    for group, inner in state["opt_state"]["inner_states"].items():
        adam, sched = inner["inner_state"]["0"], inner["inner_state"]["1"]
        counts = {int(adam["count"]), int(sched["count"])}
        if len(counts) != 1:
            raise ValueError(f"group {group}: Adam count {int(adam['count'])} and "
                             f"schedule count {int(sched['count'])} differ")
        count[group] = counts.pop()
        mu.update(params_from_flax(adam.get("mu") or {}))
        nu.update(params_from_flax(adam.get("nu") or {}))
    for name, p in params.items():      # a parameter of no group's moments
        mu.setdefault(name, torch.zeros_like(p))
        nu.setdefault(name, torch.zeros_like(p))
    out = {
        "params": params,
        "opt_state": {"count": count, "mu": mu, "nu": nu},
        "occupancy": torch.from_numpy(np.array(state["occupancy"], dtype=np.float32)),
        "occ_mask": torch.from_numpy(np.array(state["occ_mask"], dtype=bool)),
        "occ_level": int(state["occ_level"]),
        "lod_weights": torch.from_numpy(np.array(state["lod_weights"], dtype=np.float32)),
        "epoch": int(state["epoch"]),
        "global_step": int(state["global_step"]),
    }
    for key in ("pruned", "real_pruned"):
        if key in state:
            out[key] = int(state[key])
    if "occ_frac" in state:
        out["occ_frac"] = float(state["occ_frac"])
    return out
