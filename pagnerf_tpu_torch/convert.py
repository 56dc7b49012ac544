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


def _group_state(group: str, inner: Mapping):
    """(kind, count, first inner state) of one group's optax chain:
    adam ``(ScaleByAdamState, ScaleByScheduleState)``, adamw ``(..Adam..,
    AddDecayedWeightsState (empty), ..Schedule..)``, sgd ``(EmptyState,
    ..Schedule..)``, rmsprop ``(ScaleByRmsState, ..Schedule.., EmptyState)``.
    Every count in the chain must agree: they advance together, and the
    JAX trainer's prune carries them over together."""
    chain = inner["inner_state"]
    first = chain["0"]
    if "mu" in first:
        kind = "adamw" if "2" in chain else "adam"
    else:
        kind = "rmsprop" if "nu" in first else "sgd"
    counts = {k: int(st["count"]) for k, st in chain.items() if "count" in st}
    if len(set(counts.values())) != 1:
        raise ValueError(f"group {group}: the counts of its chain differ: {counts}")
    return kind, counts["1" if kind in ("sgd", "rmsprop") else "0"], first


def state_from_jax(state: Mapping) -> Dict:
    """A checkpoint state of the JAX package (the dict that
    ``flax.serialization.msgpack_restore`` reads from its file: nested dicts
    of numpy arrays and Python numbers) -> the port's checkpoint state
    (``train.checkpoint.trainer_state``'s layout), for
    ``train.checkpoint.load_state``.

    The optax state is ``multi_transform``'s: per group an inner chain
    (``_group_state``) whose first state holds the moments of the group's
    parameters; the port keeps one moment per parameter and one count per
    group. The kind is that of the groups, ``adamw`` where a group decays
    (the grid groups under adam with weight decay; the others are adam)."""
    params = params_from_flax(state["params"])
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    count: Dict[str, int] = {}
    kinds = set()
    for group, inner in state["opt_state"]["inner_states"].items():
        kind, count[group], first = _group_state(group, inner)
        kinds.add(kind)
        for key in ("mu", "nu"):
            if key in first:
                moments.setdefault(key, {}).update(params_from_flax(first[key] or {}))
    # adamw's groups beside plain adam ones are one optimizer
    one = kinds - {"adam"} if "adamw" in kinds else kinds
    if len(one) != 1:
        raise ValueError(f"the groups' optimizers differ: {sorted(kinds)}")
    kind = one.pop()
    for moment in moments.values():     # a parameter of no group's moments
        for name, p in params.items():
            moment.setdefault(name, torch.zeros_like(p))
    out = {
        "params": params,
        "opt_state": {"kind": kind, "count": count, **moments},
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
