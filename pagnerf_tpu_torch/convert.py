"""Carry the JAX package's parameters over to the port.

``params_from_flax`` takes the tree that ``Pipeline.init`` returns there
(``{"nef": {...}, "extrinsics": [num_cams, 9]}``), as nested dicts of numpy
arrays, and returns a state dict for the port's pipeline. The port's
modules use the same names and layouts as the flax tree (``DenseT`` kernels
``[Cin, Cout]``, grid tables ``[L, C, F]`` under ``grid/tables`` and
``delta_grid/tables``, extrinsics as R6 + t), so the conversion is a flatten.
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
