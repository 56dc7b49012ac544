"""Device resolution for the port's entry points, and device constants.

The port's public entry points take an explicit ``device`` that defaults to
``"cuda"``. A host without a CUDA card raises instead of quietly running the
plain PyTorch path on the CPU: a caller who wants the CPU says so.

``constant`` keeps one copy of a small constant tensor per device: code on
the training step reads it instead of copying it from the host at every
call, which a CUDA graph of the step could not hold.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and kept; on the card copied from pinned memory
    without waiting for the card. ``values``: a number, a nested sequence or
    a numpy array."""
    arr = np.asarray(values)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        # a normal tensor even when first asked for under inference_mode:
        # a later training step saves it for its backward
        with torch.inference_mode(False):
            host = torch.tensor(arr.tolist(), dtype=dtype)
            if torch.device(device).type == "cuda":
                t = host.pin_memory().to(device, non_blocking=True)
            else:
                t = host.to(device)
        _CONSTANTS[key] = t
    return t


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
