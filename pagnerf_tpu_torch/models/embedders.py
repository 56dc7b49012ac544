"""Positional (Fourier-feature) embedder (counterpart of
``pagnerf_tpu/models/embedders.py``), feature-major."""
from __future__ import annotations

import torch


def positional_embed_dim(multires: int, input_dim: int = 3,
                         include_input: bool = True, active: bool = True) -> int:
    if not active:
        return input_dim
    return input_dim * (2 * multires + (1 if include_input else 0))


def positional_embed_T(xT: torch.Tensor, multires: int,
                       include_input: bool = True,
                       active: bool = True) -> torch.Tensor:
    """[D, N] -> [D * (2*multires + include_input), N]: x, then per frequency
    2^i the block [sin(2^i x); cos(2^i x)]."""
    if not active:
        return xT
    freqs = 2.0 ** torch.arange(multires, dtype=xT.dtype, device=xT.device)
    xf = xT[None, :, :] * freqs[:, None, None]                   # [M, D, N]
    d, n = xT.shape
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=1)      # [M, 2D, N]
    enc = enc.reshape(multires * 2 * d, n)
    if include_input:
        enc = torch.cat([xT, enc], dim=0)
    return enc
