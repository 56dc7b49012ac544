"""Volume-rendering compositing along the dense sample axis (counterpart of
``pagnerf_tpu/ops/composite.py``).

Float32 throughout; ``einsum`` on CUDA runs in full float32 because PyTorch
leaves TF32 off for matmuls by default.
"""
from __future__ import annotations

import torch


def exponential_integration_weights(tau: torch.Tensor, mask: torch.Tensor):
    """tau, mask [R, S] -> (weights [R, S], alpha [R, 1]) with
    weights_i = exp(-sum_{j<i} tau_j) * (1 - exp(-tau_i)); invalid samples
    carry zero thickness and zero weight."""
    tau = torch.where(mask, tau, 0.0)
    cum = torch.cumsum(tau, dim=-1)
    transmittance = torch.exp(-(cum - tau))          # exclusive cumsum
    weights = transmittance * (1.0 - torch.exp(-tau))
    weights = torch.where(mask, weights, 0.0)
    return weights, torch.sum(weights, dim=-1, keepdim=True)


def composite_channel_T(featsT: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """featsT [C, R, S], weights [R, S] -> [R, C]."""
    return torch.einsum("crs,rs->rc", featsT, weights)


def composite_scalar(vals: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """vals, weights [R, S] -> [R, 1]."""
    return torch.sum(vals * weights, dim=-1, keepdim=True)
