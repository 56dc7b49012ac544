"""Semantic-NeRF baseline NeF (counterpart of
``pagnerf_tpu/models/semantic_nerf.py``).

A vanilla-NeRF MLP: the positional embedding of the coordinates through 8
hidden layers (the input appended again before the 6th), a linear density
head whose bias starts at 1, a view-conditioned colour MLP and a semantic
head off the trunk features. It has no feature grid: ``grid_cfg`` is kept
only for the trainer's LoD weights, which it ignores.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .decoder import BasicDecoder, DenseT
from .embedders import positional_embed_dim, positional_embed_T
from .nefs import Channels, GridConfig


class SemanticNeF(nn.Module):
    """Constructor arguments mirror the JAX module's fields."""

    def __init__(self, num_classes: int = 20, num_instances: int = 2,
                 hidden_dim: int = 128, activation_type: str = "relu",
                 pos_multires: int = 10, view_multires: int = 10,
                 sem_softmax: bool = True, sem_sigmoid: bool = False,
                 sem_normalize: bool = False,
                 grid: GridConfig = GridConfig(grid_type="HashGrid", num_lods=1,
                                               feature_dim=1)):
        super().__init__()
        self.grid_cfg = grid
        self.num_classes, self.num_instances = num_classes, num_instances
        self.pos_multires, self.view_multires = pos_multires, view_multires
        self.sem_softmax, self.sem_sigmoid = sem_softmax, sem_sigmoid
        self.sem_normalize = sem_normalize
        pos_dim = positional_embed_dim(pos_multires, 3)
        self.decoder_features = BasicDecoder(pos_dim, hidden_dim, hidden_dim, 8,
                                             activation_type, skip=(5,))
        self.decoder_density = DenseT(hidden_dim, 1)
        self.decoder_color = BasicDecoder(
            hidden_dim + positional_embed_dim(view_multires, 3), 3, hidden_dim // 2, 1,
            activation_type)
        self.decoder_semantics = BasicDecoder(hidden_dim, num_classes, hidden_dim // 2, 1,
                                              activation_type)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init in the JAX package's distributions (not its numbers)."""
        self.decoder_features.reset_parameters(generator)
        self.decoder_density.reset_parameters(generator, bias_init=(1.0,))
        self.decoder_color.reset_parameters(generator)
        self.decoder_semantics.reset_parameters(generator)

    def forward(self, coordsT: torch.Tensor, ray_dT: Optional[torch.Tensor],
                channels: Channels, lod_weights=None) -> Dict[str, torch.Tensor]:
        """coordsT / ray_dT [3, N] -> {channel: [C, N]}."""
        out: Dict[str, torch.Tensor] = {}
        if not channels:
            return out
        feats = self.decoder_features(positional_embed_T(coordsT, self.pos_multires))
        if "density" in channels:
            out["density"] = torch.relu(self.decoder_density(feats))
        if "rgb" in channels:
            vdir = positional_embed_T(-ray_dT, self.view_multires)
            out["rgb"] = torch.sigmoid(self.decoder_color(torch.cat([feats, vdir], dim=0)))
        if "semantics" in channels:
            s = self.decoder_semantics(feats)
            if self.sem_sigmoid:
                s = torch.sigmoid(s)
            if self.sem_normalize:
                s = s / (torch.linalg.norm(s, dim=0, keepdim=True) + 1e-12)
            if self.sem_softmax:
                s = torch.softmax(s, dim=0)
            out["semantics"] = s
        return out

    def supported_channels(self) -> Channels:
        return frozenset({"density", "rgb", "semantics"})
