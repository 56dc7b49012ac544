"""Panoptic-Lifting baseline NeF (counterpart of
``pagnerf_tpu/models/panoptic_lifting.py``).

A TensoRF VM grid (``models/tensorf.py``) gives density and appearance
features; ``MLPRenderFeature`` decodes colour from the appearance features
and the view direction with their positional encodings; the semantic and
instance heads decode the raw coordinates. Plain PyTorch, as the JAX
package computes it in XLA.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .decoder import BasicDecoder, DenseT
from .nefs import Channels, GridConfig
from .tensorf import TensoRFGrid


def _pe_T(xT: torch.Tensor, freqs: int) -> torch.Tensor:
    """[D, N] -> [2 * freqs * D, N]: the sines of x * 2^k (k major, then D),
    then the cosines."""
    bands = 2.0 ** torch.arange(freqs, dtype=xT.dtype, device=xT.device)
    pts = (xT[None] * bands[:, None, None]).reshape(-1, xT.shape[1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=0)


class MLPRenderFeature(nn.Module):
    """Colour from (view directions [3, N], features [C, N]): the features,
    the directions and their encodings through two ReLU layers of
    ``dim_mlp_color`` and a sigmoid output. Layers named ``DenseT_<i>`` as
    flax names them."""

    def __init__(self, in_features: int, out_channels: int = 3, pe_view: int = 2,
                 pe_feat: int = 2, dim_mlp_color: int = 128):
        super().__init__()
        self.pe_view, self.pe_feat = pe_view, pe_feat
        cin = in_features
        if pe_view > 0 or pe_feat > 0:
            cin += 3
        cin += 2 * pe_feat * in_features + 2 * pe_view * 3
        self.DenseT_0 = DenseT(cin, dim_mlp_color)
        self.DenseT_1 = DenseT(dim_mlp_color, dim_mlp_color)
        self.DenseT_2 = DenseT(dim_mlp_color, out_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.DenseT_0, self.DenseT_1, self.DenseT_2):
            layer.reset_parameters(generator)

    def forward(self, viewdirsT: torch.Tensor, featuresT: torch.Tensor) -> torch.Tensor:
        indata = [featuresT]
        if self.pe_view > 0 or self.pe_feat > 0:
            indata.append(viewdirsT)
        if self.pe_feat > 0:
            indata.append(_pe_T(featuresT, self.pe_feat))
        if self.pe_view > 0:
            indata.append(_pe_T(viewdirsT, self.pe_view))
        h = torch.relu(self.DenseT_0(torch.cat(indata, dim=0)))
        h = torch.relu(self.DenseT_1(h))
        return torch.sigmoid(self.DenseT_2(h))


def _probabilities(x, sigmoid: bool, normalize: bool, softmax: bool):
    if sigmoid:
        x = torch.sigmoid(x)
    if normalize:
        x = x / (torch.linalg.norm(x, dim=0, keepdim=True) + 1e-12)
    if softmax:
        x = torch.softmax(x, dim=0)
    return x


class PanopticLiftingNeF(nn.Module):
    """Constructor arguments mirror the JAX module's fields. Its TensoRF
    grid is built from ``grid``'s TensoRF fields whatever its
    ``grid_type``."""

    def __init__(self, grid: GridConfig = GridConfig(grid_type="TensoRF"),
                 num_classes: int = 20, num_instances: int = 200, hidden_dim: int = 128,
                 sem_softmax: bool = True, sem_sigmoid: bool = False,
                 sem_normalize: bool = False, inst_softmax: bool = True,
                 inst_sigmoid: bool = False, inst_normalize: bool = False):
        super().__init__()
        self.grid_cfg = grid
        self.num_classes, self.num_instances = num_classes, num_instances
        self.sem_post = (sem_sigmoid, sem_normalize, sem_softmax)
        self.inst_post = (inst_sigmoid, inst_normalize, inst_softmax)
        self.grid = TensoRFGrid(density_n_comp=grid.density_n_comp,
                                app_n_comp=grid.app_n_comp, resolution=grid.resolution)
        self.decoder_color = MLPRenderFeature(self.grid.app_dim)
        self.decoder_semantics = BasicDecoder(3, num_classes, hidden_dim, 2, "relu")
        self.decoder_inst = BasicDecoder(3, num_instances, hidden_dim, 2, "relu")

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init in the JAX package's distributions (not its numbers)."""
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, coordsT: torch.Tensor, ray_dT: Optional[torch.Tensor],
                channels: Channels, lod_weights=None) -> Dict[str, torch.Tensor]:
        """coordsT / ray_dT [3, N] -> {channel: [C, N]}."""
        out: Dict[str, torch.Tensor] = {}
        if not channels:
            return out
        if channels & {"density", "rgb"}:
            density_feats, color_feats = self.grid(coordsT)
            if "density" in channels:
                out["density"] = torch.relu(density_feats)[None, :]
        if "rgb" in channels:
            out["rgb"] = self.decoder_color(-ray_dT, color_feats)
        if "semantics" in channels:
            out["semantics"] = _probabilities(self.decoder_semantics(coordsT),
                                              *self.sem_post)
        if "inst_embedding" in channels:
            out["inst_embedding"] = _probabilities(self.decoder_inst(coordsT),
                                                   *self.inst_post)
        return out

    def supported_channels(self) -> Channels:
        return frozenset({"density", "rgb", "semantics", "inst_embedding"})
