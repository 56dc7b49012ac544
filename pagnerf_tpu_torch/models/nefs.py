"""Panoptic neural fields (counterpart of
``pagnerf_tpu/models/nefs.py``).

``PanopticNeF`` is the base model: grid -> density and colour MLPs plus the
semantic and instance heads. ``PanopticDeltaNeF`` is the flagship PAg-NeRF
model: the panoptic heads read stop-gradient colour features plus a delta
grid queried at stop-gradient coordinates. When the delta grid has the main
grid's spec, both grids are read at one shared lattice through the dual
table-gather kernel (``_dual_feats``).

Layout: coordinates and ray directions enter feature-major ``[3, N]``;
every channel comes out ``[C, N]``. ``.detach()`` stands where the JAX package
has ``stop_gradient``; the training step's gradients keep those contracts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional

import torch
from torch import nn

from .decoder import BasicDecoder
from .embedders import positional_embed_dim, positional_embed_T
from .grids import PermutoGrid

Channels = FrozenSet[str]


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Grid settings (the JAX package's ``GridConfig``, PermutoGrid fields)."""

    grid_type: str = "PermutoGrid"
    num_lods: int = 24
    feature_dim: int = 2
    capacity_log2: int = 18
    coarsest_scale: float = 1.0
    finest_scale: float = 0.0001
    compute_dtype: torch.dtype = torch.float32

    def build(self) -> PermutoGrid:
        if self.grid_type != "PermutoGrid":
            raise NotImplementedError(
                f"grid_type {self.grid_type!r} is not ported yet (only PermutoGrid)")
        return PermutoGrid(self.num_lods, self.feature_dim, self.capacity_log2,
                           self.coarsest_scale, self.finest_scale,
                           self.compute_dtype)

    @property
    def output_dim(self) -> int:
        return self.num_lods * self.feature_dim


def _multiscale(featsT: torch.Tensor, num_lods: int, multiscale_type: str):
    """'cat' keeps the concatenated level features [L*F, N]; 'sum' folds levels."""
    if multiscale_type == "sum":
        return featsT.reshape(num_lods, -1, featsT.shape[1]).sum(dim=0)
    return featsT


class PanopticNeF(nn.Module):
    """Base panoptic NeF. Constructor arguments mirror the JAX module's fields
    (``compute_dtype`` is a torch dtype in place of ``compute_dtype_name``)."""

    def __init__(self, grid: GridConfig = GridConfig(), num_classes: int = 20,
                 num_instances: int = 200, hidden_dim: int = 64,
                 num_layers: int = 1, activation_type: str = "relu",
                 sem_activation_type: Optional[str] = None,
                 sem_num_layers: Optional[int] = None,
                 sem_hidden_dim: Optional[int] = None,
                 sem_normalize: bool = False, sem_softmax: bool = True,
                 sem_sigmoid: bool = False, sem_detach: bool = True,
                 inst_num_layers: Optional[int] = None,
                 inst_hidden_dim: Optional[int] = None,
                 inst_normalize: bool = False, inst_softmax: bool = True,
                 inst_sigmoid: bool = False, inst_detach: bool = True,
                 inst_direct_pos: bool = False,
                 inst_soft_temperature: float = 0.0,
                 panoptic_features_type: Optional[str] = None,
                 multiscale_type: str = "cat", sem_zero_init: bool = False,
                 view_multires: int = 4, pos_multires: int = 10,
                 embedder_type: str = "positional",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid_cfg = grid
        self.num_classes, self.num_instances = num_classes, num_instances
        self.sem_normalize, self.sem_softmax = sem_normalize, sem_softmax
        self.sem_sigmoid, self.sem_detach = sem_sigmoid, sem_detach
        self.inst_normalize, self.inst_softmax = inst_normalize, inst_softmax
        self.inst_sigmoid, self.inst_detach = inst_sigmoid, inst_detach
        self.inst_direct_pos = inst_direct_pos
        self.inst_soft_temperature = inst_soft_temperature
        self.panoptic_features_type = panoptic_features_type
        self.multiscale_type = multiscale_type
        self.view_multires, self.pos_multires = view_multires, pos_multires
        self.embedder_type = embedder_type
        self.compute_dtype = compute_dtype

        self.grid = grid.build()
        feat_dim = (grid.feature_dim if multiscale_type == "sum"
                    else grid.output_dim)
        view_dim = positional_embed_dim(view_multires, 3, True,
                                        embedder_type == "positional")
        sem_act = sem_activation_type or activation_type
        # truthy fallbacks, like the reference: 0 layers means num_layers
        self.decoder_density = BasicDecoder(
            feat_dim, 16, hidden_dim, num_layers, activation_type,
            output_bias_init=(1.0,), compute_dtype=compute_dtype)
        self.decoder_color = BasicDecoder(
            16 + view_dim, 3, hidden_dim, num_layers + 1, activation_type,
            compute_dtype=compute_dtype)
        self.decoder_semantics = BasicDecoder(
            self._panoptic_input_dim(feat_dim), num_classes,
            sem_hidden_dim or hidden_dim, sem_num_layers or num_layers, sem_act,
            compute_dtype=compute_dtype, zero_init_output=sem_zero_init)
        inst_in = 3 if inst_direct_pos else self._panoptic_input_dim(feat_dim)
        self.decoder_inst = BasicDecoder(
            inst_in, num_instances, inst_hidden_dim or hidden_dim,
            inst_num_layers or num_layers, sem_act, compute_dtype=compute_dtype)

    def _panoptic_input_dim(self, feat_dim: int) -> int:
        return feat_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init in the JAX package's distributions (not its numbers)."""
        for m in self.children():
            m.reset_parameters(generator)

    # --------------------------------------------------------------- helpers
    def _post_grid(self, featsT, lod_weights):
        if lod_weights is not None:
            featsT = featsT * lod_weights.to(featsT.dtype)[:, None]
        return _multiscale(featsT, self.grid_cfg.num_lods, self.multiscale_type)

    def _grid_feats(self, grid_module, coordsT, lod_weights):
        return self._post_grid(grid_module(coordsT), lod_weights)   # [L*F, N]

    def _density(self, featsT):
        density_feats = self.decoder_density(featsT)                # [16, N]
        return density_feats, torch.relu(density_feats[0:1, :])     # [1, N]

    def _rgb(self, density_featsT, ray_dT):
        vdir = positional_embed_T(-ray_dT, self.view_multires, True,
                                  self.embedder_type == "positional")
        fdir = torch.cat([density_featsT, vdir], dim=0)
        return torch.sigmoid(self.decoder_color(fdir))              # [3, N]

    def _semantics(self, sem_inputT):
        s = self.decoder_semantics(sem_inputT)                      # [C, N]
        if self.sem_sigmoid:
            s = torch.sigmoid(s)
        if self.sem_normalize:
            s = s / (torch.linalg.norm(s, dim=0, keepdim=True) + 1e-12)
        if self.sem_softmax:
            s = torch.softmax(s, dim=0)
        return s

    def _inst(self, inst_inputT):
        """Delta-NeF instance chain: sigmoid -> normalize -> /temperature ->
        softmax, each optional."""
        e = self.decoder_inst(inst_inputT)                          # [M, N]
        if self.inst_sigmoid:
            e = torch.sigmoid(e)
        if self.inst_normalize:
            e = e / (torch.linalg.norm(e, dim=0, keepdim=True) + 1e-12)
        if self.inst_soft_temperature > 0.0:
            e = e / self.inst_soft_temperature
        if self.inst_softmax:
            e = torch.softmax(e, dim=0)
        return e

    def _inst_base(self, inst_inputT):
        """Base-NeF instance decode: the softmax branch re-decodes the raw
        logits (sigmoid/normalize discarded), and there is no temperature."""
        e = self.decoder_inst(inst_inputT)
        if self.inst_softmax:
            return torch.softmax(e, dim=0)
        if self.inst_sigmoid:
            e = torch.sigmoid(e)
        if self.inst_normalize:
            e = e / (torch.linalg.norm(e, dim=0, keepdim=True) + 1e-12)
        return e

    # --------------------------------------------------------------- forward
    def forward(self, coordsT: torch.Tensor, ray_dT: Optional[torch.Tensor],
                channels: Channels,
                lod_weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if not channels:
            return out
        feats = self._grid_feats(self.grid, coordsT, lod_weights)
        if channels & {"density", "rgb", "semantics", "inst_embedding"}:
            density_feats, density = self._density(feats)
            if "density" in channels:
                out["density"] = density
        if "rgb" in channels:
            out["rgb"] = self._rgb(density_feats, ray_dT)
        if "semantics" in channels:
            out["semantics"] = self._semantics(
                feats.detach() if self.sem_detach else feats)
        if "inst_embedding" in channels:
            if self.inst_direct_pos:
                inst_input = coordsT
            else:
                inst_input = feats.detach() if self.inst_detach else feats
            out["inst_embedding"] = self._inst_base(inst_input)
        return out

    def supported_channels(self) -> Channels:
        return frozenset({"density", "rgb", "semantics", "inst_embedding"})


class PanopticDeltaNeF(PanopticNeF):
    """Delta-grid panoptic NeF, the flagship model: panoptic features are
    ``detach(colour feats) + delta_grid(detach(coords))``."""

    def __init__(self, *args, delta_grid: Optional[GridConfig] = None,
                 fuse_dual_grid: bool = True, **kwargs):
        self.delta_grid_cfg = delta_grid
        super().__init__(*args, **kwargs)
        self.fuse_dual_grid = fuse_dual_grid
        if self.panoptic_features_type in ("delta", "separate", None):
            self.delta_grid = (delta_grid or self.grid_cfg).build()

    def _panoptic_input_dim(self, feat_dim: int) -> int:
        if self.panoptic_features_type == "pos_encoding":
            return positional_embed_dim(self.pos_multires, 3, True, True)
        if self.panoptic_features_type == "position":
            return 3
        return feat_dim

    def _can_fuse_dual(self) -> bool:
        return (self.fuse_dual_grid
                and self.panoptic_features_type in ("delta", None)
                and (self.delta_grid_cfg is None
                     or self.delta_grid_cfg == self.grid_cfg))

    def _dual_feats(self, coordsT, lod_weights):
        """Shared-lattice read of the main and delta tables (one dual kernel
        launch). Returns (feats, panoptic feats)."""
        fa, fb = self.grid.spec.encode_dual_T(
            self.grid.tables, self.delta_grid.tables, coordsT,
            compute_dtype=self.grid.compute_dtype)
        feats = self._post_grid(fa, lod_weights)
        delta_feats = self._post_grid(fb, lod_weights)
        return feats, feats.detach() + delta_feats

    def _panoptic_feats(self, coordsT, feats, lod_weights):
        pft = self.panoptic_features_type
        if pft in ("delta", "separate", None):
            delta_feats = self._grid_feats(self.delta_grid, coordsT.detach(),
                                           lod_weights)
            return delta_feats if pft == "separate" else feats.detach() + delta_feats
        if pft == "appearance":
            return feats.detach()
        if pft == "pos_encoding":
            return positional_embed_T(coordsT, self.pos_multires, True, True)
        if pft == "position":
            return coordsT
        raise ValueError(f'panoptic feature type "{pft}" not implemented')

    def forward(self, coordsT, ray_dT, channels, lod_weights=None):
        out: Dict[str, torch.Tensor] = {}
        if not channels:
            return out
        need_panop = bool(channels & {"semantics", "inst_embedding"})
        panop_feats = None
        if need_panop and self._can_fuse_dual():
            feats, panop_feats = self._dual_feats(coordsT, lod_weights)
        else:
            feats = self._grid_feats(self.grid, coordsT, lod_weights)

        if channels & {"density", "rgb", "semantics", "inst_embedding"}:
            density_feats, density = self._density(feats)
            if "density" in channels:
                out["density"] = density
        if "rgb" in channels:
            out["rgb"] = self._rgb(density_feats, ray_dT)
        if need_panop:
            if panop_feats is None:
                panop_feats = self._panoptic_feats(coordsT, feats, lod_weights)
            if "semantics" in channels:
                out["semantics"] = self._semantics(panop_feats)
            if "inst_embedding" in channels:
                out["inst_embedding"] = self._inst(panop_feats)
        return out
