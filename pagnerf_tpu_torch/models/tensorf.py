"""TensoRF VM-decomposition grid (counterpart of
``pagnerf_tpu/models/tensorf.py``).

Three plane + line factor pairs for density (``density_n_comp``
components) and appearance (``app_n_comp`` components, projected to
``app_dim`` by the bias-free ``basis_mat``), interpolated with
``align_corners=True`` semantics: bilinear on the planes, linear on the
lines. ``upsample_vm_params`` resizes the factors (the trainer's progressive
resolution steps, ``train/trainer.maybe_upsample_tensorf``) and
``resolution_schedule`` gives the steps. Plain PyTorch, as the JAX package
computes it in XLA.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .decoder import DenseT

# plane axis pairs and the complementary line axes
_MAT_MODE = ((0, 1), (0, 2), (1, 2))
_VEC_MODE = (2, 1, 0)
_FACTORS = ("density_plane", "density_line", "app_plane", "app_line")


def _bilinear_plane(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """plane [C, R, R] indexed [C, y, x], u/v [N] in [-1, 1] -> [C, N]."""
    r = plane.shape[-1]
    gu = (u + 1.0) * 0.5 * (r - 1)
    gv = (v + 1.0) * 0.5 * (r - 1)
    x0 = torch.clamp(torch.floor(gu).to(torch.int64), 0, r - 2)
    y0 = torch.clamp(torch.floor(gv).to(torch.int64), 0, r - 2)
    fx, fy = gu - x0, gv - y0
    flat = plane.reshape(plane.shape[0], -1)                         # [C, R*R]

    def tap(dy, dx):
        return flat[:, (y0 + dy) * r + (x0 + dx)]                   # [C, N]

    return (tap(0, 0) * (1 - fx) * (1 - fy) + tap(0, 1) * fx * (1 - fy)
            + tap(1, 0) * (1 - fx) * fy + tap(1, 1) * fx * fy)


def _linear_line(line: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """line [C, R], w [N] in [-1, 1] -> [C, N]."""
    r = line.shape[-1]
    g = (w + 1.0) * 0.5 * (r - 1)
    g0 = torch.clamp(torch.floor(g).to(torch.int64), 0, r - 2)
    f = g - g0
    return line[:, g0] * (1 - f) + line[:, g0 + 1] * f


class TensoRFGrid(nn.Module):
    """VM-split feature volume; ``forward`` returns (sigma feature [N],
    appearance features [app_dim, N])."""

    def __init__(self, density_n_comp: int = 16, app_n_comp: int = 48,
                 resolution: int = 128, app_dim: int = 27, init_scale: float = 0.1,
                 num_lods: int = 1, feature_dim: int = 28):
        super().__init__()
        self.density_n_comp, self.app_n_comp = density_n_comp, app_n_comp
        self.resolution, self.app_dim, self.init_scale = resolution, app_dim, init_scale
        self.num_lods, self.feature_dim = num_lods, feature_dim
        r = resolution
        self.density_plane = nn.Parameter(torch.zeros(3, density_n_comp, r, r))
        self.density_line = nn.Parameter(torch.zeros(3, density_n_comp, r))
        self.app_plane = nn.Parameter(torch.zeros(3, app_n_comp, r, r))
        self.app_line = nn.Parameter(torch.zeros(3, app_n_comp, r))
        self.basis_mat = DenseT(3 * app_n_comp, app_dim, use_bias=False)

    @property
    def output_dim(self) -> int:
        return 1 + self.app_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's ``init_scale * normal`` factors, LeCun-normal basis."""
        with torch.no_grad():
            for name in _FACTORS:
                p = getattr(self, name)
                p.copy_(self.init_scale * torch.randn(p.shape, generator=generator))
        self.basis_mat.reset_parameters(generator)

    def density_feature(self, coordsT: torch.Tensor) -> torch.Tensor:
        """[3, N] -> sigma feature [N]."""
        sigma = torch.zeros(coordsT.shape[1], dtype=coordsT.dtype, device=coordsT.device)
        for i in range(3):
            a, b = _MAT_MODE[i]
            pc = _bilinear_plane(self.density_plane[i], coordsT[a], coordsT[b])
            lc = _linear_line(self.density_line[i], coordsT[_VEC_MODE[i]])
            sigma = sigma + torch.sum(pc * lc, dim=0)
        return sigma

    def app_feature(self, coordsT: torch.Tensor) -> torch.Tensor:
        """[3, N] -> [app_dim, N]."""
        pcs, lcs = [], []
        for i in range(3):
            a, b = _MAT_MODE[i]
            pcs.append(_bilinear_plane(self.app_plane[i], coordsT[a], coordsT[b]))
            lcs.append(_linear_line(self.app_line[i], coordsT[_VEC_MODE[i]]))
        return self.basis_mat(torch.cat(pcs, dim=0) * torch.cat(lcs, dim=0))

    def forward(self, coordsT: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.density_feature(coordsT), self.app_feature(coordsT)

    @torch.no_grad()
    def upsample(self, res_target: int) -> None:
        """Replace the factors by their resizes to ``res_target``
        (``upsample_vm_params``) as new parameters."""
        up = upsample_vm_params({n: getattr(self, n) for n in _FACTORS}, res_target)
        for name in _FACTORS:
            setattr(self, name, nn.Parameter(up[name].contiguous()))
        self.resolution = res_target


def upsample_vm_params(params: Dict[str, torch.Tensor], res_target: int
                       ) -> Dict[str, torch.Tensor]:
    """Resize the VM factors to ``res_target``: planes [3, C, R, R]
    bilinearly, lines [3, C, R] linearly, half-pixel centres and edge
    clamping (``jax.image.resize``'s ``bilinear`` / ``linear`` when
    enlarging). Returns a new dict."""
    out = dict(params)
    for name in ("density_plane", "app_plane"):
        out[name] = F.interpolate(params[name], size=(res_target, res_target),
                                  mode="bilinear", align_corners=False)
    for name in ("density_line", "app_line"):
        out[name] = F.interpolate(params[name], size=res_target, mode="linear",
                                  align_corners=False)
    return out


def resolution_schedule(base: int, maximum: int, num: int):
    """The progressive resolutions: ``num`` steps from ``base`` to
    ``maximum``, evenly spaced and rounded."""
    return [int(round(r)) for r in np.linspace(base, maximum, num)]
