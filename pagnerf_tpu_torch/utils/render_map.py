"""3-D fruit point-cloud map (counterpart of ``pagnerf_tpu/utils/render_map.py``).

Render depth, alpha, rgb and instance embeddings from every camera through
``PanopticTrainer.batch_render``, unproject each ray at its rendered depth
(``rays_to_3d_points``), keep the points that pass the alpha, hit and
depth-band filters, and return the point-cloud dict the reference pickles to
``nerf_pc.pkl``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.camera import rays_to_3d_points
from ..core.rays import Rays
from ..models.pipeline import BAPipeline


@torch.no_grad()
def generate_pc_map_from_views(trainer, mip: int = 2,
                               alpha_threshold: float = 0.9,
                               depth_range=(0.6, 0.8)) -> Dict[str, np.ndarray]:
    """Point-cloud map from all cameras, their rays strided by 2^mip: the
    points with alpha > ``alpha_threshold``, a hit and a depth inside
    ``depth_range`` -> {"points" [P, 3], "color" [P, 3], "inst_embedding"
    [P, M] where the NeF renders it}. The JAX package also accepts a
    ``density_threshold``, which it does not use."""
    ds = trainer.dataset
    is_ba = isinstance(trainer.pipeline, BAPipeline)
    s = 1 << mip
    channels = {"rgb", "depth", "alpha", "inst_embedding"}
    if "inst_embedding" not in trainer.pipeline.nef.supported_channels():
        channels = {"rgb", "depth", "alpha"}

    pts, colors, embeds = [], [], []
    for idx in np.unique(np.concatenate([ds.train_idxs, ds.val_idxs])):
        if is_ba:
            o = ds.data["base_rays_origins"][::s, ::s].reshape(-1, 3)
            d = ds.data["base_rays_dirs"][::s, ::s].reshape(-1, 3)
        else:
            o = ds.data["rays_origins"][idx][::s, ::s].reshape(-1, 3)
            d = ds.data["rays_dirs"][idx][::s, ::s].reshape(-1, 3)
        rays = Rays(origins=torch.from_numpy(np.ascontiguousarray(o)).to(trainer.device),
                    dirs=torch.from_numpy(np.ascontiguousarray(d)).to(trainer.device),
                    dist_min=0.0, dist_max=6.0)
        rb = trainer.batch_render(rays, channels, cam_idx=int(idx) if is_ba else None)
        world = (trainer.pipeline.transform_rays(
            rays.reshape(1, -1), torch.tensor([int(idx)], device=trainer.device))
            if is_ba else rays)
        p3d = rays_to_3d_points(world, rb.depth).cpu().numpy()
        depth = rb.depth[:, 0].cpu().numpy()
        alpha = rb.alpha[:, 0].cpu().numpy()
        keep = (alpha > alpha_threshold) & (depth > depth_range[0]) & \
               (depth < depth_range[1]) & rb.hit.cpu().numpy()
        pts.append(p3d[keep])
        colors.append(rb.rgb.cpu().numpy()[keep])
        if rb.inst_embedding is not None:
            embeds.append(rb.inst_embedding.cpu().numpy()[keep])

    out = {"points": np.concatenate(pts) if pts else np.zeros((0, 3)),
           "color": np.concatenate(colors) if colors else np.zeros((0, 3))}
    if embeds:
        out["inst_embedding"] = np.concatenate(embeds)
    return out
