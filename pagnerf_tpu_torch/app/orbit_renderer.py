"""Offline renderer of the channel images (counterpart of
``pagnerf_tpu/app/orbit_renderer.py``).

Each dataset view, or any camera pose on an orbit, is rendered through
``PanopticTrainer.batch_render`` on the trainer's device and coloured per
channel (rgb, depth, semantics, instance) with the validation's colourers;
``embedding_distance_image`` gives the per-pixel cosine distance to a
clicked pixel's instance embedding. ``render_orbit`` writes one PNG per
view and channel, ``<channel>_<view:04d>.png``, and each channel's frame
strip under ``video/`` (``utils/visualization.write_video``: the card has
no video encoder). The JAX package writes the strip beside the views when
imageio is missing, where frame ``i`` takes the name of view ``i``; the
subdirectory keeps every view's PNG its own.

    python -m pagnerf_tpu_torch.cli --config <yaml> --pretrained <ckpt> \\
        --render-views [--render-views-dir <dir>]
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.rays import Rays
from ..models.pipeline import BAPipeline
from ..utils.visualization import (depth2rgb, label2rgb, label_colormap, write_png,
                                   write_video)

CHANNELS = ("rgb", "depth", "semantics", "inst_embedding")
DIST_MAX = 6.0


def _rays(trainer, o: np.ndarray, d: np.ndarray) -> Rays:
    dev = trainer.device
    return Rays(origins=torch.as_tensor(np.ascontiguousarray(o), device=dev),
                dirs=torch.as_tensor(np.ascontiguousarray(d), device=dev),
                dist_min=0.0, dist_max=DIST_MAX)


def _rays_for_view(trainer, idx: int):
    """A BA pipeline's camera-space base rays with the view as ``cam_idx``
    (its learned extrinsics move them), otherwise the view's world rays."""
    data = trainer.dataset.data
    if isinstance(trainer.pipeline, BAPipeline):
        return _rays(trainer, data["base_rays_origins"].reshape(-1, 3),
                     data["base_rays_dirs"].reshape(-1, 3)), int(idx)
    return _rays(trainer, data["rays_origins"][idx].reshape(-1, 3),
                 data["rays_dirs"][idx].reshape(-1, 3)), None


def _render(trainer, rays: Rays, cam_idx: Optional[int], channels) -> Dict[str, np.ndarray]:
    supported = trainer.pipeline.nef.supported_channels()
    chans = {c for c in channels if c in supported or c == "depth"}
    h, w = trainer.dataset.img_shape
    return _colourise(trainer, trainer.batch_render(rays, chans, cam_idx=cam_idx), h, w)


def render_channels_for_view(trainer, idx: int, channels=CHANNELS) -> Dict[str, np.ndarray]:
    """Render dataset view ``idx`` and colour every channel."""
    rays, cam_idx = _rays_for_view(trainer, idx)
    return _render(trainer, rays, cam_idx, channels)


def pose_from_orbit(azimuth_deg: float, elevation_deg: float, radius: float,
                    target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Camera-to-world look-at pose [4, 4] on an orbit around ``target``
    (the camera looks down -z); elevation clipped to +-89 degrees."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(np.clip(elevation_deg, -89.0, 89.0))
    target = np.asarray(target, np.float64)
    eye = target + radius * np.array([np.cos(el) * np.cos(az), np.sin(el),
                                      np.cos(el) * np.sin(az)])
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= max(np.linalg.norm(right), 1e-9)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, up, -fwd
    c2w[:3, 3] = eye
    return c2w


def render_channels_for_pose(trainer, c2w: np.ndarray,
                             channels=CHANNELS) -> Dict[str, np.ndarray]:
    """Render an arbitrary pose: the dataset's camera-space base rays turned
    and moved by ``c2w`` on the host, without learned extrinsics."""
    base = trainer.dataset.data["base_rays_dirs"].reshape(-1, 3)
    c2w = np.asarray(c2w)
    d = (base @ c2w[:3, :3].T).astype(np.float32)
    o = np.broadcast_to(c2w[:3, 3], d.shape).astype(np.float32)
    return _render(trainer, _rays(trainer, o, d), None, channels)


def _colourise(trainer, rb, h: int, w: int) -> Dict[str, np.ndarray]:
    """uint8 images per channel; ``_inst_embedding`` keeps the raw [H, W, E]
    embeddings for click queries."""
    out: Dict[str, np.ndarray] = {}
    host = {k: getattr(rb, k).float().cpu().numpy() for k in CHANNELS
            if getattr(rb, k) is not None}
    if "rgb" in host:
        out["rgb"] = (np.clip(host["rgb"].reshape(h, w, 3), 0, 1) * 255).astype(np.uint8)
    if "depth" in host:
        out["depth"] = depth2rgb(host["depth"].reshape(h, w))
    if "semantics" in host:
        sem = np.argmax(host["semantics"], -1).reshape(h, w)
        ncls = trainer.dataset.semantic_info["num_classes"]
        out["semantics"] = label2rgb(sem, colormap=label_colormap(max(ncls, 2)))
    if "inst_embedding" in host:
        emb = host["inst_embedding"]
        inst = np.argmax(emb, -1).reshape(h, w)
        out["instance"] = label2rgb(inst, colormap=label_colormap(int(inst.max()) + 2))
        out["_inst_embedding"] = emb.reshape(h, w, -1)
    return out


def embedding_distance_image(emb: np.ndarray, query_yx) -> np.ndarray:
    """Per-pixel cosine distance to the embedding at ``query_yx``, coloured
    over [0, 2]."""
    e = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12)
    q = e[query_yx[0], query_yx[1]]
    return depth2rgb(1.0 - e @ q, 0.0, 2.0)


def render_orbit(trainer, out_dir: str, views: Optional[List[int]] = None,
                 fps: int = 15) -> Dict[str, List[np.ndarray]]:
    """Render every (or each of ``views``) dataset view per channel to
    ``<out_dir>/<channel>_<view:04d>.png`` and each channel's frames, in
    the order of ``views``, to ``<out_dir>/video/<channel>_<i:04d>.png``;
    returns the frames per channel."""
    ds = trainer.dataset
    if views is None:
        views = sorted(set(np.asarray(ds.train_idxs).tolist())
                       | set(np.asarray(ds.val_idxs).tolist()))
    frames: Dict[str, List[np.ndarray]] = {}
    os.makedirs(out_dir, exist_ok=True)
    for idx in views:
        for name, img in render_channels_for_view(trainer, idx).items():
            if name.startswith("_"):
                continue
            frames.setdefault(name, []).append(img)
            write_png(os.path.join(out_dir, f"{name}_{int(idx):04d}.png"), img)
    for name, fl in frames.items():
        write_video(os.path.join(out_dir, "video", f"{name}.mp4"), fl, fps=fps)
    return frames
