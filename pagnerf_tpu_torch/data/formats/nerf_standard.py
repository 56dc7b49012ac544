"""Instant-NGP / NeRF-synthetic ``transforms*.json`` format (counterpart of
``pagnerf_tpu/data/formats/nerf_standard.py``): the train and val splits,
``camera_angle_x`` or ``fl_x`` / ``cx`` / ``cy`` intrinsics, instant-ngp's
pose normalisation, RGBA composited onto the background, and the standard
data dict. Images are read with ``data/image_io.py`` (PIL's arrays; a mip
level resizes with PIL's Lanczos filter) one after another: the JAX
package's thread pool gives the same arrays.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ...core.camera import (PinholeIntrinsics, extrinsics_params_from_view_matrix,
                            generate_pinhole_rays, inv_transform_rays, view_from_c2w)
from ..image_io import read_png, resize_lanczos


def _load_image(path: str, mip: int = 0) -> np.ndarray:
    img = read_png(path)
    if mip > 0:
        # a real resize, not stride subsampling (aliasing biases PSNR)
        s = 1 << mip
        img = resize_lanczos(img, img.shape[1] // s, img.shape[0] // s)
    return img.astype(np.float32) / 255.0


def load_nerf_standard(root: str, split: str = "train", mip: int = 0,
                       bg_color: str = "white") -> Dict:
    root = Path(root).expanduser()
    # When the dataset ships explicit train/val splits, load BOTH and expose
    # train_idxs/val_idxs: otherwise MultiviewDataset's even/odd interleave
    # would silently withhold half the train frames as val and never touch
    # the real val split.
    tf_split = root / f"transforms_{split}.json"
    tf_val = root / "transforms_val.json"
    if tf_split.exists() and split == "train" and tf_val.exists():
        tform_files = [(tf_split, "train"), (tf_val, "val")]
    elif tf_split.exists():
        tform_files = [(tf_split, split)]
    elif (root / "transforms.json").exists():
        tform_files = [(root / "transforms.json", split)]
    else:
        raise FileNotFoundError(f"no transforms json under {root}")

    # frame paths first, then the images
    paths, poses, tags, meta = [], [], [], None
    for tforms, tag in tform_files:
        with open(tforms) as f:
            m = json.load(f)
        if meta is None:
            meta = m            # intrinsics come from the primary split
        # instant-ngp pose normalisation: translations /= aabb_scale
        # (default 1.25), *= scale, += offset
        offset = np.asarray(m.get("offset", [0.0, 0.0, 0.0]), np.float32)
        pscale = float(m.get("scale", 1.0))
        aabb_scale = float(m.get("aabb_scale", 1.25))
        for frame in m["frames"]:
            fp = root / frame["file_path"]
            if not fp.suffix:
                fp = fp.with_suffix(".png")
            if not fp.exists():
                continue
            pose = np.asarray(frame["transform_matrix"], np.float32)
            pose[:3, 3] = pose[:3, 3] / aabb_scale * pscale + offset
            paths.append(str(fp))
            poses.append(pose)
            tags.append(tag)
    imgs = [_load_image(p, mip) for p in paths]
    if not imgs:
        raise FileNotFoundError(f"no frames found under {root}")
    imgs = np.stack(imgs)
    poses = np.stack(poses)
    h, w = imgs.shape[1:3]

    # intrinsics
    if "fl_x" in meta:
        fx = meta["fl_x"] / (1 << mip)
        fy = meta.get("fl_y", meta["fl_x"]) / (1 << mip)
    else:
        cam_angle = float(meta["camera_angle_x"])
        fx = fy = 0.5 * w / np.tan(0.5 * cam_angle)
    cx = meta.get("cx", w * 0.5 * (1 << mip)) / (1 << mip)
    cy = meta.get("cy", h * 0.5 * (1 << mip)) / (1 << mip)
    intr = PinholeIntrinsics(fx=np.float32(fx), fy=np.float32(fy),
                             cx=np.float32(cx), cy=np.float32(cy),
                             width=w, height=h, near=0.0, far=6.0)

    # alpha compositing onto the background
    if imgs.shape[-1] == 4:
        alpha = imgs[..., 3:4]
        if bg_color == "black":
            rgb = np.clip(imgs[..., :3] * alpha, 0, 1)
        else:
            rgb = np.clip(imgs[..., :3] * alpha + (1 - alpha), 0, 1)
    else:
        rgb = imgs[..., :3]

    views = view_from_c2w(poses.astype(np.float64)).astype(np.float32)
    base = generate_pinhole_rays(intr)
    params = extrinsics_params_from_view_matrix(torch.from_numpy(views))
    n = views.shape[0]
    bo = base.origins.reshape(1, -1, 3).expand(n, h * w, 3)
    bd = base.dirs.reshape(1, -1, 3).expand(n, h * w, 3)
    wo, wd = inv_transform_rays(params, bo, bd)
    wd = wd / (torch.linalg.norm(wd, dim=-1, keepdim=True) + 1e-12)

    out = {
        "imgs": rgb.astype(np.float32),
        "rays_origins": wo.reshape(n, h, w, 3).numpy(),
        "rays_dirs": wd.reshape(n, h, w, 3).numpy(),
        "base_rays_origins": base.origins.numpy(),
        "base_rays_dirs": base.dirs.numpy(),
        "view_matrices": views,
        "cameras_ts": np.arange(n),
        "intrinsics": intr,
        "semantic_info": {"num_classes": 2, "num_instances": 2,
                          "stuff_ids": [0], "things_ids": [1]},
    }
    tags_arr = np.asarray(tags)
    if (tags_arr == "val").any():
        out["train_idxs"] = np.nonzero(tags_arr == "train")[0]
        out["val_idxs"] = np.nonzero(tags_arr == "val")[0]
    return out
