"""Multiview dataset wrapper (counterpart of ``pagnerf_tpu/data/multiview.py``).

Ported: the data dict, its ``semantic_info``, the interleaved train/val
split, and ``sample_batch`` (random images x random rays per image). The
distinct pixels of each image come from ``data/native.py``'s C++ sampler,
the stream the JAX package's batches come from, and the pixel modes from its
gathers; when an image has fewer pixels than the rays asked for -- the
flagship's 4096 rays of a 64x48 image -- both packages sample with
replacement from one ``np.random.default_rng``. The same ``rng`` gives the
JAX package's batch bit for bit.

``get_images`` serves whole images for validation at a mip level. The JAX
package resizes with ``cv2``; the port resizes by the whole factor 2^mip in
numpy: the area filter of an image mode is then the block mean in float32,
and the nearest filter of a label mode takes the pixel ``cv2.INTER_NEAREST``
takes, the first of each block.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.camera import (extrinsics_params_from_view_matrix, generate_pinhole_rays,
                           inv_transform_rays)
from . import native

# Pixel modes that get flattened and ray-sampled.
PIXEL_MODES = ("imgs", "semantics", "instance", "semantics_pred", "instance_pred",
               "sem_conf", "inst_conf", "depths", "rays_origins", "rays_dirs")


def _resize_stack(arr: np.ndarray, s: int, nearest: bool) -> np.ndarray:
    """Shrink [N, H, W, ...] by the whole factor ``s``: the first pixel of
    each s x s block (nearest) or the block's float32 mean (area), in the
    input's dtype."""
    n, h, w = arr.shape[:3]
    if h % s or w % s:
        raise ValueError(f"images of {h}x{w} do not shrink by a whole factor of {s}")
    if nearest:
        return arr[:, ::s, ::s].copy()
    blocks = arr.astype(np.float32).reshape(n, h // s, s, w // s, s, *arr.shape[3:])
    return blocks.mean(axis=(2, 4), dtype=np.float32).astype(arr.dtype)


def _regenerate_rays(intrinsics, view_matrices: np.ndarray, s: int):
    """Camera-space base rays [h, w, 3] and world rays [N, h, w, 3] at mip
    scale ``s``, through the mip image's exact pixel centres (float32)."""
    intr = intrinsics.rescaled(1.0 / s, intrinsics.width // s, intrinsics.height // s)
    base = generate_pinhole_rays(intr, dist_min=0.0, dist_max=2.0)
    h, w = intr.height, intr.width
    n = view_matrices.shape[0]
    params = extrinsics_params_from_view_matrix(torch.from_numpy(view_matrices))
    bo = base.origins.reshape(1, -1, 3).expand(n, h * w, 3)
    bd = base.dirs.reshape(1, -1, 3).expand(n, h * w, 3)
    wo, wd = inv_transform_rays(params, bo, bd)
    wd = wd / (torch.linalg.norm(wd, dim=-1, keepdim=True) + 1e-12)
    return (base.origins.numpy(), base.dirs.numpy(),
            wo.reshape(n, h, w, 3).numpy(), wd.reshape(n, h, w, 3).numpy())


class MultiviewDataset:
    """Wraps a data dict (``data/synthetic.make_dataset``). Frames interleave
    into train (even) and val (odd) unless the dict names its own split."""

    def __init__(self, data: Dict, split_interleave: bool = True):
        self.data = data
        n = data["imgs"].shape[0]
        if "train_idxs" in data:
            self.train_idxs = np.asarray(data["train_idxs"])
            self.val_idxs = np.asarray(data["val_idxs"])
        elif split_interleave and n >= 2:
            self.train_idxs = np.arange(0, n, 2)
            self.val_idxs = np.arange(1, n, 2)
        else:
            self.train_idxs = np.arange(n)
            self.val_idxs = np.arange(n)
        h, w = data["imgs"].shape[1:3]
        self.img_shape = (h, w)
        self.num_pixels = h * w
        # rays are drawn only from non-robot pixels where a robot mask is given
        self._valid_pixels = None
        if "robot_mask" in data:
            valid = np.nonzero(np.asarray(data["robot_mask"]).reshape(-1) == 0)[0]
            if 0 < len(valid) < self.num_pixels:
                self._valid_pixels = valid

    @property
    def semantic_info(self) -> Dict:
        return self.data["semantic_info"]

    @property
    def num_train(self) -> int:
        return len(self.train_idxs)

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, int(np.ceil(self.num_train / batch_size)))

    def sample_batch(self, rng: np.random.Generator, batch_size: int,
                     num_rays: int, split: str = "train",
                     modes: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
        """Random images (at most ``batch_size``, distinct) x ``num_rays``
        random rays per image -> numpy batch of the pixel modes [B, R, ...],
        the camera-space base rays [B, R, 3] and ``cam_idx`` [B] of absolute
        frame indices."""
        idxs = self.train_idxs if split == "train" else self.val_idxs
        img_idx = rng.choice(idxs, size=min(batch_size, len(idxs)), replace=False)
        pool = self.num_pixels if self._valid_pixels is None else len(self._valid_pixels)
        ray_idx = native.sample_ray_indices(len(img_idx), num_rays, pool,
                                            int(rng.integers(2 ** 62)))
        if self._valid_pixels is not None:
            ray_idx = self._valid_pixels[ray_idx]
        batch = {"cam_idx": img_idx.astype(np.int32)}
        for mode in PIXEL_MODES:
            if mode in self.data:
                arr = self.data[mode]
                flat = arr.reshape(arr.shape[0], self.num_pixels, *arr.shape[3:])
                batch[mode] = native.gather_pixels(flat, img_idx.astype(np.int64),
                                                   ray_idx)
        bo = self.data["base_rays_origins"].reshape(self.num_pixels, 3)
        bd = self.data["base_rays_dirs"].reshape(self.num_pixels, 3)
        batch["base_rays_origins"] = bo[ray_idx]
        batch["base_rays_dirs"] = bd[ray_idx]
        return batch

    # label modes shrink by nearest; every other mode by area
    _NEAREST_MODES = ("semantics", "instance", "semantics_pred", "instance_pred")

    def get_images(self, split: str = "val", mip: int = 0) -> Dict[str, np.ndarray]:
        """The split's whole images at mip level ``mip`` (shrunk by 2^mip):
        ``cam_idx``, every pixel mode present, and the rays. At mip > 0 the
        rays are regenerated through the mip image's pixel centres from the
        stored intrinsics and view matrices, else strided."""
        idxs = self.val_idxs if split == "val" else self.train_idxs
        s = 1 << mip
        out = {"cam_idx": idxs.astype(np.int32)}
        for mode in PIXEL_MODES:
            if mode in self.data and not mode.startswith("rays_"):
                arr = self.data[mode][idxs]
                out[mode] = arr if s == 1 else _resize_stack(
                    arr, s, nearest=mode in self._NEAREST_MODES)
        if s == 1:
            for mode in ("rays_origins", "rays_dirs"):
                if mode in self.data:
                    out[mode] = self.data[mode][idxs]
            out["base_rays_origins"] = self.data["base_rays_origins"]
            out["base_rays_dirs"] = self.data["base_rays_dirs"]
        elif "intrinsics" in self.data and "view_matrices" in self.data:
            bo, bd, wo, wd = _regenerate_rays(self.data["intrinsics"],
                                              self.data["view_matrices"][idxs], s)
            out["base_rays_origins"], out["base_rays_dirs"] = bo, bd
            if "rays_origins" in self.data:
                out["rays_origins"], out["rays_dirs"] = wo, wd
        else:
            for mode in ("rays_origins", "rays_dirs"):
                if mode in self.data:
                    out[mode] = self.data[mode][idxs][:, ::s, ::s]
            out["base_rays_origins"] = self.data["base_rays_origins"][::s, ::s]
            out["base_rays_dirs"] = self.data["base_rays_dirs"][::s, ::s]
        return out
