"""Multiview dataset wrapper (counterpart of ``pagnerf_tpu/data/multiview.py``).

Ported: the data dict, its ``semantic_info``, the interleaved train/val
split, and ``sample_batch`` (random images x random rays per image), as a
numpy copy. The JAX package samples distinct pixels with its C++ helper when
that is built; the port takes the helper's numpy fallback (the same
distribution, other numbers). When an image has fewer pixels than the rays
asked for -- the flagship's 4096 rays of a 64x48 image -- both sample with
replacement from one ``np.random.default_rng`` and give the same batch bit
for bit. Image pyramids for validation are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# Pixel modes that get flattened and ray-sampled.
PIXEL_MODES = ("imgs", "semantics", "instance", "semantics_pred", "instance_pred",
               "sem_conf", "inst_conf", "depths", "rays_origins", "rays_dirs")


def sample_ray_indices(batch: int, num_rays: int, num_pixels: int,
                       seed: int) -> np.ndarray:
    """[batch, num_rays] pixel indices per image: distinct while the pool
    allows, with replacement when ``num_rays`` exceeds it."""
    rng = np.random.default_rng(seed)
    if num_rays > num_pixels:
        return rng.integers(0, num_pixels, (batch, num_rays)).astype(np.int64)
    return np.stack([rng.choice(num_pixels, num_rays, replace=False)
                     for _ in range(batch)]).astype(np.int64)


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
        ray_idx = sample_ray_indices(len(img_idx), num_rays, pool,
                                     int(rng.integers(2 ** 62)))
        if self._valid_pixels is not None:
            ray_idx = self._valid_pixels[ray_idx]
        batch = {"cam_idx": img_idx.astype(np.int32)}
        for mode in PIXEL_MODES:
            if mode in self.data:
                arr = self.data[mode]
                flat = arr.reshape(arr.shape[0], self.num_pixels, *arr.shape[3:])
                batch[mode] = flat[img_idx[:, None], ray_idx]
        bo = self.data["base_rays_origins"].reshape(self.num_pixels, 3)
        bd = self.data["base_rays_dirs"].reshape(self.num_pixels, 3)
        batch["base_rays_origins"] = bo[ray_idx]
        batch["base_rays_dirs"] = bd[ray_idx]
        return batch
