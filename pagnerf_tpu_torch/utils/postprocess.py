"""Validation-time instance-map post-processing (counterpart of
``pagnerf_tpu/utils/postprocess.py``), a numpy copy: the reference's cleanup
of a predicted instance map before the PQ and mAP updates --
  * morphological opening of per-instance masks (``inst_num_dilations``
    3x3 openings, ``scipy.ndimage``);
  * centre-of-mass outlier rejection (pixels beyond mean + 2 std of the
    distance to the mask centroid are stripped);
  * small-mask removal (< ``min_mask_px``) and background re-assignment --
and the decode of the rendered instance slots into an id map.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def _binary_open(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """3x3 opening (erosion then dilation) of masks [K, H, W]."""
    out = np.zeros_like(mask)
    st = np.ones((3, 3), bool)
    for i in range(mask.shape[0]):
        m = mask[i].astype(bool)
        for _ in range(iterations):
            m = ndimage.binary_opening(m, structure=st)
        out[i] = m
    return out.astype(mask.dtype)


def center_of_mass_outlier_rejection(masks: np.ndarray,
                                     std_threshold: float = 2.0) -> np.ndarray:
    """Strip mask pixels farther than mean + std_threshold * std from the mask's
    centre of mass (the reference's outlier rejection). masks [K, H, W]."""
    masks = masks.copy()
    h, w = masks.shape[-2:]
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for i in range(masks.shape[0]):
        m = masks[i].astype(bool)
        area = m.sum()
        if area == 0:
            continue
        cy, cx = gy[m].mean(), gx[m].mean()
        dist = np.sqrt((gy - cy) ** 2 + (gx - cx) ** 2)
        dvals = dist[m]
        mean_d, std_d = dvals.mean(), dvals.std()
        keep = dist <= mean_d + std_threshold * std_d
        masks[i] = (m & keep).astype(masks.dtype)
    return masks


def decode_instance_map(e: np.ndarray, sem_map: np.ndarray,
                        stuff_ids, gated: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Instance id map (+ per-pixel confidence) from rendered slot activations.

    ``gated``: the semantic-gated decode for linear_assignment_things-trained
    heads. That loss trains slot 0 to mean "semantic stuff" BY CONSTRUCTION
    (virtual label 0 exactly on stuff pixels, losses/lin_assignment.py), so the
    stronger semantic head decides stuff-vs-things and the instance head only
    picks WHICH thing (slots 1..M-1). A plain joint argmax lets the stuff slot
    swallow things pixels wherever rendering is soft (novel-view blur) —
    measured on the JAX package's schedule checkpoint, gating recovers +0.07
    PQ-things / +0.09 RQ-things. The confidence is the activation of the slot
    the decode actually CHOSE (not the joint max, which can belong to the
    gated-out stuff slot).

    e [N, M] slot activations; sem_map [H, W]. Returns (inst_map [H, W],
    inst_conf [H, W])."""
    h, w = sem_map.shape
    if gated:
        things_px = ~np.isin(sem_map, np.asarray(stuff_ids))
        inst_map = np.where(things_px,
                            1 + np.argmax(e[:, 1:], -1).reshape(h, w), 0)
        inst_conf = np.where(things_px,
                             np.max(e[:, 1:], -1).reshape(h, w),
                             e[:, 0].reshape(h, w))
    else:
        inst_map = np.argmax(e, -1).reshape(h, w)
        inst_conf = np.max(e, -1).reshape(h, w)
    return inst_map, inst_conf


def clean_instance_map(instances: np.ndarray, num_dilations: int = 1,
                       outlier_rejection: bool = True,
                       min_mask_px: int = 100) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full cleanup pipeline on an instance id map [H, W]
    (the reference trainer's). Returns (cleaned id map, per-instance masks
    [K, H, W], mask ids [K])."""
    mask_ids = np.unique(instances)
    # Background is id 0 EXPLICITLY (the decode contract: stuff -> 0), not
    # "the lowest id present" — the reference's mask_ids[1:] silently treats a
    # real instance as background on frames with no background pixels at all,
    # excluding it from mAP and smearing its id over uncovered pixels
    # (a documented deviation from the reference; identical whenever a 0
    # pixel exists).
    fg_ids = mask_ids[mask_ids != 0]
    if fg_ids.shape[0] == 0:
        return instances, np.zeros((0,) + instances.shape, instances.dtype), fg_ids
    masks = (instances[None] == fg_ids[:, None, None]).astype(instances.dtype)
    if num_dilations > 0:
        masks = _binary_open(masks, num_dilations)
    if outlier_rejection:
        masks = center_of_mass_outlier_rejection(masks)
    small = masks.sum(axis=(1, 2)) < min_mask_px
    masks[small] = 0
    stacked = np.concatenate([(masks.sum(0) == 0)[None].astype(instances.dtype),
                              masks])
    row_ids = np.concatenate([[0], fg_ids]).astype(instances.dtype)
    cleaned = row_ids[np.argmax(stacked, axis=0)]
    return cleaned, masks, fg_ids
