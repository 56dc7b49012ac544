"""COCO annotations (counterpart of ``pagnerf_tpu/data/formats/coco.py``):
JSON parsing, per-image annotation lookup, and segmentations rasterised
from polygons (``image_io.fill_polygon``, PIL's ``ImageDraw.polygon`` in
numpy), uncompressed RLE runs and compressed RLE strings.

``encode_rle`` is the inverse of the compressed-RLE decode, for writing
annotations (pycocotools' ``mask.encode`` string format).
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ..image_io import fill_polygon


def _decode_compressed_rle(counts, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE (LEB128-style, 6 bits per character) -> [h, w]
    mask."""
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    cnts: List[int] = []
    i = 0
    while i < len(counts):
        x, k, more = 0, 0, True
        while more:
            c = counts[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return _runs_to_mask(cnts, h, w)


def _runs_to_mask(runs: List[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in runs:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    # COCO RLE is column-major
    return flat.reshape(w, h).T


def mask_to_runs(mask: np.ndarray) -> List[int]:
    """[h, w] mask -> alternating runs of 0 and 1 in column-major order,
    starting with a (possibly empty) run of zeros."""
    flat = (np.asarray(mask).T.reshape(-1) != 0).astype(np.int8)
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        runs = [0] + runs
    return runs


def encode_rle(mask: np.ndarray) -> Dict:
    """[h, w] mask -> ``{"size": [h, w], "counts": str}`` in COCO's
    compressed RLE: each run after the second as the difference to the
    run two before, written 5 bits per character (a sixth for "more")."""
    runs = mask_to_runs(mask)
    out = []
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return {"size": [int(mask.shape[0]), int(mask.shape[1])], "counts": "".join(out)}


def _polygons_to_mask(polys, h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), np.uint8)
    for poly in polys:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            fill_polygon(m, pts)
    return m


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """pycocotools ``annToMask`` equivalent."""
    seg = ann.get("segmentation")
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, list):
        return _polygons_to_mask(seg, h, w)
    counts = seg["counts"]
    sh, sw = seg.get("size", (h, w))
    if isinstance(counts, list):
        return _runs_to_mask(counts, sh, sw)
    return _decode_compressed_rle(counts, sh, sw)


class COCO:
    """Subset of the pycocotools COCO API used by the sequence loader."""

    def __init__(self, annotation_file):
        with open(annotation_file) as f:
            self.dataset = json.load(f)
        self.imgs = {im["id"]: im for im in self.dataset.get("images", [])}
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}
        self.img_to_anns: Dict[int, List[Dict]] = {}
        for ann in self.dataset.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    def getImgIds(self):
        return list(self.imgs.keys())

    def loadImgs(self, ids):
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds, catIds=None, iscrowd=None):
        if isinstance(imgIds, (int, np.integer)):
            imgIds = [imgIds]
        anns = [a for i in imgIds for a in self.img_to_anns.get(i, [])]
        if catIds:
            anns = [a for a in anns if a["category_id"] in set(catIds)]
        return [a["id"] for a in anns]

    def loadAnns(self, ids):
        ids = set(ids)
        return [a for anns in self.img_to_anns.values() for a in anns
                if a["id"] in ids]

    def annToMask(self, ann) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        return ann_to_mask(ann, img["height"], img["width"])
