"""Validation metrics (counterpart of ``pagnerf_tpu/utils/metrics.py``):
PSNR, macro IoU, Panoptic Quality and instance-segmentation mAP.

A numpy copy of the JAX package's host-side metrics, which follow the
reference's stack: torchmetrics PSNR / JaccardIndex / MeanAveragePrecision
(``iou_type='segm'``) and its own PanopticQuality (segments keyed by
(category, instance), IoU > 0.5 matching with void-area discounting). They
run on the host, on the rendered maps read back from the card.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np


class PSNR:
    """Peak signal-to-noise ratio, accumulated over updates (data range 1.0)."""

    def __init__(self):
        self.se = 0.0
        self.count = 0

    def update(self, pred: np.ndarray, target: np.ndarray):
        self.se += float(((pred - target) ** 2).sum())
        self.count += pred.size

    def compute(self) -> float:
        if self.count == 0:
            return 0.0
        mse = self.se / self.count
        return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


class IoU:
    """Macro-averaged multiclass Jaccard index via confusion-matrix accumulation."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.confusion = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: np.ndarray, target: np.ndarray):
        p = pred.reshape(-1).astype(np.int64)
        t = target.reshape(-1).astype(np.int64)
        valid = (t >= 0) & (t < self.num_classes) & (p >= 0) & (p < self.num_classes)
        idx = t[valid] * self.num_classes + p[valid]
        self.confusion += np.bincount(
            idx, minlength=self.num_classes ** 2).reshape(self.num_classes, -1)

    def compute(self) -> float:
        inter = np.diag(self.confusion).astype(np.float64)
        union = (self.confusion.sum(0) + self.confusion.sum(1) - inter).astype(np.float64)
        seen = union > 0
        if not seen.any():
            return 0.0
        return float((inter[seen] / union[seen]).mean())


# ---------------------------------------------------------------------------
# Panoptic Quality (reference utils/metrics/panoptic_quality_func.py)
# ---------------------------------------------------------------------------

class PanopticQuality:
    """PQ/SQ/RQ x {all, things, stuff}. ``update`` takes [B, 2, H, W] arrays
    (channel 0 = category id, channel 1 = instance id), same convention as the
    reference (panoptic_quality_func.py:67)."""

    def __init__(self, things: Set[int], stuff: Set[int],
                 allow_unknown_preds_category: bool = True):
        self.things = sorted(things)
        self.stuff = sorted(stuff)
        self.allow_unknown = allow_unknown_preds_category
        self.void = (1 + max([0] + self.things + self.stuff), 0)
        self.cat_to_cont = {c: i for i, c in enumerate(self.things)}
        self.cat_to_cont.update({c: i + len(self.things) for i, c in enumerate(self.stuff)})
        n = len(self.things) + len(self.stuff)
        self.iou_sum = np.zeros(n)
        self.tp = np.zeros(n, np.int64)
        self.fp = np.zeros(n, np.int64)
        self.fn = np.zeros(n, np.int64)

    def _preprocess(self, img: np.ndarray) -> np.ndarray:
        """[B, 2, H, W] -> [N, 2] with batch-unique instance ids, stuff instance ids
        zeroed, unknown categories voided (panoptic_quality_func.py:99-121)."""
        img = np.array(img, np.int64, copy=True)
        for b in range(img.shape[0] - 1):
            img[b + 1, 1] += img[b, 1].max()
        flat = np.moveaxis(img, 1, -1).reshape(-1, 2)
        is_stuff = np.isin(flat[:, 0], self.stuff)
        is_thing = np.isin(flat[:, 0], self.things)
        flat[is_stuff, 1] = 0
        unknown = ~(is_stuff | is_thing)
        if unknown.any():
            if not self.allow_unknown:
                raise ValueError("unknown categories in preds")
            flat[unknown] = self.void
        return flat

    @staticmethod
    def _areas(arr: np.ndarray) -> Dict[tuple, int]:
        colors, counts = np.unique(arr, axis=0, return_counts=True)
        return {tuple(c): int(n) for c, n in zip(colors, counts)}

    def update(self, preds: np.ndarray, target: np.ndarray):
        fp_img = self._preprocess(preds)
        ft_img = self._preprocess(target)
        pred_areas = self._areas(fp_img)
        target_areas = self._areas(ft_img)
        inter = self._areas(np.concatenate([fp_img, ft_img], axis=1))
        inter = {((k[0], k[1]), (k[2], k[3])): v for k, v in inter.items()}

        pred_matched, target_matched = set(), set()
        for (pc, tc), inter_area in inter.items():
            if tc == self.void or pc[0] != tc[0]:
                continue
            cid = self.cat_to_cont[pc[0]]
            pva = inter.get((pc, self.void), 0)
            vta = inter.get((self.void, tc), 0)
            union = pred_areas[pc] - pva + target_areas[tc] - vta - inter_area
            iou = inter_area / union if union > 0 else 0.0
            if iou > 0.5:
                pred_matched.add(pc)
                target_matched.add(tc)
                self.iou_sum[cid] += iou
                self.tp[cid] += 1
        for tc in set(target_areas) - target_matched - {self.void}:
            if inter.get((self.void, tc), 0) / target_areas[tc] > 0.5:
                continue
            self.fn[self.cat_to_cont[tc[0]]] += 1
        for pc in set(pred_areas) - pred_matched - {self.void}:
            if pc[0] not in self.cat_to_cont:
                continue
            if inter.get((pc, self.void), 0) / pred_areas[pc] > 0.5:
                continue
            self.fp[self.cat_to_cont[pc[0]]] += 1

    def compute(self) -> Dict[str, Dict[str, float]]:
        dets = self.tp + self.fp + self.fn
        denom = self.tp + 0.5 * self.fp + 0.5 * self.fn
        pq = np.where(denom > 0, self.iou_sum / np.maximum(denom, 1e-9), 0.0)
        sq = np.where(self.tp > 0, self.iou_sum / np.maximum(self.tp, 1), 0.0)
        rq = np.where(denom > 0, self.tp / np.maximum(denom, 1e-9), 0.0)
        nt = len(self.things)

        def group(sl) -> Dict[str, float]:
            seen = dets[sl] != 0
            if not seen.any():
                return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": int(seen.size)}
            return {"pq": float(pq[sl][seen].mean()), "sq": float(sq[sl][seen].mean()),
                    "rq": float(rq[sl][seen].mean()), "n": int(seen.size)}

        return {"all": group(slice(None)), "things": group(slice(0, nt)),
                "stuff": group(slice(nt, None))}


# ---------------------------------------------------------------------------
# Instance-segmentation mAP (torchmetrics MeanAveragePrecision(iou_type='segm')
# equivalent for the reference's single-class usage, trainer.py:794-798)
# ---------------------------------------------------------------------------

def _mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a [N, H, W], b [M, H, W] boolean -> IoU [N, M]."""
    af = a.reshape(a.shape[0], -1).astype(np.float64)
    bf = b.reshape(b.shape[0], -1).astype(np.float64)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


class MeanAveragePrecision:
    """COCO-style segm mAP over IoU thresholds .50:.05:.95 (single label class)."""

    def __init__(self):
        self.entries: List[Tuple[np.ndarray, np.ndarray, int]] = []

    def update(self, pred_masks: np.ndarray, pred_scores: np.ndarray,
               gt_masks: np.ndarray):
        iou = _mask_iou(pred_masks.astype(bool), gt_masks.astype(bool)) \
            if len(pred_masks) and len(gt_masks) else np.zeros((len(pred_masks),
                                                                len(gt_masks)))
        self.entries.append((np.asarray(pred_scores, np.float64), iou,
                             int(len(gt_masks))))

    def _ap_at(self, thr: float) -> float:
        scores, matched, total_gt = [], [], 0
        for s, iou, ngt in self.entries:
            total_gt += ngt
            order = np.argsort(-s)
            taken = np.zeros(ngt, bool)
            for i in order:
                scores.append(s[i])
                best, best_j = thr, -1
                for j in range(ngt):
                    if not taken[j] and iou[i, j] >= best:
                        best, best_j = iou[i, j], j
                if best_j >= 0:
                    taken[best_j] = True
                    matched.append(1.0)
                else:
                    matched.append(0.0)
        if total_gt == 0 or not scores:
            return 0.0 if total_gt else -1.0
        order = np.argsort(-np.asarray(scores))
        m = np.asarray(matched)[order]
        tp = np.cumsum(m)
        fp = np.cumsum(1 - m)
        recall = tp / total_gt
        precision = tp / np.maximum(tp + fp, 1e-9)
        # 101-point interpolation
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            p = precision[recall >= r].max() if (recall >= r).any() else 0.0
            ap += p / 101
        return float(ap)

    def compute(self) -> Dict[str, float]:
        thrs = np.arange(0.5, 1.0, 0.05)
        aps = [self._ap_at(t) for t in thrs]
        valid = [a for a in aps if a >= 0]
        return {"map": float(np.mean(valid)) if valid else 0.0,
                "map_50": max(aps[0], 0.0), "map_75": max(aps[5], 0.0)}
