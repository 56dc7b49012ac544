"""Mean-shift clustering of instance embeddings (counterpart of
``pagnerf_tpu/utils/clustering.py``), a numpy copy.

Per-GT-mask mean embeddings are clustered at validation time; prediction maps
rendered embeddings to cluster ids. The JAX package fits sklearn's
``MeanShift`` where sklearn is installed and falls back to
``_SimpleMeanShift``, a flat-kernel mean shift. The card's machine has no
sklearn, so the port always fits ``_SimpleMeanShift``. Only a NeF with
``use_clustering`` (not the flagship's) reaches this module. Its distances
are computed over chunks of rows, bit-equal to the JAX package's one
broadcast, so that a 320x180 image's [pixels, centres, D] float64
differences are never held at once.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def mean_class_embedding(embeddings: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Class-wise mean embedding centres per batch sample. embeddings
    [B, R, D], labels [B, R] -> [sum_b num_unique_labels_b, D]."""
    centers = []
    for x, l in zip(embeddings, labels):
        for lab in np.unique(l):
            centers.append(x[l == lab].mean(axis=0))
    if not centers:
        return np.zeros((0, embeddings.shape[-1]), embeddings.dtype)
    return np.stack(centers)


class MeanShift:
    """Fit on per-label mean embeddings, predict cluster ids."""

    def __init__(self):
        self.ms = None

    def train_clustering(self, embeddings: np.ndarray, labels: np.ndarray):
        centers = mean_class_embedding(embeddings, labels)
        if centers.size == 0:
            return
        self.ms = _SimpleMeanShift().fit(centers)

    def predict_clusters(self, embeddings: np.ndarray) -> np.ndarray:
        """[..., D] -> [...] int cluster ids. Without a fitted model, the
        argmax of the normalised embeddings."""
        shape = embeddings.shape[:-1]
        flat = embeddings.reshape(-1, embeddings.shape[-1])
        if self.ms is None:
            n = flat / (np.linalg.norm(flat, axis=-1, keepdims=True) + 1e-12)
            return np.argmax(n, axis=-1).reshape(shape)
        return self.ms.predict(flat).astype(np.int64).reshape(shape)


# float64 entries of one chunk's [rows, K, D] difference array (64 MiB)
CHUNK_ELEMS = 1 << 23


def pair_dists(a: np.ndarray, b: np.ndarray, max_elems: Optional[int] = None) -> np.ndarray:
    """``np.linalg.norm(a[:, None] - b[None], axis=-1)`` [Na, Nb], computed
    over chunks of a's rows so that no difference array holds more than
    ``max_elems`` (default ``CHUNK_ELEMS``) entries. Each entry is computed
    as in the one broadcast, so the result is bit-equal to it."""
    rows = max(1, (max_elems or CHUNK_ELEMS) // max(1, b.shape[0] * b.shape[1]))
    if a.shape[0] <= rows:
        return np.linalg.norm(a[:, None] - b[None], axis=-1)
    return np.concatenate([np.linalg.norm(a[i:i + rows, None] - b[None], axis=-1)
                           for i in range(0, a.shape[0], rows)])


class _SimpleMeanShift:
    """Flat-kernel mean shift on the (few) centres; distances in chunks
    (``pair_dists``)."""

    def __init__(self, bandwidth: Optional[float] = None, iters: int = 30):
        self.bandwidth = bandwidth
        self.iters = iters
        self.cluster_centers_ = None

    def fit(self, x: np.ndarray) -> "_SimpleMeanShift":
        if self.bandwidth is None:
            d = pair_dists(x, x)
            vals = d[d > 0]
            self.bandwidth = float(np.quantile(vals, 0.3)) if vals.size else 1.0
        pts = x.copy()
        for _ in range(self.iters):
            d = pair_dists(pts, x)
            w = (d < self.bandwidth).astype(np.float64)
            pts = (w @ x) / np.maximum(w.sum(1, keepdims=True), 1)
        # merge modes
        centers = []
        for p in pts:
            if not any(np.linalg.norm(p - c) < self.bandwidth / 2 for c in centers):
                centers.append(p)
        self.cluster_centers_ = np.stack(centers)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.argmin(pair_dists(x, self.cluster_centers_), axis=-1)
