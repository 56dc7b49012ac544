"""Validation media (counterpart of ``pagnerf_tpu/utils/visualization.py``):
label, instance and depth colouring, PNG frames and per-channel videos.

``label_colormap``, ``label2rgb`` and ``depth2rgb`` are numpy copies of the
JAX package's. The card's machine has neither PIL nor imageio, so
``write_png`` encodes the PNG with the standard library (``zlib``,
``struct``), and ``write_video`` writes the strip of PNG frames that the
JAX package writes when imageio is missing.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def label_colormap(n_labels: int = 256) -> np.ndarray:
    """PASCAL-VOC style colormap [n, 3] uint8 (imgviz.label_colormap equivalent)."""
    def bitget(v, i):
        return (v >> i) & 1

    cmap = np.zeros((max(n_labels, 1), 3), np.uint8)
    for i in range(cmap.shape[0]):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def label2rgb(label: np.ndarray, colormap: Optional[np.ndarray] = None,
              image: Optional[np.ndarray] = None, alpha: float = 0.5) -> np.ndarray:
    """Label map [H, W] -> RGB uint8; optionally alpha-blended over an image."""
    label = np.asarray(label)
    if colormap is None:
        colormap = label_colormap(int(label.max()) + 1 if label.size else 1)
    lab = np.clip(label, 0, colormap.shape[0] - 1).astype(np.int64)
    rgb = colormap[lab]
    if image is not None:
        img = image.astype(np.float64)
        if img.max() <= 1.0:
            img = img * 255
        fg = label > 0
        out = img.copy()
        out[fg] = (1 - alpha) * img[fg] + alpha * rgb[fg]
        return out.astype(np.uint8)
    return rgb.astype(np.uint8)


def depth2rgb(depth: np.ndarray, min_value: Optional[float] = None,
              max_value: Optional[float] = None) -> np.ndarray:
    """Depth map -> perceptual RGB uint8 (imgviz.depth2rgb equivalent; viridis-ish)."""
    d = np.asarray(depth, np.float64)
    lo = np.nanmin(d) if min_value is None else min_value
    hi = np.nanmax(d) if max_value is None else max_value
    t = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    # compact viridis approximation
    r = np.clip(1.38 * t - 0.23 * np.sin(6.8 * t) - 0.15, 0, 1)
    g = np.clip(0.96 * t + 0.07, 0, 1)
    b = np.clip(0.35 + 0.6 * np.cos(2.7 * t - 1.1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """uint8 (or [0, 1] float) image [H, W], [H, W, 3] or [H, W, 4] -> an
    8-bit grey, RGB or RGBA PNG, every row unfiltered."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}[channels]
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


def write_video(path: str, frames: Sequence[np.ndarray]):
    """Frames -> ``<path without extension>_<i:04d>.png``, one PNG per frame."""
    base = os.path.splitext(path)[0]
    for i, f in enumerate(frames):
        write_png(f"{base}_{i:04d}.png", f)
