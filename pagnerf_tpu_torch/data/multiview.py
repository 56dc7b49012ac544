"""Multiview dataset wrapper (counterpart of ``pagnerf_tpu/data/multiview.py``).

The render slice needs only what ``entry()`` reads from the dataset: the data
dict, its ``semantic_info`` and the interleaved train/val split. Ray-batch
sampling and image pyramids serve training and validation and are not ported
yet.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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

    @property
    def semantic_info(self) -> Dict:
        return self.data["semantic_info"]
