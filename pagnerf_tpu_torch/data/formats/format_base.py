"""Dataset format protocol (counterpart of
``pagnerf_tpu/data/formats/format_base.py``): every format module exposes a
loader producing the standard data dict (see ``data/synthetic.py`` for the
field list: imgs, label modes, rays and base rays, view matrices,
intrinsics, semantic_info, split indices).
"""
from __future__ import annotations

from typing import Dict, Protocol


class DatasetFormat(Protocol):
    def load_data(self, root: str, split: str = "train", **kwargs) -> Dict:
        """Load the dataset from disk into the standard data dict."""
        ...


# format name -> loader module, as ``config/factory.py::load_dataset`` dispatches
FORMATS = {
    "synthetic": "pagnerf_tpu_torch.data.synthetic",
    "bup20": "pagnerf_tpu_torch.data.formats.bup20",
    "standard": "pagnerf_tpu_torch.data.formats.nerf_standard",
    "nerf_standard": "pagnerf_tpu_torch.data.formats.nerf_standard",
}
