"""Clustering NeFs (counterpart of ``pagnerf_tpu/models/clustering_nef.py``):
NeFs whose instance embeddings are decoded into instance ids by a mean-shift
model fitted at validation time. The NeF only carries ``use_clustering``;
validation owns the host-side clustering (``utils/clustering.py``)."""
from __future__ import annotations

from .nefs import PanopticDDensityNeF, PanopticDeltaNeF, PanopticNeF


class MeanShiftPanopticNeF(PanopticNeF):
    use_clustering = True


class MeanShiftPanopticDeltaNeF(PanopticDeltaNeF):
    use_clustering = True


class MeanShiftPanopticDDensityNeF(PanopticDDensityNeF):
    use_clustering = True
