"""Render buffer (counterpart of ``pagnerf_tpu/core/render_buffer.py``).

Per-ray output channels, ``None`` where not rendered. Shapes follow the JAX
package: ``rgb [R, 3]``, ``depth [R, 1]``, ``alpha [R, 1]``, ``hit [R]``,
``semantics [R, num_classes]``, ``inst_embedding [R, num_instances]``,
``panoptic_alpha [R, 1]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class RenderBuffer:
    rgb: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None
    hit: Optional[torch.Tensor] = None
    semantics: Optional[torch.Tensor] = None
    inst_embedding: Optional[torch.Tensor] = None
    panoptic_alpha: Optional[torch.Tensor] = None

    @staticmethod
    def concatenate(buffers) -> "RenderBuffer":
        """Chunked renders joined along the ray axis; a channel absent from
        the first buffer stays absent."""
        out = {}
        for f in dataclasses.fields(RenderBuffer):
            vals = [getattr(b, f.name) for b in buffers]
            if vals[0] is not None:
                out[f.name] = torch.cat(vals, dim=0)
        return RenderBuffer(**out)
