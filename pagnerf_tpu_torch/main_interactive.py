"""Entry point with class registration (counterpart of ``main_interactive.py``).

Registers every NeF, trainer, tracer and grid class under its config name,
then runs the command line (``cli.main``) with its mode dispatch:
``--valid-only``, ``--render-views``, ``--viewer``, ``--save-map-only`` or
training.

    python -m pagnerf_tpu_torch.main_interactive --config <yaml> [--device cpu] ...
"""
from __future__ import annotations

import sys

from . import cli
from .config.config import register_class
from .config.factory import register_default_classes
from .models.grids import HashGrid, PermutoGrid, TriplanarGrid
from .models.tensorf import TensoRFGrid
from .models.tracer import TracerConfig
from .train.trainer import PanopticTrainer


def register_all() -> None:
    register_default_classes()
    register_class(PanopticTrainer, "PanopticTrainer")
    for name in ("PanopticPackedRFTracer", "PanopticDDensityPackedRFTracer",
                 "PackedRFTracer"):
        register_class(TracerConfig, name)
    for g in (PermutoGrid, HashGrid, TriplanarGrid, TensoRFGrid):
        register_class(g, g.__name__)


def main(argv=None):
    register_all()
    return cli.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
