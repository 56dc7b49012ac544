"""Run logging (counterpart of ``pagnerf_tpu/utils/logging_utils.py``):
stdout logging with a per-run ``log.txt``, a scalar writer and a phase timer.

``SummaryWriter`` writes its events to ``events.jsonl`` in the run's log
directory, one JSON object per line (the card's machine has no TensorBoard).
``PerfTimer`` is the host-clock phase timer that ``--perf`` activates; the
trainer calls ``reset`` before each step's batch sampling and ``check`` after
the sampling and after the step, and records each prune and each epoch; the
command line records each validation and writes every record to the run's
``perf.jsonl``. Every call is a no-op while it is off.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np


def default_log_setup(level: int = logging.INFO, log_dir: Optional[str] = None):
    """Logging to stdout and, with ``log_dir``, to ``log_dir/log.txt``."""
    handlers = [logging.StreamHandler()]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(log_dir, "log.txt")))
    logging.basicConfig(level=level, handlers=handlers, force=True,
                        format="%(asctime)s|%(levelname)8s| %(message)s")


class SummaryWriter:
    """Scalar and image events, appended to ``log_dir/events.jsonl``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "events.jsonl"), "a")

    def _write(self, record: Dict) -> None:
        self._f.write(json.dumps({**record, "wall": time.time()}) + "\n")
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step)})

    def add_image(self, tag: str, img, step: int) -> None:
        """A validation frame (``--log-2d``): the event records its tag, step
        and shape; the pixels are in the run's PNGs."""
        self._write({"tag": tag, "image_shape": list(np.asarray(img).shape),
                     "step": int(step)})

    def close(self) -> None:
        self._f.close()


class PerfTimer:
    """Host-clock phase timer. ``check(name, **tags)`` records the time since
    the last ``reset`` or ``check`` under ``name``; ``record(name, seconds,
    **tags)`` records a span timed by its caller. A record adds to
    ``records[name]``, is logged, and, once ``path`` is set, is appended to
    that file as one JSON line ``{"name", "ms", **tags}`` (the run's
    ``perf.jsonl``). Inactive (``activate=False``), every call is a no-op."""

    def __init__(self, activate: bool = False):
        self.activate = activate
        self.path: Optional[str] = None
        self._last = time.perf_counter()
        self.records: Dict[str, float] = {}

    def reset(self) -> None:
        self._last = time.perf_counter()

    def check(self, name: str, **tags) -> None:
        if not self.activate:
            return
        now = time.perf_counter()
        self.record(name, now - self._last, **tags)
        self._last = now

    def record(self, name: str, seconds: float, **tags) -> None:
        if not self.activate:
            return
        self.records[name] = self.records.get(name, 0.0) + seconds
        logging.getLogger("perf").info("%s: %.2fms", name, seconds * 1000)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"name": name, "ms": seconds * 1e3, **tags},
                                   default=float) + "\n")
