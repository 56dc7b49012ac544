"""Command-line entry point of the port (counterpart of ``main.py``).

    python -m pagnerf_tpu_torch.cli --config configs/synthetic/tiny.yaml --device cpu
    python -m pagnerf_tpu_torch.cli --config configs/synthetic/schedule_preds_flagship_tuned_60ep.yaml

It takes the JAX package's flags and YAML configs (``config/config.py``)
plus ``--device`` (default ``cuda``; without a card only ``--device cpu``
runs). The flow is ``main.py``'s: a log directory per run
(``<log_dir>/<exp_name or run>/<timestamp>``) with ``log.txt``,
``events.jsonl`` and the config snapshot ``config.yaml``; ``--pretrained``
restores a checkpoint in ``--model-format``; then ``--valid-only`` runs one
validation of ``--valid-split``, ``--save-map-only`` writes the point-cloud
map to ``nerf_pc.pkl``, and otherwise the trainer trains, validating every
``valid_every`` epochs and checkpointing to ``model.ckpt`` every
``save_every``, then writes a final checkpoint and runs a final validation.
Returns the metrics of the last validation (or the map). With ``--perf``
the trainer's timer writes each step, prune, epoch and validation, with
its wall on the host clock, to ``perf.jsonl`` in the run directory.

``main(argv, **trainer_fields)`` is the same run called from Python:
``trainer_fields`` replace ``TrainerConfig`` fields that no flag sets
(``seed``, ``compact_steps_after_prune``; ``config/factory.py``).

``--render-views``, ``--viewer`` and ``--validate-dataset`` raise
``NotImplementedError`` (``ROADMAP.md`` Queue 1 item 9).
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle
import sys
import time
from typing import Optional, Sequence

from .config.config import build_parser, config_to_yaml, parse_options
from .config.factory import get_modules_from_config
from .device import resolve_device
from .train import checkpoint
from .train.validation import validate
from .utils.logging_utils import SummaryWriter, default_log_setup
from .utils.render_map import generate_pc_map_from_views

_ITEM9 = "ROADMAP.md Queue 1 item 9"


def split_device(argv: Sequence[str]):
    """(device, the other arguments): ``--device`` is the port's one flag
    beside the JAX package's table."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(list(argv))
    return ns.device, rest


def main(argv: Optional[Sequence[str]] = None, **trainer_fields):
    """Run the command line ``argv`` (default ``sys.argv[1:]``)."""
    device, rest = split_device(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    args = parse_options(rest)
    for flag in ("validate_dataset", "render_views", "viewer"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet ({_ITEM9})")

    stamp = time.strftime("%Y%m%d-%H%M%S")
    log_dir = os.path.join(args.log_dir, args.exp_name or "run", stamp)
    default_log_setup(args.log_level, log_dir)
    log = logging.getLogger(__name__)

    if args.detect_anomaly:
        import torch
        torch.autograd.set_detect_anomaly(True)

    pipeline, dataset, trainer = get_modules_from_config(args, dev, **trainer_fields)
    trainer.timer.path = os.path.join(log_dir, "perf.jsonl")
    writer = SummaryWriter(log_dir)
    with open(os.path.join(log_dir, "config.yaml"), "w") as f:
        f.write(config_to_yaml(build_parser(), args))

    if args.pretrained:
        checkpoint.load_checkpoint(args.pretrained, trainer, args.model_format)
    log.info("total number of parameters: %d",
             sum(p.numel() for p in trainer.params.values()))

    def timed_validate(epoch, **kwargs):
        t0 = time.perf_counter()
        metrics = validate(trainer, epoch, log_dir=log_dir, **kwargs)
        trainer.timer.record("validate", time.perf_counter() - t0, epoch=epoch,
                             metrics=metrics)
        return metrics

    if args.valid_only:
        metrics = timed_validate(trainer.epoch, split=args.valid_split)
        log.info("validation: %s", metrics)
        writer.close()
        return metrics

    if args.save_map_only:
        out = generate_pc_map_from_views(trainer, mip=2)
        with open(os.path.join(log_dir, "nerf_pc.pkl"), "wb") as f:
            pickle.dump(out, f)
        log.info("saved point-cloud map (%d points)", len(out["points"]))
        writer.close()
        return out

    def on_epoch_end(epoch, totals):
        log.info(f"EPOCH {epoch}/{args.epochs} | " + " | ".join(
            f"{k}: {v:.3E}" for k, v in totals.items()))
        for k, v in totals.items():
            writer.add_scalar(f"Loss/{k}", v, epoch)
        if args.valid_every > 0 and (epoch + 1) % args.valid_every == 0:
            metrics = timed_validate(epoch, writer=writer)
            log.info("val: %s", {k: round(v, 4) for k, v in metrics.items()})
            for k, v in metrics.items():
                writer.add_scalar(k, v, epoch)
        if args.save_every > 0 and (epoch + 1) % args.save_every == 0:
            checkpoint.save_checkpoint(os.path.join(log_dir, "model.ckpt"), trainer,
                                       save_as_new=args.save_as_new)

    trainer.train(on_epoch_end=on_epoch_end)
    checkpoint.save_checkpoint(os.path.join(log_dir, "model.ckpt"), trainer)
    metrics = timed_validate(trainer.epoch)
    writer.close()
    return metrics


if __name__ == "__main__":
    main()
