"""The host loop's training step, stage by stage, on the CUDA card, for one
checkout of the port against another.

    python pagnerf_tpu_torch/profile_host_loop.py [--tree DIR] [--steps N]
        [--config YAML] [--device cuda|cpu]

Imports ``pagnerf_tpu_torch`` from ``--tree`` (default: the checkout this
file is in; run it as a file, not with ``-m``, so that another checkout's
package is the one imported) and builds that checkout's trainer of
``configs/synthetic/schedule_preds_flagship_tuned_60ep.yaml`` at full width
(or ``--config``'s, the CPU at a tiny size for a check of this script)
with ``chip_smoke.py``'s ``CLI_FLAGS`` (``STAGE_FLAGS`` below), random
weights from the config's seed. Per stage of that run -- dense RGB (epoch
0); then, after a seed prune, a real prune and the scene fixture
(``entry.apply_scene_fixture``), packed RGB (1), voxel packed panoptic (2)
and val-pose (3) -- on one batch of the stage's split:

- ``step_ms``: the wall of ``train_step`` with its losses read back at once
  (what the ``--perf`` timer reads at ``dispatch_ahead`` 0), median of
  ``--steps`` after 2 warm-ups;
- ``update_ms``: the wall of ``opt.update`` alone on one microbatch's
  gradients, synchronised, median of 10 after 2 warm-ups.

Prints one JSON line: the card (``nvidia-smi``), the tree, the stages by
epoch and label.
Compare two checkouts only within one machine's call, in turns (A, B, B,
A)."""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = "configs/synthetic/schedule_preds_flagship_tuned_60ep.yaml"
# chip_smoke.py's CLI_FLAGS: the stages of epochs 0-3 as its cli phase runs them
STAGE_FLAGS = ["--epochs", "4", "--lod-annel-epochs", "1", "--lr-step-size", "1",
               "--seed-prune-epoch", "1", "--prune-every", "-1", "--prune-at-epoch", "1",
               "--voxel-raymarch-epoch-start", "1", "--sem-epoch-start", "2",
               "--inst-epoch-start", "2", "--val-extrinsics-start", "3",
               "--val-extrinsics-every", "3", "--valid-every", "4", "--save-every", "2"]


def _median_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    for _ in range(warm):
        fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(tree: str, steps: int, config_path: str = CONFIG, device: str = "cuda") -> dict:
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)                  # this file's folder is not a package root
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    config = importlib.import_module("pagnerf_tpu_torch.config.config")
    factory = importlib.import_module("pagnerf_tpu_torch.config.factory")
    entry = importlib.import_module("pagnerf_tpu_torch.entry")
    assert os.path.dirname(os.path.dirname(os.path.abspath(entry.__file__))) == \
        os.path.abspath(tree), entry.__file__

    args = config.parse_options(["--config", os.path.join(tree, config_path)] + STAGE_FLAGS)
    trainer = factory.get_modules_from_config(args, torch.device(device))[2]
    out = {}
    for epoch in range(4):
        if epoch == 1:
            trainer.prune(seed=True)
            trainer.prune()
            entry.apply_scene_fixture(trainer)
        stage = trainer.stage_for_epoch(epoch)
        split = "val" if stage.training_val_poses else "train"
        batch = trainer.dataset.sample_batch(np.random.default_rng(epoch), trainer.cfg.batch_size,
                                             trainer.cfg.num_rays_sampled_per_img, split)

        def step():
            losses = trainer.train_step(stage, batch)
            return {k: float(v) for k, v in losses.items()}

        step_ms = _median_ms(step, steps)
        sub = {k: v[:trainer.cfg.micro_batch_imgs] for k, v in batch.items()}
        grads, _ = trainer.grad_step(stage, sub)
        frozen = trainer.frozen_fn(stage)
        update_ms = _median_ms(lambda: trainer.opt.update(
            grads, frozen, trainer.opt_cfg.clip_grad_norm), 10)
        out[f"{epoch} {stage.label}"] = {"step_ms": step_ms, "update_ms": update_ms,
                      "microbatches": trainer.cfg.batch_size // trainer.cfg.micro_batch_imgs,
                      "rays_per_image": trainer.cfg.num_rays_sampled_per_img}
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(HERE))
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--config", default=CONFIG)
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args()
    card = "cpu" if opts.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=20, check=True).stdout.strip()
    t0 = time.perf_counter()
    stages = profile(os.path.abspath(opts.tree), opts.steps, opts.config, opts.device)
    print(json.dumps({"card": card, "tree": os.path.abspath(opts.tree), "steps": opts.steps,
                      "stages": stages, "wall_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
