"""Hyper-parameter sweep with successive halving (counterpart of
``main_hp_tunning.py``): ASHA's synchronous variant.

Every point of the grid ``space`` trains in rungs of ``--rung-epochs``
epochs; after each rung the trials are ranked by ``--metric`` and the best
``1 / reduction_factor`` go on. A rung's epoch target is cumulative: a
trial resumes from its previous rung's checkpoint and trains on to
``rung_epochs * (rung + 1)``. A trial that raises scores worst and is kept
in the results with ``metric: None``. ``sweep_results.json`` in the output
directory is rewritten after every rung.

``--num-workers N`` > 1 trains N trials at once, each in a worker process
(``python -m pagnerf_tpu_torch.main_hp_tunning --run-trial <spec>``); the
spec and the result travel as JSON files, and worker slot ``s`` trains on
``cuda:{s % torch.cuda.device_count()}`` (on one card every worker shares
it), or on the CPU with ``--worker-platform cpu``. A worker whose device is
``cuda`` and finds no card fails its trial (``device.resolve_device``); it
never trains on the CPU. With 1 worker the trials train in this process on
``--device``.

    python -m pagnerf_tpu_torch.main_hp_tunning --config <yaml> \\
        [--space '{"lr": [0.001, 0.005]}'] [--rung-epochs 2] [--num-rungs 3] \\
        [--num-workers 2] [--worker-platform cpu|cuda] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import resource
import sys
import time
from typing import Dict, List, Optional

from . import cli
from .config.config import parse_options
from .config.factory import get_modules_from_config
from .device import resolve_device
from .train import checkpoint
from .train.validation import validate

log = logging.getLogger(__name__)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's default search space
DEFAULT_SPACE = {
    "lr": [1e-3, 5e-3],
    "grid_lr_weight": [10.0, 100.0],
    "sem_weight": [0.1, 1.0],
    "inst_weight": [100.0, 1000.0],
    "hidden_dim": [32, 64],
}


def grid_points(space: Dict[str, List]) -> List[Dict]:
    keys = sorted(space.keys())
    return [dict(zip(keys, vals)) for vals in itertools.product(*(space[k] for k in keys))]


def run_trial(base_args: List[str], overrides: Dict, epochs: int, out_dir: str,
              trial_id: str, resume_from=None, info: Optional[Dict] = None) -> Dict:
    """Train one trial to ``epochs`` epochs in this process on the
    ``--device`` of ``base_args`` (resuming from ``resume_from`` in the
    ``full`` format), validate it, save ``<out_dir>/<trial_id>.ckpt``;
    returns the metrics with the checkpoint's path under ``_ckpt``. ``info``
    receives the epoch resumed from and the epoch reached."""
    argv = list(base_args)
    for k, v in overrides.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    argv += ["--epochs", str(epochs)]
    device, rest = cli.split_device(argv)
    _, _, trainer = get_modules_from_config(parse_options(rest), resolve_device(device))
    if resume_from and os.path.exists(resume_from):
        checkpoint.load_checkpoint(resume_from, trainer, "full")
    if info is not None:
        info["resumed_epoch"] = trainer.epoch
    trainer.train()
    if info is not None:
        info["epoch"] = trainer.epoch
    metrics = validate(trainer, trainer.epoch)
    ckpt = os.path.join(out_dir, f"{trial_id}.ckpt")
    checkpoint.save_checkpoint(ckpt, trainer)
    metrics["_ckpt"] = ckpt
    return metrics


def run_trial_subprocess(base_args: List[str], overrides: Dict, epochs: int,
                         out_dir: str, trial_id: str, resume_from, slot: int,
                         platform: Optional[str]) -> Dict:
    """Train one trial in a fresh worker process (``--run-trial``); its
    device, start and end (``time.time()``), wall, peak memory, kernel
    launches and epochs go to ``<trial_id>_epoch<epochs>.worker.json``.
    ``platform`` (``cpu`` or ``cuda``) replaces the ``--device`` of
    ``base_args``."""
    import subprocess
    # absolute paths: the worker runs from the repository's root
    out_dir = os.path.abspath(out_dir)
    if resume_from:
        resume_from = os.path.abspath(resume_from)
    spec_path = os.path.join(out_dir, f"{trial_id}.spec.json")
    result_path = os.path.join(out_dir, f"{trial_id}.result.json")
    with open(spec_path, "w") as f:
        json.dump({"base_args": base_args, "overrides": overrides,
                   "epochs": epochs, "out_dir": out_dir, "trial_id": trial_id,
                   "resume_from": resume_from, "result_path": result_path,
                   "slot": slot, "platform": platform}, f)
    if os.path.exists(result_path):
        os.remove(result_path)
    proc = subprocess.run([sys.executable, "-m", "pagnerf_tpu_torch.main_hp_tunning",
                           "--run-trial", spec_path], capture_output=True, text=True,
                          cwd=REPO)
    if proc.returncode != 0 or not os.path.exists(result_path):
        raise RuntimeError(f"{trial_id} worker failed "
                           f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}")
    with open(result_path) as f:
        return json.load(f)


def worker_device(spec: Dict) -> str:
    """The worker's device: the spec's platform or ``--device``, and on
    CUDA the slot's card."""
    device = spec.get("platform") or cli.split_device(spec["base_args"])[0]
    if device.startswith("cuda"):
        import torch
        resolve_device("cuda")
        device = f"cuda:{spec['slot'] % torch.cuda.device_count()}"
    return device


def _run_trial_worker(spec_path: str) -> None:
    """``--run-trial`` entry: executed inside the worker process."""
    import torch

    from .ops import table_gather
    start, t0 = time.time(), time.perf_counter()
    with open(spec_path) as f:
        spec = json.load(f)
    device = worker_device(spec)
    stats = {"device": device, "start": start}
    metrics = run_trial(spec["base_args"] + ["--device", device], spec["overrides"],
                        spec["epochs"], spec["out_dir"], spec["trial_id"],
                        resume_from=spec["resume_from"], info=stats)
    with open(spec["result_path"], "w") as f:
        json.dump({k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float))
                       else v) for k, v in metrics.items()}, f)
    stats.update(end=time.time(), wall_s=time.perf_counter() - t0,
                 max_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
                 launches={k: fn.launches for k, fn in table_gather.KERNELS.items()})
    if device.startswith("cuda"):
        stats["peak_allocated_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    name = f"{spec['trial_id']}_epoch{spec['epochs']}.worker.json"
    with open(os.path.join(spec["out_dir"], name), "w") as f:
        json.dump(stats, f)


def asha_sweep(base_args: List[str], space: Dict[str, List], out_dir: str,
               metric: str = "val/psnr", mode: str = "max",
               rung_epochs: int = 2, num_rungs: int = 3,
               reduction_factor: int = 2, num_workers: int = 1,
               worker_platform: Optional[str] = None) -> List[Dict]:
    os.makedirs(out_dir, exist_ok=True)
    trials = [{"id": f"trial_{i:03d}", "config": cfg, "ckpt": None}
              for i, cfg in enumerate(grid_points(space))]
    results = []
    for rung in range(num_rungs):
        log.info("rung %d: %d trials x %d epochs", rung, len(trials), rung_epochs)
        scored = []
        # cumulative: a restored checkpoint carries its epoch, and
        # trainer.train() runs from there to the config's epochs
        cum_epochs = rung_epochs * (rung + 1)

        def score_one(t):
            # a trial that raises is kept as failed; the sweep goes on
            t0 = time.time()
            try:
                if num_workers > 1:
                    slot = slots.get()
                    try:
                        m = run_trial_subprocess(base_args, t["config"], cum_epochs,
                                                 out_dir, t["id"], t["ckpt"], slot,
                                                 worker_platform)
                    finally:
                        slots.put(slot)
                else:
                    m = run_trial(base_args, t["config"], cum_epochs, out_dir,
                                  t["id"], resume_from=t["ckpt"])
            except Exception as e:
                log.warning("%s failed: %s", t["id"], e)
                return t, {"_failed": str(e)}, time.time() - t0
            t["ckpt"] = m.pop("_ckpt")
            return t, m, time.time() - t0

        if num_workers > 1:
            import queue
            from concurrent.futures import ThreadPoolExecutor
            slots = queue.Queue()
            for s in range(num_workers):
                slots.put(s)
            with ThreadPoolExecutor(max_workers=num_workers) as ex:
                done = list(ex.map(score_one, trials))
        else:
            done = [score_one(t) for t in trials]
        worst = float("-inf") if mode == "max" else float("inf")
        for t, m, wall in done:
            failed = "_failed" in m
            score = worst if failed else m.get(metric, 0.0)
            scored.append((score, t, m))
            # None for a failure: json.dump would write -Infinity
            results.append({"trial": t["id"], "rung": rung, "config": t["config"],
                            "metric": None if failed else score, "metrics": m,
                            "wall": wall})
            log.info("%s rung %d: %s=%.4f (%.1fs)", t["id"], rung, metric, score, wall)
        scored.sort(key=lambda x: x[0], reverse=(mode == "max"))
        keep = max(1, len(scored) // reduction_factor)
        trials = [t for _, t, _ in scored[:keep]]
        with open(os.path.join(out_dir, "sweep_results.json"), "w") as f:
            json.dump(results, f, indent=2)
    log.info("best trial: %s %s", trials[0]["id"], trials[0]["config"])
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--out-dir", default=os.path.join("pagnerf_tpu_torch", "_build",
                                                           "hp_sweep"))
    parser.add_argument("--metric", default="val/psnr")
    parser.add_argument("--mode", default="max", choices=["max", "min"])
    parser.add_argument("--rung-epochs", type=int, default=2)
    parser.add_argument("--num-rungs", type=int, default=3)
    parser.add_argument("--space", type=str, default=None,
                        help="JSON dict overriding the default search space")
    parser.add_argument("--num-workers", type=int, default=1,
                        help="concurrent trial processes (1 = in-process)")
    parser.add_argument("--worker-platform", type=str, default=None,
                        choices=["cpu", "cuda"],
                        help="the trial workers' device (default: --device)")
    parser.add_argument("--device", default="cuda",
                        help="the trials' device (cuda or cpu)")
    ns = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    space = json.loads(ns.space) if ns.space else DEFAULT_SPACE
    ns.config = os.path.abspath(ns.config)
    ns.out_dir = os.path.abspath(ns.out_dir)
    base = ["--config", ns.config, "--log-dir", ns.out_dir, "--valid-every", "-1",
            "--device", ns.device]
    return asha_sweep(base, space, ns.out_dir, ns.metric, ns.mode,
                      ns.rung_epochs, ns.num_rungs,
                      num_workers=ns.num_workers,
                      worker_platform=ns.worker_platform)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--run-trial":
        _run_trial_worker(sys.argv[2])
    else:
        main(sys.argv[1:])
