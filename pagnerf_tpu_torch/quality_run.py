"""Repeat the repository's recorded quality run at flagship capacity on the
port, through ``cli.main``, and print it beside the record.

    python -m pagnerf_tpu_torch.quality_run [--seed 0] [--device cuda] [--out DIR]
        [--log-root DIR] [--epochs 60] [--flags "..."] [--matmul-precision highest]
        [--name NAME]

The record is ``docs/convergence_flagship_tuned/`` (``README.md`` and
``metrics.csv``): ``configs/synthetic/schedule_preds_flagship_tuned_60ep.yaml``
trained for 60 epochs, then resumed from its epoch-59 checkpoint with
``--epochs 90 --valid-every 10`` and stopped after the epoch-69 validation.
This script runs the same two segments: the config for 60 epochs, then a
resume from its ``model.ckpt`` with ``--epochs 70 --valid-every 10``.
Epochs 60-69 see the same stages, learning rates and val-pose epochs as the
record's 90-epoch resume (its ``epochs`` moves only ends that lie past 69),
and the epoch-69 validation sees the state the record's last validation saw.

``--seed`` is the trainer's seed (``TrainerConfig.seed``: the parameters'
init, the ray sampling and the jitter); the scene and its predictions keep
seed 0. Both calls run with ``--perf``: the trainer's timer writes each
step, prune, epoch and validation to the run's ``perf.jsonl``, which this
script reads. It prints one JSON line per validation (the port's metrics
beside the record's row of the same epoch), the timings (step wall per
stage, epoch wall, each validation's wall and ``val/render_time_per_img``,
each prune's wall, kept share and the packed B that followed, and the
share of training rays the packed budget truncated), and last the
epoch-69 metrics against the band: pooled PSNR within 1.0 dB of the
record, IoU within 0.03, PQ-things within 0.05, mAP within 0.05. Everything
also goes to ``<out>/quality_<name>.json``. The runs' log directories
(checkpoints of ~0.3 GB each, media) go under ``<log-root>``.

For a diagnosis, ``--epochs N`` (N < 60) runs the first N epochs alone (no
resume, no band), ``--flags`` appends command-line flags to both calls
(e.g. ``"--packed-compaction false"``: the compacted layout after the
prune in place of the packed one), ``--no-cut`` trains on the whole dense
march after the prunes (``--packed-compaction false`` and
``TrainerConfig.compact_steps_after_prune=0``, which no flag sets), and
``--matmul-precision`` sets ``torch.set_float32_matmul_precision``.

After the runs, ``pose_drift`` reads the learned extrinsics of each run's
final checkpoint and prints how far every train and val camera moved from
its initial pose (rotation in degrees, camera centre in scene units): the
scene's poses are exact (the config adds no pose noise), so any offset is
drift.
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import shlex
import statistics
import time
from typing import Sequence
from unittest import mock

import torch

from . import cli
from .models import tracer
from .ops import packed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "synthetic", "schedule_preds_flagship_tuned_60ep.yaml")
RECORD = os.path.join(ROOT, "docs", "convergence_flagship_tuned", "metrics.csv")
# the band the epoch-69 metrics are held to: metric -> allowed |port - record|
BAND = {"val/psnr": 1.0, "val/iou": 0.03, "val/pq_things": 0.05, "val/map": 0.05}


def read_record(path: str = RECORD):
    """epoch -> {metric: value} of the record's ``metrics.csv``."""
    with open(path) as f:
        return {int(row["epoch"]): {k: float(v) for k, v in row.items()
                                    if k != "epoch" and v != ""}
                for row in csv.DictReader(f)}


def read_perf(log_root: str, exp_name: str):
    """The run directory of ``cli.main`` under ``log_root/exp_name`` (one
    per call here) and the records of its ``perf.jsonl`` (``--perf``)."""
    (run_dir,) = glob.glob(os.path.join(log_root, exp_name, "*", ""))
    with open(os.path.join(run_dir, "perf.jsonl")) as f:
        return run_dir, [json.loads(line) for line in f]


def packing(totals: dict):
    """Patches of the tracer's ``pack_samples`` and ``compact_samples`` that
    sum into ``totals``, for training (gradients on) and for renders, the
    rays cut to a budget, their valid samples, the samples kept and the rays
    the budget truncated (the packed layout's water-fill cap, or the
    compacted layout's ``keep_steps``, below their valid count), on the
    device until ``summary`` reads them. Keys: "train", "render" (packed),
    "train_compact", "render_compact"."""
    pack, compact = tracer.pack_samples, tracer.compact_samples

    def add(layout, counts, cap, budget):
        key = ("train" if torch.is_grad_enabled() else "render") + layout
        acc = totals.setdefault(key, {"calls": 0, "rays": 0, "budget": 0, "valid": 0,
                                      "kept": 0, "truncated_rays": 0})
        acc["calls"] += 1
        acc["rays"] += counts.numel()
        acc["budget"] += budget
        acc["valid"] = acc["valid"] + counts.sum()
        acc["kept"] = acc["kept"] + torch.minimum(counts, cap).sum()
        acc["truncated_rays"] = acc["truncated_rays"] + (counts > cap).sum()

    def pack_spy(rm, rays_oT, rays_dT, budget, group=None, cap=None):
        counts = torch.sum(rm.mask, dim=-1, dtype=torch.int32)
        add("", counts, packed._water_fill_cap(counts, rm.mask.shape[1], budget)
            if cap is None else cap.to(counts.dtype), budget)
        return pack(rm, rays_oT, rays_dT, budget, group=group, cap=cap)

    def compact_spy(rm, keep_steps):
        steps = rm.mask.shape[-1]
        if 0 < keep_steps < steps:
            counts = torch.sum(rm.mask, dim=-1, dtype=torch.int32)
            add("_compact", counts, torch.full_like(counts, keep_steps),
                keep_steps * counts.numel())
        return compact(rm, keep_steps)
    return mock.patch.multiple(tracer, pack_samples=pack_spy, compact_samples=compact_spy)


def summary(records, pack_totals=None) -> dict:
    """From the timer's records (``read_perf``): the median step wall per
    stage (the first step of a stage apart: it pays for its allocations),
    the epoch walls, the prunes with the packed B of the step after each,
    the validations, and the packing totals of ``packing``."""
    steps = [r for r in records if r["name"] == "train_step"]
    by_stage = {}
    for i, s in enumerate(steps):
        first = i == 0 or steps[i - 1]["stage"] != s["stage"]
        by_stage.setdefault(s["stage"], {"first_ms": [], "ms": [], "B": set()})
        by_stage[s["stage"]]["first_ms" if first else "ms"].append(s["ms"])
        if s["pack_steps"]:
            by_stage[s["stage"]]["B"].add(s["pack_steps"] * s["rays"])
    stages = {k: {"steps": len(v["ms"]) + len(v["first_ms"]),
                  "median_ms": statistics.median(v["ms"]) if v["ms"] else None,
                  "first_ms_max": max(v["first_ms"]),
                  "B": sorted(v["B"])} for k, v in by_stage.items()}
    prunes = []
    for p in (r for r in records if r["name"] == "prune"):
        nxt = [s for s in steps if s["epoch"] > p["epoch"]
               or (p["seed"] and s["epoch"] == p["epoch"])]
        prunes.append({k: p[k] for k in ("epoch", "seed", "refresh", "ms", "kept_share")}
                      | {"next_B": nxt[0]["pack_steps"] * nxt[0]["rays"] if nxt else None})
    walls = [r["ms"] / 1e3 for r in records if r["name"] == "epoch"]
    packing_ = {}
    for k, acc in (pack_totals or {}).items():
        acc = {n: int(v) for n, v in acc.items()}
        packing_[k] = {**acc, "truncated_ray_share": acc["truncated_rays"] / max(acc["rays"], 1),
                       "kept_sample_share": acc["kept"] / max(acc["valid"], 1),
                       "valid_per_ray": acc["valid"] / max(acc["rays"], 1),
                       "budget_per_ray": acc["budget"] / max(acc["rays"], 1)}
    return {"stages": stages, "prunes": prunes, "packing": packing_,
            "epoch_s": {"median": statistics.median(walls), "min": min(walls),
                        "max": max(walls), "sum": sum(walls)},
            "validations": [{"epoch": r["epoch"], "s": r["ms"] / 1e3,
                             "render_time_per_img_s": r["metrics"]["val/render_time_per_img"]}
                            for r in records if r["name"] == "validate"]}


def pose_drift(ckpt_path: str, config_argv: Sequence[str]) -> dict:
    """How far the learned extrinsics of a checkpoint lie from the initial
    poses of the config's dataset: per camera the rotation angle between
    the learned and the initial world->camera rotation (degrees) and the
    distance between the camera centres (scene units), summarised over the
    train and the val cameras (mean, median, max, and the camera of the
    max)."""
    from .config.config import parse_options
    from .config.factory import load_dataset
    from .core.camera import r6_to_rotmat

    state = torch.load(ckpt_path, weights_only=True, map_location="cpu")
    learned = state["params"]["extrinsics"].double()
    ds = load_dataset(parse_options(list(config_argv)))
    init = torch.from_numpy(ds.data["view_matrices"]).double()
    rot_l = r6_to_rotmat(learned[:, :6])
    rot_i = init[:, :3, :3]
    cos = ((torch.einsum("nij,nij->n", rot_l, rot_i) - 1.0) / 2.0).clamp(-1.0, 1.0)
    angle = torch.rad2deg(torch.arccos(cos))
    centre_l = -torch.einsum("nji,nj->ni", rot_l, learned[:, 6:9])
    centre_i = -torch.einsum("nji,nj->ni", rot_i, init[:, :3, 3])
    shift = torch.linalg.norm(centre_l - centre_i, dim=-1)

    def stats(idx):
        idx = torch.as_tensor(idx, dtype=torch.long)
        out = {"cameras": len(idx)}
        for name, v in (("rotation_deg", angle[idx]), ("centre_shift", shift[idx])):
            out[name] = {"mean": v.mean().item(), "median": v.median().item(),
                         "max": v.max().item(), "max_camera": int(idx[v.argmax()])}
        return out

    return {"checkpoint": os.path.relpath(ckpt_path, ROOT), "epoch": state["epoch"],
            "train": stats(ds.train_idxs), "val": stats(ds.val_idxs),
            "camera0": {"rotation_deg": angle[0].item(), "centre_shift": shift[0].item()}}


def run(seed: int = 0, device: str = "cuda", out: str = "", log_root: str = "",
        epochs: int = 60, flags: Sequence[str] = (), name: str = "",
        no_cut: bool = False) -> dict:
    """The protocol (``epochs`` = 60: 60 epochs, then the resume to 70), or
    its first ``epochs`` < 60 epochs alone; ``flags`` are appended to both
    ``cli.main`` calls; ``no_cut`` trains on the whole dense march after
    the prunes (neither the packed nor the compacted layout: no ray loses a
    sample). Writes ``<out>/quality_<name>.json``."""
    name = name or f"seed{seed}"
    base = os.path.join(log_root or out, f"runs_{name}")
    pack_totals = {}
    t0 = time.perf_counter()
    common = ["--config", CONFIG, "--device", device, "--log-dir", base, "--perf",
              *flags, *(["--packed-compaction", "false"] if no_cut else [])]
    fields = dict(seed=seed, **({"compact_steps_after_prune": 0} if no_cut else {}))
    with packing(pack_totals):
        cli.main(common + ["--exp-name", "first", "--epochs", str(epochs)], **fields)
        run_dir, records = read_perf(base, "first")
        if epochs == 60:
            cli.main(common + ["--exp-name", "resume", "--pretrained",
                               os.path.join(run_dir, "model.ckpt"),
                               "--epochs", "70", "--valid-every", "10"], **fields)
            records += read_perf(base, "resume")[1]
    wall = time.perf_counter() - t0
    config_argv = cli.split_device(common)[1]
    record = read_record()
    vals = []
    for r in (r for r in records if r["name"] == "validate"):
        want = record.get(r["epoch"], {})
        row = {"epoch": r["epoch"], "port": r["metrics"],
               "record": {k: want[k] for k in r["metrics"] if k in want}}
        vals.append(row)
        print(json.dumps({"validation": row}), flush=True)
    # the epoch-69 validation (on_epoch_end); the final one repeats its state
    last = [v["port"] for v in vals if v["epoch"] == 69]
    band = ({k: {"port": last[0][k], "record": record[69][k],
                 "diff": last[0][k] - record[69][k], "allowed": tol,
                 "within": abs(last[0][k] - record[69][k]) <= tol}
             for k, tol in BAND.items()} if last else {})
    result = {"seed": seed, "device": device, "flags": list(flags), "no_cut": no_cut,
              "matmul_precision": torch.get_float32_matmul_precision(),
              "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "wall_s": wall,
              "card": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
              "timings": summary(records, pack_totals),
              "epochs": [{"epoch": r["epoch"], "s": r["ms"] / 1e3, "losses": r["losses"]}
                         for r in records if r["name"] == "epoch"],
              "validations": vals, "band": band,
              "within_band": bool(band) and all(b["within"] for b in band.values()),
              "pose_drift": [pose_drift(os.path.join(d, "model.ckpt"), config_argv)
                             for d in sorted(glob.glob(os.path.join(base, "*", "*", "")))]}
    print(json.dumps({"timings": result["timings"], "wall_s": wall}), flush=True)
    print(json.dumps({"pose_drift": result["pose_drift"]}), flush=True)
    print(json.dumps({"band": band, "within_band": result["within_band"]}), flush=True)
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"quality_{name}.json"), "w") as f:
            json.dump(result, f, indent=1, default=float)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    build = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", "quality")
    ap.add_argument("--out", default=build)
    ap.add_argument("--log-root", default=build)
    ap.add_argument("--epochs", type=int, default=60,
                    help="60: the whole protocol; fewer: that many epochs, no resume")
    ap.add_argument("--flags", default="",
                    help="command-line flags appended to both cli.main calls")
    ap.add_argument("--matmul-precision", default="highest",
                    choices=("highest", "high", "medium"),
                    help="torch.set_float32_matmul_precision for the run")
    ap.add_argument("--name", default="", help="the run's name (default seed<seed>)")
    ap.add_argument("--no-cut", action="store_true",
                    help="the whole dense march after the prunes: no ray loses a sample")
    a = ap.parse_args()
    torch.set_float32_matmul_precision(a.matmul_precision)
    run(a.seed, a.device, a.out, a.log_root, a.epochs, shlex.split(a.flags), a.name,
        a.no_cut)


if __name__ == "__main__":
    main()
