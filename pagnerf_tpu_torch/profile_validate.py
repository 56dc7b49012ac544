"""Where the flagship's validation time goes, on the CUDA card.

    python -m pagnerf_tpu_torch.profile_validate

Builds the state ``entry.validate_flagship`` validates (the default
schedule's trainer; the pre-prune validation at its first validation epoch;
then ``run_past_prune`` and the synthetic predictions for the final one) and
prints one JSON object per validation ('pre_prune', 'final') and one for the
point-cloud map ('map'):

- ``first_call_ms``: the wall of the first ``validate()`` (or map) of the
  process at that state, warm-up included;
- ``validate_ms``: the wall of a whole ``validate()`` without media (host
  clock, median of 5 after a warm-up), and ``validate_media_ms`` with its
  PNG frames written (median of 3); ``render_time_per_img_ms``, the metric
  of those runs (median);
- ``parts_ms``: one image's render in parts, each a synchronised call on its
  own (host clock, median of 5): the ray transform, the count-only march
  (packed stages), the trace (march, packing, encode, decoders,
  compositing), the host read of the channels; and the host work of the
  whole validation, its wall less its renders (metrics, clean-up);
- ``profiled``: one whole ``validate()`` under ``torch.profiler``: the
  summed device time of its kernels, its wall, the device's idle share
  (1 - device / wall) and the top kernels ("not measured" if the profiler
  reports no device time).

The card's name and power limit come first, from ``nvidia-smi``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import time

import torch

from .data.synthetic import add_synthetic_predictions
from .entry import run_past_prune, schedule_trainer
from .ops.permuto_encoding import _encode_kernel
from .ops.raymarch import raymarch
from .train.validation import _rays_from, _read, validate
from .utils.render_map import generate_pc_map_from_views

MEDIA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build",
                         "profile_validate")


def _first_ms(fn) -> float:
    """Host-clock ms of one synchronised ``fn()``."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def _wall_ms(fn, reps: int = 5):
    """Median host-clock ms of ``fn()`` synchronised, after one warm-up, and
    the last result."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), out


def _profiled(fn):
    """Summed device ms of ``fn()``'s kernels, its wall ms and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key[:120], e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {"device_ms": device_ms if rows else "not measured", "wall_ms": wall,
            "idle_share": 1.0 - device_ms / wall if rows else "not measured",
            "kernel_launches": sum(r[2] for r in rows),
            "top_kernels": [{"ms": ms, "kernel": k, "count": n} for ms, k, n in rows[:10]]}


@torch.no_grad()
def _image_parts(trainer, epoch: int):
    """One image's render in parts (the first image of the split), at the
    chunk budget ``batch_render`` picks for it."""
    cfg = trainer.cfg
    mip = 0 if epoch >= cfg.epochs and not cfg.low_res_val else cfg.val_mip
    data = trainer.dataset.get_images("val", mip)
    pipe, occ = trainer.pipeline, trainer.occ
    rays = _rays_from(data, 0, cfg.optimize_val_extrinsics, trainer.device)
    cam = int(data["cam_idx"][0])
    channels = {"rgb", "depth"} | (
        {"semantics", "inst_embedding"} if epoch >= cfg.sem_epoch_start else set())
    trainer.batch_render(rays, channels, cam_idx=cam)
    (chunk,) = trainer.last_render
    stage = trainer.stage_for_epoch(max(trainer.epoch - 1, 0))
    tcfg = dataclasses.replace(pipe.tracer_cfg, raymarch_type=stage.raymarch_type,
                               num_steps=stage.num_steps, compact_steps=stage.compact_steps,
                               pack_steps=chunk["pack_steps"])
    cam_t = torch.tensor([cam], device=trainer.device)
    parts = {}
    parts["transform"], world = _wall_ms(lambda: pipe.transform_rays(rays.reshape(1, -1),
                                                                     cam_t))
    if stage.pack_steps:
        parts["count_march"], _ = _wall_ms(lambda: int(raymarch(
            world, occ, tcfg.num_steps, tcfg.raymarch_type, None,
            tcfg.ray_max_travel).mask.sum()))
    parts["trace"], rb = _wall_ms(lambda: pipe(world, channels, occ, trainer.lod_w,
                                               stage="val", tracer_cfg=tcfg))
    parts["host_read"], _ = _wall_ms(lambda: _read(rb))
    return parts, {"rays": chunk["rays"], "pack_steps": chunk["pack_steps"],
                   "num_steps": tcfg.num_steps, "raymarch": tcfg.raymarch_type}


def _report(trainer, epoch: int, name: str, card: str) -> None:
    metrics = []

    def run(log_dir=None):
        m = validate(trainer, epoch, log_dir=log_dir)
        metrics.append(m)
        return m
    first = _first_ms(run)
    wall, _ = _wall_ms(run)
    media, _ = _wall_ms(lambda: run(MEDIA_DIR), reps=3)
    per_img = statistics.median(m["val/render_time_per_img"] for m in metrics[1:]) * 1e3
    parts, shape = _image_parts(trainer, epoch)
    imgs = len(trainer.dataset.val_idxs)
    parts["host_metrics"] = wall - imgs * per_img
    print(json.dumps({"card": card, "validation": name, "epoch": epoch, "images": imgs,
                      **shape, "first_call_ms": first, "validate_ms": wall, "validate_media_ms": media,
                      "render_time_per_img_ms": per_img, "parts_ms": parts,
                      "profiled": _profiled(run)}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_validate: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=20, check=True).stdout.strip()
    _encode_kernel()                    # built before the first call is timed
    trainer = schedule_trainer("cuda")
    cfg = trainer.cfg
    epoch = next(e for e in range(cfg.epochs) if (e + 1) % cfg.valid_every == 0)
    trainer.epoch = epoch + 1
    _report(trainer, epoch, "pre_prune", card)
    run_past_prune(trainer)
    trainer.dataset.data = add_synthetic_predictions(trainer.dataset.data, seed=cfg.seed)
    trainer.epoch = cfg.epochs
    _report(trainer, cfg.epochs, "final", card)
    ds = trainer.dataset
    first = _first_ms(lambda: generate_pc_map_from_views(trainer, mip=2))
    wall, pts = _wall_ms(lambda: generate_pc_map_from_views(trainer, mip=2), reps=3)
    print(json.dumps({"card": card, "validation": "map",
                      "views": len(set(ds.train_idxs.tolist()) | set(ds.val_idxs.tolist())),
                      "first_call_ms": first, "map_ms": wall, "points": len(pts["points"]),
                      "profiled": _profiled(lambda: generate_pc_map_from_views(trainer, mip=2))}),
          flush=True)


if __name__ == "__main__":
    main()
