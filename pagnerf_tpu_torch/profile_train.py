"""Where the flagship training step's time goes, on the CUDA card.

    python -m pagnerf_tpu_torch.profile_train [rgb|panoptic]

Prints one JSON object for one stage (default: both, one object each): the
wall time of a whole step and of one microbatch's forward + backward (host
clock around synchronised calls, median of 3 after a warm-up), the device
time of each part of a microbatch run on its own at the flagship training
shapes (CUDA events, median of 5: ray transform + march, lattice forward,
table gather, decoders forward + backward, table-gradient scatter, dbary,
lattice backward, optimizer update), the host time of the assignment solve,
and the top device kernels of one profiled microbatch with their summed
device time (``torch.profiler``; "not measured" if it reports none).
The microbatch is one non-anchor camera: 4096 rays x 512 steps.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .core.rays import Rays
from .entry import train_flagship
from .ops import permuto_encoding, table_gather
from .ops.assignment import lap_assign
from .ops.raymarch import raymarch


def _event_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _wall_ms(fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def profile_stage(stage_name: str, card: str, device="cuda") -> dict:
    trainer, _ = train_flagship(stage_name, steps=0, device=device)
    pipe, nef, cfg = trainer.pipeline, trainer.pipeline.nef, trainer.cfg
    stage = trainer.stage_for_epoch(2 if stage_name == "panoptic" else 0)
    batch = trainer.dataset.sample_batch(np.random.default_rng(0), cfg.batch_size,
                                         cfg.num_rays_sampled_per_img)
    anchor = pipe.anchor_mask.cpu().numpy()
    m = int(np.nonzero(~anchor[batch["cam_idx"]])[0][0])
    b = batch["imgs"].shape[0]
    sub = {k: v[m:m + 1] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == b else v
           for k, v in batch.items()}
    r, s = cfg.num_rays_sampled_per_img, stage.num_steps
    jitter = torch.rand((r, s), device=device,
                        generator=torch.Generator(device=device).manual_seed(0))

    a0 = lap_assign.seconds
    micro_ms = _wall_ms(lambda: trainer.grad_step(stage, sub, jitter))
    assign_ms = (lap_assign.seconds - a0) / 4 * 1e3
    grads, _ = trainer.grad_step(stage, sub, jitter)
    opt_ms = _wall_ms(lambda: trainer.opt.update(grads, trainer.frozen_fn(stage)))
    step_ms = _wall_ms(lambda: trainer.train_step(stage, batch), reps=2)

    dual = "semantics" in stage.channels
    spec = nef.grid.spec
    cam = torch.as_tensor(sub["cam_idx"], device=device).long()
    base = Rays(origins=torch.as_tensor(sub["base_rays_origins"], device=device),
                dirs=torch.as_tensor(sub["base_rays_dirs"], device=device),
                dist_min=0.0, dist_max=6.0)
    with torch.no_grad():
        march = lambda: raymarch(pipe.transform_rays(base, cam), trainer.occ, s,
                                 jitter=jitter)
        rm = march()
        x = rm.positionsT.reshape(3, r * s).contiguous()
        ray_dT = pipe.transform_rays(base, cam).dirs.T[:, :, None] \
            .expand(3, r, s).reshape(3, r * s)
        lattice = lambda: permuto_encoding.lattice(nef.grid.tables, x, spec.scales)
        idx, bary = lattice()
        ta, tb = nef.grid.tables.detach(), nef.delta_grid.tables.detach()
        if dual:
            gather = lambda: table_gather.dual_multilevel_table_gather(ta, tb, idx, bary)
        else:
            gather = lambda: table_gather.multilevel_table_gather(ta, idx, bary)
        out = gather()
        fa = (out[0] if dual else out).reshape(-1, r * s)

    feats = fa.clone().requires_grad_()

    def decoders():
        feats.grad = None
        density_feats, density = nef._density(feats)
        outs = [density, nef._rgb(density_feats, ray_dT)]
        if dual:
            panop = feats.detach() + fa
            outs += [nef._semantics(panop), nef._inst(panop)]
        sum(o.float().sum() for o in outs).backward()
        return feats.grad
    g = decoders().reshape(spec.num_levels, spec.feature_dim, r * s).contiguous()
    c = spec.capacity
    plan = permuto_encoding.scatter_plan(spec.scales, c, spec.feature_dim)
    if dual:
        scatter = lambda: table_gather.dual_multilevel_table_grad(idx, bary, g, g, c, *plan)
    else:
        scatter = lambda: table_gather.multilevel_table_grad(idx, bary, g, c, *plan)
    dbary_fn = lambda: table_gather.multilevel_gather_dbary(ta, idx, g)
    dbary = dbary_fn()
    inv_s = (1.0 / np.asarray(spec.scales)).astype(np.float32)
    lattice_bwd = lambda: permuto_encoding._lattice_levels_dx(x, inv_s, dbary)
    stages = {"march": _event_ms(march), "lattice_fwd": _event_ms(lattice),
              "gather": _event_ms(gather), "decoders_fwd_bwd": _event_ms(decoders),
              "scatter": _event_ms(scatter), "dbary": _event_ms(dbary_fn),
              "lattice_bwd": _event_ms(lattice_bwd), "optimizer_wall": opt_ms,
              "assignment_host": assign_ms}

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.grad_step(stage, sub, jitter)
        torch.cuda.synchronize()
    profiled_wall = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key[:160], e.count))
    rows.sort(reverse=True)
    device_ms = sum(row[0] for row in rows)
    result = {
        "card": card, "stage": stage_name, "channels": sorted(stage.channels),
        "rays_per_microbatch": r, "steps": s, "samples": r * s,
        "microbatches_per_step": b, "step_wall_ms": step_ms,
        "rays_per_s": b * r / (step_ms / 1e3),
        "microbatch_wall_ms": micro_ms, "part_ms": stages,
        "part_sum_ms": sum(stages.values()),
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profiled_microbatch_wall_ms": profiled_wall,
        "profiled_kernel_ms": device_ms if rows else "not measured",
        "top_device_ops": [{"ms": ms, "op": key, "count": n}
                           for ms, key, n in rows[:15]],
    }
    del trainer
    torch.cuda.empty_cache()
    return result


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=20, check=True).stdout.strip()
    for stage_name in (sys.argv[1:] or ["rgb", "panoptic"]):
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(profile_stage(stage_name, card)), flush=True)


if __name__ == "__main__":
    main()
