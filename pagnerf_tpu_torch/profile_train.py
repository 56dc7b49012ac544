"""Where the flagship training step's time goes, on the CUDA card.

    python -m pagnerf_tpu_torch.profile_train [rgb|panoptic|post_prune]
    python -m pagnerf_tpu_torch.profile_train tuned_rgb [tuned_post_prune --pretrained CKPT]
    python -m pagnerf_tpu_torch.profile_train --turns [stages ...]

Prints one JSON object for one stage (default: all three, one object each):
the wall time of a whole step and of one microbatch's forward + backward
(host clock around synchronised calls, median of 3 after a warm-up), the
device time of each part of a microbatch run on its own at the stage's
shapes (CUDA events, median of 5: ray transform + march (+ packing), lattice
+ gather (the fused encode, writing idx/bary for the backward), decoders
forward + backward, table-gradient scatter, the lattice backward (the
``encode_dx`` kernel: dbary and the lattice backward in one launch),
optimizer update, the assignment kernel on the microbatch's own costs,
where the stage has the instance loss; apart, ``replaced_part_ms``: the
composition ``encode_dx`` replaced, dbary's kernel and the plain-torch
``_lattice_levels_dx``), and the top
device kernels of one profiled microbatch with their summed device time
(``torch.profiler``; "not measured" if it reports none). The microbatch is
one non-anchor camera's 4096 rays: 512 dense steps in the pre-prune stages
('rgb', 'panoptic' at epoch 2); for 'post_prune', the first panoptic stage
past ``train_flagship_schedule``'s prune and scene fixture (epoch 601): the
voxel march's 256 steps packed into pack_steps x 4096 samples. The
'tuned_*' stages are ``configs/synthetic/schedule_preds_flagship_tuned_60ep.yaml``
built by the factory (``cli``'s trainer): 'tuned_rgb' its epoch-0 stage, one
image's 4096 rays x 96 dense steps (N = 393,216); 'tuned_post_prune' the
stage of the last epoch a checkpoint of that config ran (``--pretrained``,
e.g. the ``model.ckpt`` of a ``quality_run``: its trained prune's occupancy
and packed budget). ``--turns`` also times the microbatch and the step with
the coordinate gradient through the ``encode_dx`` kernel and through the
composition it replaced (dbary's kernel, then the plain-torch lattice
backward), in turns: kernel, replaced, replaced, kernel.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .config.config import parse_options
from .config.factory import get_modules_from_config
from .core.rays import Rays
from .entry import post_prune_epochs, train_flagship, train_flagship_schedule
from .ops import permuto_encoding, table_gather
from .losses import lin_assignment
from .ops.packed import pack_samples, segment_broadcast
from .ops.raymarch import raymarch
from .train.checkpoint import load_checkpoint

STAGES = ("rgb", "panoptic", "post_prune")
TUNED_STAGES = ("tuned_rgb", "tuned_post_prune")
TUNED_CONFIG = "configs/synthetic/schedule_preds_flagship_tuned_60ep.yaml"


def tuned_trainer(pretrained=None, device="cuda"):
    """The tuned config's trainer as ``cli`` builds it, with ``pretrained``
    restored."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = parse_options(["--config", os.path.join(root, TUNED_CONFIG)])
    trainer = get_modules_from_config(args, device)[2]
    if pretrained:
        load_checkpoint(pretrained, trainer)
    return trainer


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


def _dbary_then_lattice_dx(rows, idx, rank, g, inv_scales, dtype=None):
    """The coordinate gradient as the backward composed it before
    ``encode_dx``: dbary's kernel, rounded to the tables' dtype, then the
    plain-torch ``_lattice_levels_dx``."""
    dbary = table_gather.multilevel_gather_dbary(rows[..., :g.shape[1]].contiguous(), idx, g)
    like = g.new_empty((3, idx.shape[2]))
    return permuto_encoding._lattice_levels_dx(like, inv_scales,
                                               dbary.to(dtype or rows.dtype).float(), rank)


@contextlib.contextmanager
def replaced_dx(on: bool):
    """With ``on``, the encodes' backward forms dx as before ``encode_dx``
    (``_dbary_then_lattice_dx``): the control of ``--turns``."""
    if not on:
        yield
        return
    kernel = permuto_encoding.encode_dx
    permuto_encoding.encode_dx = _dbary_then_lattice_dx
    try:
        yield
    finally:
        permuto_encoding.encode_dx = kernel


def profile_stage(stage_name: str, card: str, device="cuda", pretrained=None,
                  with_turns: bool = False) -> dict:
    if stage_name == "tuned_rgb":
        trainer = tuned_trainer(device=device)
        stage = trainer.stage_for_epoch(0)
    elif stage_name == "tuned_post_prune":
        trainer = tuned_trainer(pretrained, device)
        stage = trainer.stage_for_epoch(trainer.epoch - 1)
    elif stage_name == "post_prune":
        trainer, _ = train_flagship_schedule(steps=0, val_pose_steps=0, device=device)
        stage = trainer.stage_for_epoch(post_prune_epochs(trainer, 1, 0)[0])
    else:
        trainer, _ = train_flagship(stage_name, steps=0, device=device)
        stage = trainer.stage_for_epoch(2 if stage_name == "panoptic" else 0)
    pipe, nef, cfg = trainer.pipeline, trainer.pipeline.nef, trainer.cfg
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

    assign = {}
    solve = lin_assignment.lap_assign

    def keep(cost, present):
        assign.setdefault("args", (cost.clone(), present.clone()))
        return solve(cost, present)
    lin_assignment.lap_assign = keep
    try:
        micro_ms = _wall_ms(lambda: trainer.grad_step(stage, sub, jitter))
    finally:
        lin_assignment.lap_assign = solve
    assign_ms = _event_ms(lambda: solve(*assign["args"])) if assign else None
    grads, _ = trainer.grad_step(stage, sub, jitter)
    opt_ms = _wall_ms(lambda: trainer.opt.update(grads, trainer.frozen_fn(stage)))
    step_ms = _wall_ms(lambda: trainer.train_step(stage, batch), reps=2)
    turns = None
    if with_turns:
        micro = lambda: trainer.grad_step(stage, sub, jitter)
        step = lambda: trainer.train_step(stage, batch)
        turns = {"order": ["kernel", "replaced", "replaced", "kernel"],
                 "microbatch_wall_ms": [], "step_wall_ms": []}
        for name in turns["order"]:
            with replaced_dx(name == "replaced"):
                turns["microbatch_wall_ms"].append(_wall_ms(micro))
                turns["step_wall_ms"].append(_wall_ms(step, reps=2))

    dual = "semantics" in stage.channels
    spec = nef.grid.spec
    cam = torch.as_tensor(sub["cam_idx"], device=device).long()
    base = Rays(origins=torch.as_tensor(sub["base_rays_origins"], device=device),
                dirs=torch.as_tensor(sub["base_rays_dirs"], device=device),
                dist_min=0.0, dist_max=6.0)
    travel = pipe.tracer_cfg.ray_max_travel
    with torch.no_grad():
        rays = pipe.transform_rays(base, cam)
        if stage.pack_steps:
            def march():
                rays = pipe.transform_rays(base, cam)
                rm = raymarch(rays, trainer.occ, s, stage.raymarch_type, jitter, travel)
                return pack_samples(rm, rays.origins.T, rays.dirs.T, stage.pack_steps * r)
            ps = march()
            x = ps.positionsT.contiguous()
            ray_dT = segment_broadcast(rays.dirs.T, ps.ray_id, ps.offsets)
            packed_used = int(ps.offsets[-1])
        else:
            march = lambda: raymarch(pipe.transform_rays(base, cam), trainer.occ, s,
                                     stage.raymarch_type, jitter, travel)
            x = march().positionsT.reshape(3, r * s).contiguous()
            ray_dT = rays.dirs.T[:, :, None].expand(3, r, s).reshape(3, r * s)
            packed_used = None
        n = x.shape[1]
        ta, tb = nef.grid.tables.detach(), nef.delta_grid.tables.detach()
        st = permuto_encoding.level_statics(spec.scales, spec.capacity, spec.feature_dim)
        tables = (ta, tb) if dual else (ta,)
        encode = lambda: permuto_encoding._launch_encode(x, tables, st, True, True)
        outs, idx, bary, rank = encode()
        fa = outs[0].reshape(-1, n)

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
    g = decoders().reshape(spec.num_levels, spec.feature_dim, n).contiguous()
    c = spec.capacity
    plan = (st.rows_used, st.modes)
    if dual:
        scatter = lambda: table_gather.dual_multilevel_table_grad(idx, bary, g, g, c, *plan)
    else:
        scatter = lambda: table_gather.multilevel_table_grad(idx, bary, g, c, *plan)
    # the coordinate gradient as the backward runs it (table A's rows, the
    # forward's idx and rank), and beside it the composition it replaced
    lattice_bwd = lambda: permuto_encoding.encode_dx(ta, idx, rank, g, st.inv_scales)
    dbary_fn = lambda: table_gather.multilevel_gather_dbary(ta, idx, g)
    dbary = dbary_fn()
    lattice_bwd_plain = lambda: permuto_encoding._lattice_levels_dx(x, st.inv_scales,
                                                                    dbary, rank)
    stages = {"march": _event_ms(march), "lattice_gather": _event_ms(encode),
              "decoders_fwd_bwd": _event_ms(decoders),
              "scatter": _event_ms(scatter), "lattice_bwd": _event_ms(lattice_bwd),
              "optimizer_wall": opt_ms, "assignment": assign_ms}
    replaced = {"dbary": _event_ms(dbary_fn), "lattice_bwd_plain": _event_ms(lattice_bwd_plain)}

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
        "rays_per_microbatch": r, "steps": s, "samples": n,
        "raymarch_type": stage.raymarch_type, "pack_steps": stage.pack_steps,
        "occupied_share": trainer._occ_frac if trainer._pruned else None,
        "packed_used": packed_used,
        "microbatches_per_step": b, "step_wall_ms": step_ms,
        "rays_per_s": b * r / (step_ms / 1e3),
        "microbatch_wall_ms": micro_ms, "part_ms": stages,
        "part_sum_ms": sum(v for v in stages.values() if v is not None),
        "replaced_part_ms": replaced,
        "turns_kernel_vs_replaced": turns,
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
    argv = sys.argv[1:]
    with_turns = "--turns" in argv
    argv = [a for a in argv if a != "--turns"]
    pretrained = None
    if "--pretrained" in argv:
        i = argv.index("--pretrained")
        pretrained = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    for stage_name in (argv or STAGES):
        if stage_name not in STAGES + TUNED_STAGES:
            raise SystemExit(f"profile_train: stage must be one of {STAGES + TUNED_STAGES}")
        if stage_name == "tuned_post_prune" and not pretrained:
            raise SystemExit("profile_train: tuned_post_prune needs --pretrained CKPT")
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(profile_stage(stage_name, card, pretrained=pretrained,
                                       with_turns=with_turns)), flush=True)


if __name__ == "__main__":
    main()
