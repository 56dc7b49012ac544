"""Entry points of the port (counterparts of ``__graft_entry__._flagship``
and ``__graft_entry__.entry``).

``flagship()`` builds the flagship panoptic model: a ``BAPipeline`` over a
``PanopticDeltaNeF`` with two permutohedral grids (24 LoDs x 2^18 x F=2,
float32 tables and gathers), hidden width 64, bfloat16 decoders, and a
512-step dense tracer, over the synthetic 8-view scene. ``entry()`` returns
the flagship render -- min(4096, H x W) rays of camera 0, i.e. all 3072
pixels of the 64x48 scene, channels rgb, depth, semantics and
inst_embedding -- and its example inputs.

``train_flagship`` trains the pre-prune stages for a few steps;
``train_flagship_schedule`` runs the default schedule past its prune: the
prune, then steps of the panoptic stage (voxel march, packed layout) and of
a val-pose epoch. ``validate_flagship`` runs the schedule's validations
around that: the mid-training one before the prune, the final one after it,
and the point-cloud map.

All run on the CUDA card unless the caller passes ``device="cpu"``, and
raise on a host without one. Weights come from a seeded init
(``torch.Generator``); load converted JAX weights with
``pipe.load_state_dict(convert.params_from_flax(tree))``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, FrozenSet, Optional

import torch

from .core.rays import Rays
from .data.multiview import MultiviewDataset
from .data.synthetic import add_synthetic_predictions, make_dataset
from .device import resolve_device
from .models.nefs import GridConfig, PanopticDeltaNeF
from .models.pipeline import BAPipeline
from .models.tracer import TracerConfig
from .ops.occupancy import OccupancyGrid
from .train.optimizer import OptimizerConfig
from .train.trainer import PanopticTrainer, TrainerConfig
from .train.validation import validate
from .utils.render_map import generate_pc_map_from_views

FLAGSHIP_CHANNELS = frozenset({"rgb", "depth", "semantics", "inst_embedding"})


def flagship(tiny: bool = False, device="cuda", seed: int = 0,
             compute_dtype: torch.dtype = torch.bfloat16):
    """(pipeline, dataset) of the flagship configuration; ``tiny`` is the
    JAX package's test size (4 LoDs x 2^8 x 2, 16 steps, 16x16 images).
    ``compute_dtype`` is the decoders' (the JAX flagship's is bfloat16)."""
    dev = resolve_device(device)
    if tiny:
        grid = GridConfig(num_lods=4, feature_dim=2, capacity_log2=8,
                          coarsest_scale=1.0, finest_scale=0.05)
        tracer = TracerConfig(num_steps=16, ray_max_travel=2.0)
        data = make_dataset(num_views=4, width=16, height=16, num_spheres=2)
    else:
        grid = GridConfig(num_lods=24, feature_dim=2, capacity_log2=18,
                          coarsest_scale=1.0, finest_scale=0.0001)
        tracer = TracerConfig(num_steps=512, ray_max_travel=2.0)
        data = make_dataset(num_views=8, width=64, height=48, num_spheres=4)
    ds = MultiviewDataset(data)
    si = ds.semantic_info
    nef = PanopticDeltaNeF(grid=grid, num_classes=si["num_classes"],
                           num_instances=si["num_instances"], hidden_dim=64,
                           panoptic_features_type="delta",
                           compute_dtype=compute_dtype)
    pipe = BAPipeline(nef, tracer, torch.from_numpy(data["view_matrices"]),
                      anchor_frame_idxs=[0])
    pipe.reset_parameters(torch.Generator().manual_seed(seed))
    pipe.requires_grad_(False)     # serving; the trainer turns gradients on
    return pipe.to(dev), ds


def entry(device="cuda", tiny: bool = False, seed: int = 0,
          compute_dtype: torch.dtype = torch.bfloat16):
    """Returns (fn, (pipe, origins, dirs, cam_idx)):
    ``fn(pipe, origins, dirs, cam_idx, channels=FLAGSHIP_CHANNELS)`` renders
    up to 4096 rays of camera 0 and returns (rgb, depth, semantics,
    inst_embedding), ``None`` for a channel not asked for."""
    dev = resolve_device(device)
    pipe, ds = flagship(tiny=tiny, device=dev, seed=seed,
                        compute_dtype=compute_dtype)
    occ = OccupancyGrid.create(level=7, device=dev)

    base = ds.data["base_rays_dirs"].reshape(-1, 3)
    n_rays = min(4096, base.shape[0])
    origins = torch.zeros((1, n_rays, 3), dtype=torch.float32, device=dev)
    dirs = torch.from_numpy(base[None, :n_rays]).float().to(dev)
    cam_idx = torch.zeros((1,), dtype=torch.int64, device=dev)

    def fn(pipe, origins, dirs, cam_idx,
           channels: FrozenSet[str] = FLAGSHIP_CHANNELS):
        with torch.inference_mode():
            rays = Rays(origins=origins, dirs=dirs, dist_min=0.0, dist_max=6.0)
            rb = pipe(rays, channels, occ, cam_idx=cam_idx)
        return rb.rgb, rb.depth, rb.semantics, rb.inst_embedding

    return fn, (pipe, origins, dirs, cam_idx)


TRAIN_STAGES = ("rgb", "panoptic")


def train_config(stage: str, tiny: bool = False) -> TrainerConfig:
    """The flagship's trainer settings: batches of 6 images x 4096 rays (32
    rays when ``tiny``), one image per microbatch. A batch holds at most the
    training views: 4 of the flagship's 8 (2 of the tiny scene's 4). 'rgb' is the default
    ``TrainerConfig`` (the RGB phase: colour only, extrinsics on); 'panoptic'
    switches the semantic and instance heads on from epoch 0, as the JAX
    package's multichip dryrun does, with no prune and no voxel march."""
    if stage not in TRAIN_STAGES:
        raise ValueError(f"stage must be one of {TRAIN_STAGES}, got {stage!r}")
    cfg = TrainerConfig(batch_size=6, num_rays_sampled_per_img=32 if tiny else 4096,
                        micro_batch_imgs=1)
    if stage == "panoptic":
        cfg = dataclasses.replace(cfg, sem_epoch_start=0, inst_epoch_start=0,
                                  prune_every=-1, optimize_val_extrinsics=False,
                                  voxel_raymarch_epoch_start=1000)
    return cfg


def train_flagship(stage: str = "rgb", steps: int = 3, device="cuda",
                   tiny: bool = False, seed: int = 0,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """Train the flagship for ``steps`` steps of ``stage`` ('rgb' or
    'panoptic'); step k runs the stage of epoch k // steps_per_epoch (one
    step per epoch on the flagship's 4 training views, so a panoptic run of
    3 steps reaches the segment regulariser of epoch 2). Returns (trainer,
    log): one dict per step with its ``epoch``, the batch's ``cam_idx``, its
    wall ``seconds`` (host clock; the losses' read-back ends the step) and
    its ``losses`` as floats."""
    dev = resolve_device(device)
    pipe, ds = flagship(tiny=tiny, device=dev, seed=seed,
                        compute_dtype=compute_dtype)
    pipe.requires_grad_(True)
    cfg = dataclasses.replace(train_config(stage, tiny), seed=seed)
    trainer = PanopticTrainer(pipe, ds, cfg, OptimizerConfig())
    log = []
    for k in range(steps):
        epoch = k // trainer.steps_per_epoch
        batch = ds.sample_batch(trainer.rng, cfg.batch_size,
                                cfg.num_rays_sampled_per_img)
        t0 = time.perf_counter()
        losses = trainer.train_step(trainer.stage_for_epoch(epoch), batch)
        losses = {name: float(v) for name, v in losses.items()}
        log.append({"epoch": epoch, "cam_idx": batch["cam_idx"].tolist(),
                    "seconds": time.perf_counter() - t0, "losses": losses})
        trainer.epoch = epoch
    return trainer, log


def scene_density(scene, res: int, dev) -> torch.Tensor:
    """A fixture, not a field's density: 1e3 in the cells whose box meets
    one of the synthetic scene's spheres or its wall (the inside of the
    [-0.9, 0.9]^3 box the cameras look into), 0 elsewhere; [res^3] in
    ``cell_centers_jittered_T`` order."""
    c = (torch.arange(res, device=dev, dtype=torch.float64) + 0.5) / res * 2 - 1
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    h = 1.0 / res                                   # half a cell
    cover = torch.zeros_like(x, dtype=torch.bool)
    for cen, r in zip(scene.centers, scene.radii):
        d = torch.sqrt((x - cen[0]) ** 2 + (y - cen[1]) ** 2 + (z - cen[2]) ** 2)
        cover |= d <= r + math.sqrt(3.0) * h
    near = torch.stack([(a.abs() - h).clamp(min=0) for a in (x, y, z)]).amax(0)
    far = torch.stack([a.abs() + h for a in (x, y, z)]).amax(0)
    cover |= (near <= 0.9) & (far >= 0.9)
    return cover.reshape(-1).float() * 1e3


def apply_scene_fixture(trainer: PanopticTrainer) -> None:
    """The occupancy a trained field of the synthetic scene would leave: the
    cells of its spheres and wall dilated by one cell, set through
    ``update_from_density`` as the prune sets it, and the occupied share
    that the stages size their packed budget from."""
    density = scene_density(trainer.dataset.data["scene"], trainer.occ.res,
                            trainer.occ.mask.device)
    trainer.occ = trainer.occ.update_from_density(density, decay=0.0, dilate=1)
    trainer._occ_frac = float(trainer.occ.mask.float().mean())


def post_prune_epochs(trainer: PanopticTrainer, steps: int, val_pose_steps: int):
    """Epochs of the trainer's schedule past its first real prune: the first
    ``steps`` whose stage trains the panoptic heads on the voxel march, then
    ``val_pose_steps`` times the first val-pose epoch after them. Read from
    ``should_prune`` and ``stage_for_epoch`` (601..603 and 610 under the
    default ``TrainerConfig``); call it after the prune, whose occupied
    share sizes the stages."""
    cfg = trainer.cfg
    prune = next(e for e in range(1, cfg.epochs) if trainer.should_prune(e))
    stages = {e: trainer.stage_for_epoch(e) for e in range(prune + 1, cfg.epochs)}
    panoptic = [e for e, st in stages.items()
                if st.use_sem and st.raymarch_type == "voxel"][:steps]
    after = panoptic[-1] if panoptic else prune
    val = [next(e for e, st in stages.items() if e > after and st.training_val_poses)]
    return panoptic + val * val_pose_steps


def schedule_trainer(device="cuda", tiny: bool = False) -> PanopticTrainer:
    """The flagship's trainer under the default ``TrainerConfig`` schedule:
    batches of 6 images x 4096 rays (32 when ``tiny``), one image per
    microbatch, on the 128^3 occupancy grid (64^3 when ``tiny``)."""
    dev = resolve_device(device)
    pipe, ds = flagship(tiny=tiny, device=dev)
    pipe.requires_grad_(True)
    cfg = TrainerConfig(batch_size=6, num_rays_sampled_per_img=32 if tiny else 4096,
                        micro_batch_imgs=1)
    return PanopticTrainer(pipe, ds, cfg, OptimizerConfig(), occ_level=6 if tiny else 7)


def run_past_prune(trainer: PanopticTrainer, steps: int = 3,
                   after_prune: Optional[Callable[[PanopticTrainer], None]] = None,
                   val_pose_steps: int = 1):
    """Steps 1-3 of ``train_flagship_schedule`` on ``trainer``; returns its
    log."""
    ds, cfg = trainer.dataset, trainer.cfg
    t0 = time.perf_counter()
    trainer.prune()
    share = trainer._occ_frac        # a host read: the prune has finished
    log = [{"prune": True, "seconds": time.perf_counter() - t0, "occupied_share": share}]
    if after_prune is not None:
        after_prune(trainer)
    apply_scene_fixture(trainer)
    for epoch in post_prune_epochs(trainer, steps, val_pose_steps):
        stage = trainer.stage_for_epoch(epoch)
        split = "val" if stage.training_val_poses else "train"
        batch = ds.sample_batch(trainer.rng, cfg.batch_size, cfg.num_rays_sampled_per_img,
                                split)
        t0 = time.perf_counter()
        losses = {name: float(v) for name, v in trainer.train_step(stage, batch).items()}
        log.append({"epoch": epoch, "cam_idx": batch["cam_idx"].tolist(),
                    "seconds": time.perf_counter() - t0, "losses": losses,
                    "stage": stage})
        trainer.epoch = epoch
    return log


def train_flagship_schedule(steps: int = 3, device="cuda", tiny: bool = False,
                            after_prune: Optional[Callable[[PanopticTrainer], None]] = None,
                            val_pose_steps: int = 1):
    """The flagship under the default ``TrainerConfig`` schedule past its
    prune (``schedule_trainer``), in three steps:

    1. ``trainer.prune()``, the real prune the schedule runs after epoch
       201, on the untrained field;
    2. ``apply_scene_fixture``: an untrained field's prune says nothing of
       the scene, so the occupancy is set to what a trained field would
       leave;
    3. ``steps`` steps of the first panoptic epochs past the prune and
       ``val_pose_steps`` steps of the next val-pose epoch
       (``post_prune_epochs``; its 'val' cameras, only the extrinsics
       free), each on the voxel march and the packed layout sized from the
       occupied share.

    ``after_prune(trainer)``, if given, runs right after the prune (to read
    its kernel launches). Returns (trainer, log): first ``{"prune": True,
    "seconds", "occupied_share"}`` of the prune, then one dict per step as
    ``train_flagship`` logs it, with the step's ``stage``."""
    trainer = schedule_trainer(device, tiny)
    return trainer, run_past_prune(trainer, steps, after_prune, val_pose_steps)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def validate_flagship(device="cuda", tiny: bool = False, steps: int = 3,
                      log_dir: Optional[str] = None,
                      after: Optional[Callable[[str, PanopticTrainer], None]] = None):
    """The flagship's validations under the default schedule
    (``schedule_trainer``), in order:

    1. ``pre_prune``: the schedule's first validation, after the first
       epoch e with (e + 1) a multiple of ``valid_every``: at ``val_mip``,
       on the dense ray march, rgb and depth (the single encode);
    2. ``schedule``: ``run_past_prune`` (the prune, the scene fixture,
       ``steps`` panoptic steps and one val-pose step);
    3. ``final``: ``validate`` at ``cfg.epochs``: mip 0 (``low_res_val`` is
       off), the 'val' cameras through the base rays and the extrinsics the
       val-pose step trained, all four channels on the voxel march and the
       packed layout (the dual encode), against the ground truth and, as the
       ``_pred`` baselines, the 2-D predictions that
       ``add_synthetic_predictions`` attaches to the dataset first;
    4. ``map``: ``generate_pc_map_from_views`` at mip 2 over every view.

    ``after(part, trainer)``, if given, runs after each part (to read its
    kernel launches). Every wall time ends with a host read of the results.
    Returns (trainer, results): per part its ``seconds``, and the
    validations' ``epoch`` and ``metrics``, the schedule's ``log``, the
    map's ``points`` (the point-cloud dict)."""
    trainer = schedule_trainer(device, tiny)
    cfg, ds = trainer.cfg, trainer.dataset
    done = after or (lambda part, trainer: None)
    results = {}
    epoch = next(e for e in range(cfg.epochs) if (e + 1) % cfg.valid_every == 0)
    trainer.epoch = epoch + 1             # ``run_epoch(epoch)`` has just ended
    metrics, seconds = _timed(lambda: validate(trainer, epoch, log_dir=log_dir))
    results["pre_prune"] = {"epoch": epoch, "seconds": seconds, "metrics": metrics}
    done("pre_prune", trainer)
    log, seconds = _timed(lambda: run_past_prune(trainer, steps, None, 1))
    results["schedule"] = {"seconds": seconds, "log": log}
    done("schedule", trainer)
    ds.data = add_synthetic_predictions(ds.data, seed=cfg.seed)
    trainer.epoch = cfg.epochs            # ``train()`` has ended
    metrics, seconds = _timed(lambda: validate(trainer, cfg.epochs, log_dir=log_dir))
    results["final"] = {"epoch": cfg.epochs, "seconds": seconds, "metrics": metrics}
    done("final", trainer)
    points, seconds = _timed(lambda: generate_pc_map_from_views(trainer, mip=2))
    results["map"] = {"seconds": seconds, "points": points}
    done("map", trainer)
    return trainer, results


# ------------------------------------------------------ data parallelism
def _launch_counts() -> dict:
    """The kernel wrappers' launch counts (they count on the card only)."""
    from .ops import assignment, permuto_encoding, table_gather  # noqa: F401
    counts = {k: fn.launches for k, fn in table_gather.KERNELS.items()}
    counts["lap_assign"] = assignment.lap_assign.launches
    return counts


def _reset_launch_counts() -> None:
    from .ops import assignment, permuto_encoding, table_gather  # noqa: F401
    table_gather.reset_launches()
    assignment.lap_assign.launches = 0


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def data_parallel_run(group, spec: dict) -> dict:
    """Build a trainer from ``spec["argv"]`` (the command line's flags,
    through the port's factory, on ``spec["device"]``) or, without
    ``argv``, of the flagship (``tiny``, ``compute_dtype``, ``occ_level``,
    TrainerConfig fields ``cfg``), make it rank
    ``group.rank`` of ``group`` (or a single process with ``group=None``),
    optionally load ``spec["params"]`` (a state dict), then run ``spec["actions"]`` in order. Every rank runs the same actions
    on the same global batches, so a single process's run is the
    reference of a group's. Actions (dicts with ``do``):

    - ``step``: ``train_step`` of the stage of ``epoch`` on ``batch`` (or a
      batch sampled from the trainer's generator; ``local_batches[rank]``
      through ``shard_ray_batch_host_local``), with ``jitters`` if given
      (global, one per microbatch); ``fused`` runs ``fused_train_step``;
      ``repeat`` times (``same_batch``: on one batch sampled before the
      first, so a fused step's key replays);
    - ``grads``: ``grad_step`` of ``batch``'s first microbatch (global
      gradients under a group);
    - ``epoch``: ``run_epoch(epoch)`` (its batches from the trainer's
      generator), its mean losses;
    - ``seed_prune``, ``prune``, ``fixture`` (``apply_scene_fixture``, the
      prune flag set, ``occ_frac`` to size the packed budget);
    - ``params``: a host copy of the parameters;
    - ``snapshot`` / ``restore``: keep the trainer's state (and its
      generators' states) in memory / put it back;
    - ``validate``: ``validate`` at ``epoch`` on rank 0 only;
    - ``save`` / ``load``: a checkpoint at ``path`` (written by rank 0).

    Returns per action: its ``losses`` (floats), ``grads`` (host tensors),
    the collectives it made (``collectives``: tag, elements), its ``ms``
    (host clock to a device sync), the kernels' ``launches``, and the
    group's ``pack_overflows`` so far; plus the parameters' element count."""
    from .config import factory
    from .config.config import parse_options
    import copy

    from .train.checkpoint import load_checkpoint, load_state, save_checkpoint, trainer_state
    from .train.validation import validate as run_validate

    dev = resolve_device(spec["device"])
    if "argv" in spec:
        pipe, ds, trainer = factory.get_modules_from_config(parse_options(list(spec["argv"])),
                                                            str(dev))
    else:
        # the flagship (``flagship``) under a TrainerConfig of ``cfg``
        pipe, ds = flagship(tiny=spec.get("tiny", True), device=dev,
                            compute_dtype=getattr(torch, spec.get("compute_dtype",
                                                                  "bfloat16")))
        pipe.requires_grad_(True)
        trainer = PanopticTrainer(pipe, ds, TrainerConfig(**spec.get("cfg", {})),
                                  OptimizerConfig(), occ_level=spec.get("occ_level", 7))
    if spec.get("params") is not None:
        pipe.load_state_dict(spec["params"])
    if group is not None:
        trainer.set_group(group)
    rank = 0 if group is None else group.rank
    out = {"rank": rank, "world": 1 if group is None else group.world,
           "device": str(dev if group is None else group.device),
           "backend": None if group is None else group.backend,
           "param_elements": {n: p.numel() for n, p in trainer.params.items()},
           "actions": []}
    snapshot = None
    for act in spec["actions"]:
        do = act["do"]
        rec = {"do": do}
        if group is not None:
            group.log.clear()
        _reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        if do in ("step", "grads"):
            stage = trainer.stage_for_epoch(act.get("epoch", 0))
            split = "val" if stage.training_val_poses else "train"
            rec["stage"] = stage.label
            rec["losses"] = []
            fixed = act.get("batch")
            if fixed is None and act.get("same_batch"):
                fixed = ds.sample_batch(trainer.rng, trainer.cfg.batch_size,
                                        trainer.cfg.num_rays_sampled_per_img, split)
            for _ in range(act.get("repeat", 1)):
                batch = fixed
                if act.get("local_batches") is not None:
                    # each rank's own share of the rays (``shard_ray_batch_host_local``)
                    from .parallel.sharding import shard_ray_batch_host_local
                    batch = shard_ray_batch_host_local(act["local_batches"][rank], group)
                elif batch is None:
                    batch = ds.sample_batch(trainer.rng, trainer.cfg.batch_size,
                                            trainer.cfg.num_rays_sampled_per_img, split)
                if do == "grads":
                    sub = trainer._micro_batches(batch)[0]
                    grads, losses = trainer.grad_step(stage, sub, act.get("jitter"))
                    rec["grads"] = {n: g.detach().float().cpu() for n, g in grads.items()}
                elif act.get("fused"):
                    losses = trainer.fused_train_step(stage, batch, act.get("jitters"))
                else:
                    losses = trainer.train_step(stage, batch, act.get("jitters"))
                rec["losses"].append({k: float(v) for k, v in losses.items()})
            trainer.epoch = act.get("epoch", 0)
        elif do == "epoch":
            rec["losses"] = [trainer.run_epoch(act["epoch"])]
            rec["stage"] = trainer.stage_for_epoch(act["epoch"]).label
        elif do == "seed_prune":
            trainer.prune(seed=True)
        elif do == "prune":
            trainer.prune()
        elif do == "fixture":
            apply_scene_fixture(trainer)
            trainer._pruned = True
            if act.get("occ_frac") is not None:
                trainer._occ_frac = act["occ_frac"]      # sizes the packed budget
        elif do == "snapshot":
            snapshot = (trainer_state(trainer), copy.deepcopy(trainer.rng),
                        trainer.generator.get_state())
        elif do == "restore":
            load_state(trainer, snapshot[0])
            trainer.rng = copy.deepcopy(snapshot[1])
            trainer.generator.set_state(snapshot[2])
        elif do == "params":
            rec["params"] = {n: p.detach().float().cpu().clone()
                             for n, p in trainer.params.items()}
        elif do == "validate":
            if rank == 0:
                rec["metrics"] = run_validate(trainer, act.get("epoch", 0))
        elif do == "save":
            if rank == 0:
                trainer.epoch = act.get("epoch", trainer.epoch)
                save_checkpoint(act["path"], trainer)
            if group is not None:
                from .parallel.sharding import all_reduce
                all_reduce(torch.zeros(1, device=dev), group, "barrier")
        elif do == "load":
            load_checkpoint(act["path"], trainer)
        else:
            raise ValueError(f"unknown action {do!r}")
        _sync(dev)
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        rec["launches"] = _launch_counts()
        rec["collectives"] = list(group.log) if group is not None else []
        rec["pack_overflows"] = 0 if group is None else int(group.pack_overflows)
        rec["pack_share_max"] = 0.0 if group is None else float(group.pack_share_max)
        rec["occupied_share"] = float(trainer.occ.mask.float().mean())
        out["actions"].append(rec)
    out["fused_log"] = list(trainer.fused_log)
    return out


DRYRUN_ARGV_TINY = ["--config", "configs/synthetic/tiny.yaml", "--num-lods", "4",
                    "--capacity-log-2", "8", "--delta-capacity-log-2", "8",
                    "--hidden-dim", "16", "--num-steps", "16",
                    "--synthetic-num-views", "8", "--synthetic-res", "16", "16"]


def audit_collectives(record: dict, param_elements: dict) -> dict:
    """The collective audit of one step's record: the gradient sums carry
    each parameter's elements at most once, and every other collective has
    fewer than 4096 elements. Raises otherwise."""
    coll = record["collectives"]
    grad = sum(n for tag, n in coll if tag == "grad")
    small = [(tag, n) for tag, n in coll if tag != "grad"]
    big = [(tag, n) for tag, n in small if n >= 4096]
    total = sum(param_elements.values())
    if big:
        raise AssertionError(f"collectives of 4096 elements or more besides the "
                             f"gradient sum: {big}")
    if grad > total:
        raise AssertionError(f"the gradient sums carry {grad} elements, the "
                             f"parameters hold {total}")
    tags = {}
    for tag, n in small:
        tags.setdefault(tag, [0, 0])
        tags[tag][0] += 1
        tags[tag][1] += n
    return {"grad_elements": grad, "param_elements": total,
            "grad_calls": sum(1 for tag, _ in coll if tag == "grad"),
            "small": {t: {"calls": c, "elements": e} for t, (c, e) in sorted(tags.items())},
            "largest_small": max((n for _, n in small), default=0)}


def dryrun_multichip(n: int, device="cuda", tiny: bool = False,
                     ranks_per_device: int = 1, workdir: Optional[str] = None,
                     sweep_steps: int = 3) -> dict:
    """One full step of the flagship's panoptic stage (the JAX dryrun's:
    semantic and instance heads from epoch 0, outlier rejection, no
    prune) on the tuned config at full width (``tiny``: 4 LoDs x 2^8, 16x16
    images, 16 rays a rank, on the CPU a few seconds), sharded over an
    ``n``-rank group and in one process, from the same seed: every loss
    must agree within rtol 1e-4 / atol 1e-5. Prints and returns the
    losses, the collective audit of the sharded step
    (``audit_collectives``) and the scaling sweep: step ms at a fixed
    global workload for n in {1, 2, 4} up to the devices present
    (``ranks_per_device`` > 1 puts several gloo ranks on one card; best of
    ``sweep_steps``)."""
    import tempfile

    from .parallel.launch import run_ranks

    dev = resolve_device(device)
    rays = 16 * n if tiny else 4096
    argv = (DRYRUN_ARGV_TINY if tiny else [
        "--config", "configs/synthetic/schedule_preds_flagship_tuned_60ep.yaml"]) + [
        "--num-rays-sampled-per-img", str(rays), "--sem-epoch-start", "0",
        "--inst-epoch-start", "0"]
    workdir = workdir or tempfile.mkdtemp(prefix="dryrun_multichip_")
    spec = {"argv": argv, "device": dev.type,
            "actions": [{"do": "step", "epoch": 0}]}
    single = data_parallel_run(None, dict(spec, device=str(dev)))
    ranks = run_ranks(n, "pagnerf_tpu_torch.entry:data_parallel_run", spec, dev.type,
                      os.path.join(workdir, f"dryrun{n}"), ranks_per_device)
    ref = single["actions"][0]["losses"][0]
    for r in ranks:
        got = r["actions"][0]["losses"][0]
        if sorted(got) != sorted(ref):
            raise AssertionError(f"rank {r['rank']} logs {sorted(got)}, one process {sorted(ref)}")
        for k, v in ref.items():
            if not (math.isfinite(got[k]) and abs(got[k] - v) <= 1e-5 + 1e-4 * abs(v)):
                raise AssertionError(f"{k}: {n}-rank step {got[k]} != one process {v}")
    audit = audit_collectives(ranks[0]["actions"][0], ranks[0]["param_elements"])
    result = {"n": n, "backend": ranks[0]["backend"],
              "devices": [r["device"] for r in ranks], "losses": ref,
              "losses_sharded": ranks[0]["actions"][0]["losses"][0], "audit": audit}
    print(f"dryrun_multichip({n}): ok - sharded == unsharded, losses "
          + ", ".join(f"{k}={v:.6g}" for k, v in sorted(ref.items())))
    print(f"collective audit: {audit['grad_calls']} gradient bucket(s) of "
          f"{audit['grad_elements']} elements (parameters: {audit['param_elements']}), "
          f"other collectives {audit['small']}, the largest {audit['largest_small']} "
          f"elements (< 4096)")
    result["sweep"] = scaling_sweep(spec, dev, workdir, ranks_per_device, sweep_steps)
    print("scaling sweep (fixed global workload): " + ", ".join(
        f"n={s['n']}: {s['step_ms']:.1f} ms/step" for s in result["sweep"]))
    return result


def scaling_sweep(spec: dict, dev, workdir: str, ranks_per_device: int = 1,
                  steps: int = 3) -> list:
    """Step ms (best of ``steps`` timed steps after one warm-up step) at the
    same global batch for n in {1, 2, 4}, as many as the devices present
    (times ``ranks_per_device``) allow; n = 1 is a one-rank group."""
    from .parallel.launch import run_ranks
    from .parallel.sharding import devices_present

    limit = devices_present(torch.device(dev).type) * ranks_per_device
    out = []
    for n in (1, 2, 4):
        if n > limit:
            break
        run = dict(spec, actions=[{"do": "step", "epoch": 0}] * (steps + 1))
        ranks = run_ranks(n, "pagnerf_tpu_torch.entry:data_parallel_run", run,
                          torch.device(dev).type, os.path.join(workdir, f"sweep{n}"),
                          ranks_per_device)
        timed = [max(r["actions"][i]["ms"] for r in ranks) for i in range(1, steps + 1)]
        coll = ranks[0]["actions"][-1]["collectives"]
        out.append({"n": n, "step_ms": min(timed), "steps_ms": timed,
                    "collectives": len(coll)})
    return out
