"""Entry points of the port (counterparts of ``__graft_entry__._flagship``
and ``__graft_entry__.entry``).

``flagship()`` builds the flagship panoptic model: a ``BAPipeline`` over a
``PanopticDeltaNeF`` with two permutohedral grids (24 LoDs x 2^18 x F=2,
float32 tables and gathers), hidden width 64, bfloat16 decoders, and a
512-step dense tracer, over the synthetic 8-view scene. ``entry()`` returns
the flagship render -- 4096 rays of camera 0, channels rgb, depth, semantics
and inst_embedding -- and its example inputs.

Both run on the CUDA card unless the caller passes ``device="cpu"``, and
raise on a host without one. Weights come from a seeded init
(``torch.Generator``); load converted JAX weights with
``pipe.load_state_dict(convert.params_from_flax(tree))``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import FrozenSet

import torch

from .core.rays import Rays
from .data.multiview import MultiviewDataset
from .data.synthetic import make_dataset
from .device import resolve_device
from .models.nefs import GridConfig, PanopticDeltaNeF
from .models.pipeline import BAPipeline
from .models.tracer import TracerConfig
from .ops.occupancy import OccupancyGrid
from .train.optimizer import OptimizerConfig
from .train.trainer import PanopticTrainer, TrainerConfig

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
