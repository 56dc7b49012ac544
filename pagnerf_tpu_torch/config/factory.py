"""Module factory (counterpart of ``pagnerf_tpu/config/factory.py``): a parsed
config -> the port's dataset, NeF, tracer, pipeline and trainer, on an
explicit device.

The settings pass through as the JAX factory passes them, quirks included:
``voxel_raymarch_epoch_start <= 0`` means never (10**9); the voxel march
keeps the trainer's 2 samples per voxel and does not read
``samples_per_voxel`` (an SDF-initialisation flag); negative
``micro_batch_imgs``, ``dispatch_ahead``, ``inst_num_dilations`` and
``inst_min_mask_px`` clamp to 0, ``val_extrinsics_every`` and
``num_val_frames_to_save`` to 1; ``render_batch`` 0 means 8000; the
background residual of ``panoptic_bg_residual`` is gated per channel on its
softmax head; a ``BAPipeline`` with anchor frame 0 when extrinsics (train or
val) are optimised.

The parameters come from a seeded init (``TrainerConfig.seed``) and require
grad. The datasets are the JAX factory's: the synthetic scene, a BUP20 tree
(``data/formats/bup20.py``) and a NeRF-standard tree
(``data/formats/nerf_standard.py``); another format raises
``NotImplementedError``, as it does there. The grid settings follow the JAX
``grid_config_from_args``: ``log2_table_size`` is ``max(codebook_bitwidth,
4)``, ``base_lod`` comes from the config, and ``feature_std``,
``base_resolution`` and ``finest_resolution`` are not read (the grids keep
their defaults). As in the JAX factory, a NeF gets only the settings its
class takes (the baselines ``SemanticNeF`` and ``PanopticLiftingNeF`` fewer
than the panoptic NeFs), and no ``separate_sem_grid`` or
``delta_num_layers`` / ``delta_hidden_dim`` from a config: those keep their
module defaults.
"""
from __future__ import annotations

import dataclasses
import inspect
import logging
from typing import Tuple

import torch

from ..data.formats.bup20 import load_bup20
from ..data.formats.nerf_standard import load_nerf_standard
from ..data.multiview import MultiviewDataset
from ..data.synthetic import add_synthetic_predictions, make_dataset
from ..device import resolve_device
from ..models.clustering_nef import (MeanShiftPanopticDDensityNeF,
                                     MeanShiftPanopticDeltaNeF, MeanShiftPanopticNeF)
from ..models.nefs import GridConfig, PanopticDDensityNeF, PanopticDeltaNeF, PanopticNeF
from ..models.panoptic_lifting import PanopticLiftingNeF
from ..models.semantic_nerf import SemanticNeF
from ..models.pipeline import BAPipeline, Pipeline
from ..models.tracer import TracerConfig
from ..train.optimizer import OptimizerConfig
from ..train.trainer import PanopticTrainer, TrainerConfig
from .config import register_class, str2mod

log = logging.getLogger(__name__)


def register_default_classes() -> None:
    for cls in (PanopticNeF, PanopticDeltaNeF, PanopticDDensityNeF, MeanShiftPanopticNeF,
                MeanShiftPanopticDeltaNeF, MeanShiftPanopticDDensityNeF, SemanticNeF,
                PanopticLiftingNeF):
        register_class(cls, cls.__name__)


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def grid_config_from_args(args, delta: bool = False) -> GridConfig:
    return GridConfig(
        grid_type=args.grid_type, num_lods=args.num_lods,
        feature_dim=args.feature_dim,
        capacity_log2=(args.delta_capacity_log_2 if delta else args.capacity_log_2),
        coarsest_scale=args.coarsest_scale, finest_scale=args.finest_scale,
        log2_table_size=max(args.codebook_bitwidth, 4), base_lod=args.base_lod,
        compute_dtype=_dtype(args.compute_dtype))


def load_dataset(args) -> MultiviewDataset:
    """The dataset of ``multiview_dataset_format``, as the JAX factory
    loads it: ``synthetic`` is the scene of ``make_dataset`` (seed 0), with
    the noisy 2-D predictions of ``add_synthetic_predictions`` on top when
    ``synthetic_preds`` is set or a ``load_modes`` entry names predictions;
    ``bup20`` reads the tree at ``dataset_path`` (``load_bup20``);
    ``standard`` / ``nerf_standard`` its transforms (``load_nerf_standard``
    at ``mip``)."""
    fmt = args.multiview_dataset_format
    if fmt == "synthetic":
        res = args.synthetic_res or [40, 30]
        preds = bool(args.synthetic_preds) or any(
            "pred" in str(m) for m in args.load_modes or [])
        data = make_dataset(num_views=args.synthetic_num_views, width=int(res[0]),
                            height=int(res[1]), num_spheres=args.synthetic_num_spheres,
                            pose_noise=(args.pose_noise_strength
                                        if args.add_noise_to_train_poses else 0.0))
        if preds:
            data = add_synthetic_predictions(data, seed=0)
    elif fmt == "bup20":
        data = load_bup20(args)
    elif fmt in ("standard", "nerf_standard"):
        data = load_nerf_standard(args.dataset_path, mip=args.mip or 0,
                                  bg_color=args.bg_color)
    else:
        raise NotImplementedError(f"dataset format {fmt!r} is not supported")
    return MultiviewDataset(data)


def nef_from_args(args, semantic_info) -> torch.nn.Module:
    register_default_classes()
    nef_cls = str2mod.get(args.nef_type, PanopticDeltaNeF)
    kwargs = dict(
        grid=grid_config_from_args(args),
        num_classes=(args.num_classes if args.num_classes > 0
                     else semantic_info["num_classes"]),
        num_instances=(args.num_instances if args.num_instances > 0
                       else semantic_info["num_instances"]),
        hidden_dim=args.hidden_dim, num_layers=args.num_layers,
        activation_type=args.activation_type,
        sem_activation_type=args.sem_activation_type,
        sem_num_layers=args.sem_num_layers, sem_hidden_dim=args.sem_hidden_dim,
        sem_normalize=args.sem_normalize, sem_softmax=args.sem_softmax,
        sem_sigmoid=args.sem_sigmoid, sem_detach=args.sem_detach,
        inst_num_layers=args.inst_num_layers, inst_hidden_dim=args.inst_hidden_dim,
        inst_normalize=args.inst_normalize, inst_softmax=args.inst_softmax,
        inst_sigmoid=args.inst_sigmoid, inst_detach=args.inst_detach,
        inst_direct_pos=args.inst_direct_pos,
        inst_soft_temperature=args.inst_soft_temperature,
        sem_zero_init=args.sem_zero_init,
        panoptic_features_type=args.panoptic_features_type,
        multiscale_type=args.multiscale_type,
        view_multires=args.view_multires, pos_multires=args.pos_multires,
        embedder_type=args.embedder_type,
        compute_dtype=_dtype(args.compute_dtype))
    if issubclass(nef_cls, PanopticDeltaNeF):
        kwargs["delta_grid"] = grid_config_from_args(args, delta=True)
        return nef_cls(**kwargs)
    valid = set(inspect.signature(nef_cls.__init__).parameters)
    return nef_cls(**{k: v for k, v in kwargs.items() if k in valid})


def tracer_config_from_args(args) -> TracerConfig:
    # residual mass into slot 0 only for probability outputs: each panoptic
    # channel is gated on its softmax head
    bg_res_sem, bg_res_inst = bool(args.sem_softmax), bool(args.inst_softmax)
    if args.panoptic_bg_residual and not (bg_res_sem and bg_res_inst):
        log.warning("panoptic_bg_residual is on but %s not softmax-normalised: the "
                    "background residual is off for the non-probability channel(s)",
                    "sem/inst heads are" if not (bg_res_sem or bg_res_inst)
                    else ("the semantic head is" if not bg_res_sem
                          else "the instance head is"))
    return TracerConfig(
        tracer_type=args.tracer_type, num_steps=args.num_steps,
        raymarch_type=args.raymarch_type, bg_color=args.bg_color,
        ray_max_travel=args.ray_max_travel, ray_sparsity_reg=args.ray_sparcity_reg,
        panoptic_bg_residual=args.panoptic_bg_residual,
        bg_residual_sem=bg_res_sem, bg_residual_inst=bg_res_inst)


def trainer_config_from_args(args) -> TrainerConfig:
    return TrainerConfig(
        epochs=args.epochs, batch_size=args.batch_size,
        num_rays_sampled_per_img=args.num_rays_sampled_per_img,
        rgb_weight=args.rgb_weight, sem_weight=args.sem_weight,
        sem_epoch_start=args.sem_epoch_start, sem_conf_enable=args.sem_conf_enable,
        sem_temperature=args.sem_temperature, sem_softmax=args.sem_softmax,
        sem_segment_reg_weight=args.sem_segment_reg_weight,
        contrast_sem_weight=args.contrast_sem_weight,
        inst_loss=args.inst_loss, inst_weight=args.inst_weight,
        inst_epoch_start=args.inst_epoch_start,
        inst_conf_enable=args.inst_conf_enable,
        inst_outlier_rejection=args.inst_outlier_rejection,
        inst_segment_reg_weight=args.inst_segment_reg_weight,
        inst_temperature=args.inst_temperature,
        base_temperature=args.base_temperature, inst_pn_ratio=args.inst_pn_ratio,
        optimize_extrinsics=args.optimize_extrinsics,
        extrinsics_epoch_start=args.extrinsics_epoch_start,
        extrinsics_epoch_end=args.extrinsics_epoch_end,
        optimize_val_extrinsics=args.optimize_val_extrinsics,
        val_extrinsics_start=args.val_extrinsics_start,
        val_extrinsics_end=args.val_extrinsics_end,
        val_extrinsics_every=max(args.val_extrinsics_every, 1),
        prune_every=args.prune_every, prune_at_epoch=args.prune_at_epoch,
        prune_at_start=args.prune_at_start,
        seed_prune_epoch=args.seed_prune_epoch, seed_keep_frac=args.seed_keep_frac,
        seed_refresh_every=args.seed_refresh_every,
        seed_refresh_keep_frac=args.seed_refresh_keep_frac,
        prune_monotone=args.prune_monotone, packed_compaction=args.packed_compaction,
        # 0 is the whole batch in one microbatch; only negatives clamp to it
        micro_batch_imgs=max(args.micro_batch_imgs, 0),
        fused_micro_step=args.fused_micro_step,
        dispatch_ahead=max(args.dispatch_ahead, 0),
        voxel_raymarch_epoch_start=(args.voxel_raymarch_epoch_start
                                    if args.voxel_raymarch_epoch_start > 0 else 10 ** 9),
        # not args.samples_per_voxel (an SDF-initialisation flag): the voxel
        # march keeps the TrainerConfig default of 2 per voxel
        grid_tvl1_reg=args.grid_tvl1_reg, grid_tvl2_reg=args.grid_tvl2_reg,
        delta_grid_tvl1_reg=args.delta_grid_tvl1_reg,
        delta_grid_tvl2_reg=args.delta_grid_tvl2_reg,
        tv_window_size=args.tv_window_size,
        tv_edge_num_samples=int(args.tv_edge_num_samples),
        lod_anneling=args.lod_anneling, lod_annel_epochs=args.lod_annel_epochs,
        lod_annel_epoch_start=args.lod_annel_epoch_start,
        valid_every=args.valid_every, render_batch=args.render_batch or 8000,
        val_mip=args.val_mip or 0,
        inst_num_dilations=max(args.inst_num_dilations, 0),
        inst_min_mask_px=max(args.inst_min_mask_px, 0),
        num_val_frames_to_save=max(args.num_val_frames_to_save, 1),
        render_val_labels=args.render_val_labels, log_2d=args.log_2d,
        save_preds=args.save_preds, save_grid=args.save_grid,
        num_clustering_samples=args.num_clustering_samples or 20000,
        low_res_val=args.low_res_val, random_lod=args.random_lod)


def optimizer_config_from_args(args) -> OptimizerConfig:
    return OptimizerConfig(
        optimizer_type=args.optimizer_type, lr=args.lr,
        weight_decay=args.weight_decay, grid_lr_weight=args.grid_lr_weight,
        delta_grid_lr_weight=args.delta_grid_lr_weight,
        extrinsics_lr=args.extrinsics_lr, use_lr_scheduler=args.use_lr_scheduler,
        lr_scheduler_type=args.lr_scheduler_type,
        lr_step_size=args.lr_step_size, lr_step_gamma=args.lr_step_gamma,
        lr_warmup_epochs=args.lr_warmup_epochs, lr_div_factor=args.lr_div_factor,
        num_epochs=args.epochs, clip_grad_norm=args.clip_grad_norm)


def get_modules_from_config(args, device="cuda", **trainer_fields,
                            ) -> Tuple[Pipeline, MultiviewDataset, PanopticTrainer]:
    """(pipeline, dataset, trainer) of ``args`` on ``device`` (the card
    unless ``"cpu"``). ``trainer_fields`` replace ``TrainerConfig`` fields
    that no flag sets: ``seed`` (0) is the parameters' init, the trainer's
    ray sampling and its jitter draws (the scene and its predictions keep
    seed 0, as the JAX factory keeps them); ``compact_steps_after_prune``
    (-1) the compacted layout's samples per ray."""
    dev = resolve_device(device)
    dataset = load_dataset(args)
    trainer_cfg = dataclasses.replace(trainer_config_from_args(args), **trainer_fields)
    nef = nef_from_args(args, dataset.semantic_info)
    tracer_cfg = tracer_config_from_args(args)
    if args.optimize_extrinsics or args.optimize_val_extrinsics:
        pipeline = BAPipeline(nef, tracer_cfg,
                              torch.from_numpy(dataset.data["view_matrices"]),
                              anchor_frame_idxs=[0])
    else:
        pipeline = Pipeline(nef, tracer_cfg)
    pipeline.reset_parameters(torch.Generator().manual_seed(trainer_cfg.seed))
    pipeline = pipeline.to(dev).requires_grad_(True)
    trainer = PanopticTrainer(pipeline, dataset, trainer_cfg,
                              optimizer_config_from_args(args),
                              occ_level=args.blas_level)
    trainer.timer.activate = bool(args.perf)
    return pipeline, dataset, trainer
