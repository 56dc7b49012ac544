"""Panoptic trainer (counterpart of ``pagnerf_tpu/train/trainer.py``).

The step is the JAX package's host-loop microbatch accumulation: the batch is
cut into image microbatches; for each, the losses go through one forward and
one backward (gradients add into ``.grad`` in microbatch order), then the
summed gradients are scaled by ``1 / num_micro`` and the masked Adam update
runs once. Random draws -- each microbatch's stratified jitter, each prune
sample's cell jitter -- come from ``draw(shape)``: by default uniforms from
the trainer's ``torch.Generator``; a test hands in a ``draw`` that repeats
the JAX trainer's key stream, or gives ``train_step`` its ``jitters``.

On the card each microbatch runs the fused encode kernel (single in an RGB
stage, dual once the panoptic heads render), its table-gradient scatter
kernel, and -- for a camera that is not an anchor frame -- the ``dbary``
kernel that carries the pose gradient (``ops/table_gather.py``); the prune's
density pass runs the single encode without a gradient.

Ported: ``TrainerConfig``, ``StageConfig`` and ``snap_microbatch`` with the
JAX package's names and defaults; ``stage_for_epoch`` with the voxel march,
the packed and compacted layouts after a prune and the val-pose epochs;
every loss of the JAX trainer: RGB, semantic (with the segment-consistency
regulariser and the ``contrast_sem_weight`` contrastive term), the instance
losses ``linear_assignment_things`` (with the repeated-ID rejection and
the segment regulariser), ``linear_assignment`` and ``sup_contrastive``, the
tracer's ray sparsity, and the TV of the main grid's features and of the
instance embeddings over a random window (its vertex from
``draw_normal``); ``train_step``; ``prune`` (real and seed), ``should_prune``,
``maybe_seed_prune``, ``run_epoch`` and ``train``, with LoD annealing (the
weights set once per epoch from the global step) and random LoD (a cut drawn
from the numpy generator before each step's batch, so the sampled rays stay
the JAX trainer's). ``run_epoch`` keeps up to ``dispatch_ahead`` steps'
loss dicts on the device and reads the oldest when one more is queued (the
JAX package's pipelined readback; 0 reads every step at once), and times
its phases, each prune and each epoch on ``timer`` (``--perf``).
``batch_render`` is the chunked full-image render that validation and the
point-cloud map call; ``maybe_upsample_tensorf`` the TensoRF grid's
progressive resolution steps at the end of an epoch. A pipeline without
extrinsics trains on the batch's world rays.

The step reads nothing back from the device: the optimizer's skip is a
device flag, the assignment of the instance losses runs on the device, and
the anchor-frame check reads the batch's numpy cameras. With
``fused_micro_step`` (or ``PAGNERF_FUSED_STEP``) the whole step -- every
microbatch's forward and backward, the accumulation in microbatch order,
the ``1 / num_micro`` scale and the masked update -- reads only static
buffers (the batch, each microbatch's jitter and TV normals drawn in the
host loop's order, ``lod_w``). On the card a key (the stage, the number
of microbatches, which of them are all-anchor) runs eagerly at its first
step, is captured into a ``torch.cuda.CUDAGraph`` at its second and
replayed after; on the CPU the same function runs eagerly. It equals the
host loop bit for bit, as the JAX package's fused step equals its own.

Given a ``group`` (``parallel/sharding.py``), the trainer is one rank of
ray-axis data parallelism: ``train_step`` takes the global batch (or a
``shard_ray_batch_host_local`` share) and keeps its rank's rays; every rank
draws the global jitter and TV normals from the same generator and keeps
its rays' rows; each loss is the rank's share of the global loss (sums
over its rays divided by global counts, the assignment's and the segment
regulariser's statistics summed over the ranks, ray-free terms weighted by
1 / world); the packed layout's cap comes from the global histogram; the
gradients are summed once per step in buckets before the masked update,
and the logged losses are the global ones. The prune runs on every rank
and a checksum proves the occupancy equal. ``sup_contrastive`` (and
``contrast_sem_weight``), which couple every ray pair of an image, and a
packed layout traced in ``ray_chunk`` blocks are refused (ROADMAP.md Queue
1 item 14). On the card the fused step captures the group's NCCL
collectives into its graph; over gloo it is refused there.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.camera import rays_to_3d_points
from ..core.rays import Rays
from ..core.render_buffer import RenderBuffer
from ..data.multiview import MultiviewDataset
from ..device import constant
from ..losses.lin_assignment import lin_assignment_loss, lin_assignment_things_loss
from ..losses.photometric import rgb_l1_loss, semantic_loss
from ..losses.regularizers import (grid_tv_l1_loss, grid_tv_l2_loss,
                                   segment_consistency_regularizer)
from ..losses.sup_contrastive import sup_contrastive_loss
from ..models.pipeline import BAPipeline, Pipeline
from ..ops.occupancy import OccupancyGrid
from ..ops.raymarch import raymarch
from ..parallel import sharding
from ..utils.lod_annealing import constant_lod_weights, lod_weights
from ..utils.logging_utils import PerfTimer
from .optimizer import MOMENTS, MaskedOptimizer, OptimizerConfig

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX package's trainer settings, same names and defaults (best.yaml)."""

    epochs: int = 800
    batch_size: int = 6
    num_rays_sampled_per_img: int = 4096

    rgb_weight: float = 10.0
    sem_weight: float = 0.1
    sem_epoch_start: int = 601
    sem_conf_enable: bool = False
    sem_temperature: float = 1.0
    sem_softmax: bool = True
    sem_segment_reg_weight: float = 0.0
    contrast_sem_weight: float = 0.0

    inst_loss: str = "linear_assignment_things"
    inst_weight: float = 1000.0
    inst_epoch_start: int = 601
    inst_conf_enable: bool = False
    inst_outlier_rejection: bool = True
    inst_segment_reg_weight: float = 1.0
    inst_temperature: float = 0.07
    base_temperature: float = 0.07
    inst_pn_ratio: float = 0.5

    optimize_extrinsics: bool = True
    extrinsics_epoch_start: int = 0
    extrinsics_epoch_end: int = -1
    optimize_val_extrinsics: bool = True
    val_extrinsics_start: int = 1
    val_extrinsics_end: int = -1
    val_extrinsics_every: int = 10

    prune_every: int = 201
    prune_at_epoch: int = -1
    prune_at_start: bool = False
    prune_samples_per_cell: int = 4
    prune_dilate: int = 1
    prune_monotone: bool = True
    voxel_raymarch_epoch_start: int = 201
    samples_per_voxel: int = 2

    grid_tvl1_reg: float = 0.0
    grid_tvl2_reg: float = 0.0
    delta_grid_tvl1_reg: float = 0.0
    delta_grid_tvl2_reg: float = 0.0
    tv_window_size: float = 0.0001
    tv_edge_num_samples: int = 100

    lod_anneling: bool = False
    lod_annel_epochs: int = 400
    lod_annel_epoch_start: int = 0

    compact_steps_after_prune: int = -1
    packed_compaction: bool = True
    seed_prune_epoch: int = -1
    seed_keep_frac: float = 0.2
    seed_refresh_every: int = 0
    seed_refresh_keep_frac: float = 0.02
    random_lod: bool = False
    micro_batch_imgs: int = 1
    fused_micro_step: bool = False
    dispatch_ahead: int = 4

    valid_every: int = 100
    render_batch: int = 8000
    val_mip: int = 2
    inst_num_dilations: int = 1
    inst_min_mask_px: int = 100
    num_val_frames_to_save: int = 1
    render_val_labels: bool = True
    log_2d: bool = False
    save_preds: bool = False
    save_grid: bool = False
    num_clustering_samples: int = 20000
    low_res_val: bool = False
    seed: int = 0


def snap_microbatch(batch_size: int, micro_batch_imgs: int) -> int:
    """Largest divisor of ``batch_size`` that is <= ``micro_batch_imgs``, so
    microbatches tile the batch exactly."""
    mb = max(1, min(micro_batch_imgs, batch_size))
    while batch_size % mb != 0:
        mb -= 1
    return mb


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """Per-epoch snapshot of what the step does (the JAX package's key of its
    jitted step)."""

    channels: frozenset
    raymarch_type: str
    num_steps: int
    compact_steps: int
    pack_steps: int
    use_sem: bool
    use_inst: bool
    use_inst_segment_reg: bool
    training_val_poses: bool
    extrinsics_on: bool

    @property
    def label(self) -> str:
        """March, layout and heads (``ray_dense_rgb``, ``voxel_packed_panoptic``,
        ...; ``val_pose`` for a val-pose epoch): the stage a ``--perf`` record
        names. "panoptic" renders a semantic or instance channel (the dual
        encode)."""
        if self.training_val_poses:
            return "val_pose"
        layout = "packed" if self.pack_steps else ("compact" if self.compact_steps else "dense")
        heads = ("panoptic" if self.channels & {"semantics", "inst_embedding"} else "rgb")
        return f"{self.raymarch_type}_{layout}_{heads}"


Draw = Callable[[Sequence[int]], torch.Tensor]


class PanopticTrainer:
    """Trainer over a (BA)Pipeline and a MultiviewDataset; the pipeline's
    parameters must require grad and live on the trainer's device.
    ``draw(shape)`` returns float32 uniforms in [0, 1) on that device for
    every random draw of training and pruning (default: the trainer's
    generator); ``draw_normal(shape)`` standard normals for the TV
    windows' vertices (the trainer's generator; a test may replace it)."""

    def __init__(self, pipeline: Pipeline, dataset: MultiviewDataset,
                 cfg: TrainerConfig = TrainerConfig(),
                 opt_cfg: OptimizerConfig = OptimizerConfig(),
                 occ_level: int = 7, draw: Optional[Draw] = None,
                 group: Optional["sharding.RayGroup"] = None):
        self.pipeline = pipeline
        self.dataset = dataset
        self.cfg = cfg
        steps = dataset.steps_per_epoch(cfg.batch_size)
        self.opt_cfg = dataclasses.replace(opt_cfg, num_epochs=cfg.epochs,
                                           steps_per_epoch=steps)
        self.steps_per_epoch = steps
        self.device = pipeline.extrinsics.device if isinstance(
            pipeline, BAPipeline) else next(pipeline.parameters()).device
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.draw = draw or (lambda shape: torch.rand(
            tuple(shape), generator=self.generator, device=self.device))
        self.draw_normal = lambda shape: torch.randn(
            tuple(shape), generator=self.generator, device=self.device)
        self.params = dict(pipeline.named_parameters())
        self.opt = MaskedOptimizer(self.opt_cfg, self.params)
        self.occ = OccupancyGrid.create(level=occ_level, device=self.device)
        nef = pipeline.nef
        self.lod_w = torch.from_numpy(constant_lod_weights(
            nef.grid_cfg.num_lods, nef.grid_cfg.feature_dim)).to(self.device)
        self.epoch = 0
        self.global_step = 0
        # inactive unless the factory turns it on (--perf)
        self.timer = PerfTimer(activate=False)
        self.log_dict: Dict[str, float] = {}
        # set by ``prune``: a prune has run (the packed or compacted layout
        # may follow), a real one has (seed refreshes stop), and the share of
        # occupied cells it left (the JAX package reads 0.25 before any)
        self._pruned = False
        self._real_pruned = False
        self._occ_frac = 0.25
        # ``batch_render``'s chunks of its last call
        self.last_render: List[Dict[str, int]] = []
        # the fused step: one entry per key, and a record of each capture
        # (stage, microbatches, capture ms, launches per replay, replays)
        self._fused: Dict[tuple, "_FusedStep"] = {}
        self.fused_log: List[Dict] = []

        si = dataset.semantic_info
        self.num_classes = si["num_classes"]
        self.num_instances = si["num_instances"]
        self.stuff_ids = tuple(si["stuff_ids"])
        ee = cfg.extrinsics_epoch_end if cfg.extrinsics_epoch_end >= 0 else cfg.epochs
        ve = cfg.val_extrinsics_end if cfg.val_extrinsics_end >= 0 else cfg.epochs
        self._extrinsics_end = ee
        self._val_extrinsics_end = ve
        self.group = None
        # packed layouts whose rank share overflowed its buffer (a group's
        # count, read back and logged at the end of each epoch)
        self.pack_overflows = 0
        if group is not None:
            self.set_group(group)

    def set_group(self, group: "sharding.RayGroup") -> None:
        """Make the trainer rank ``group.rank`` of ``group``: refuse what
        the data-parallel step does not make exact, and give every rank
        rank 0's parameters, occupancy and LoD weights."""
        cfg = self.cfg
        if group.device != self.device:
            raise ValueError(f"rank {group.rank} runs on {group.device}, the pipeline "
                             f"on {self.device}")
        if cfg.contrast_sem_weight > 0.0 or (cfg.inst_loss == "sup_contrastive"
                                             and cfg.inst_weight > 0):
            raise NotImplementedError(
                "sup_contrastive couples every ray pair of an image; under ray-axis "
                "data parallelism it needs an all-gather of the embeddings "
                "(ROADMAP.md Queue 1 item 14)")
        if self.pipeline.tracer_cfg.ray_chunk > 0 and cfg.packed_compaction:
            raise NotImplementedError(
                "a packed layout traced in ray_chunk blocks water-fills per block; "
                "its blocks differ between ranks (ROADMAP.md Queue 1 item 14)")
        sharding.replicate(list(self.params.values()) + [self.occ.occupancy, self.lod_w],
                           group)
        sharding.replicate([self.occ.mask], group)
        self.group = group

    # ------------------------------------------------------------- stages
    def stage_for_epoch(self, epoch: int) -> StageConfig:
        """The JAX package's stage at ``epoch``."""
        cfg = self.cfg
        training_val_poses = (cfg.optimize_val_extrinsics
                              and isinstance(self.pipeline, BAPipeline)
                              and cfg.val_extrinsics_start <= epoch <= self._val_extrinsics_end
                              and epoch % cfg.val_extrinsics_every == 0)
        use_sem = (epoch >= cfg.sem_epoch_start and cfg.sem_weight > 0
                   and "semantics" in self.dataset.data and not training_val_poses)
        use_inst = (epoch >= cfg.inst_epoch_start and epoch >= cfg.sem_epoch_start
                    and cfg.inst_weight > 0 and bool(cfg.inst_loss)
                    and "instance" in self.dataset.data and not training_val_poses)
        channels = {"rgb"}
        if use_sem:
            channels.add("semantics")
        if use_inst:
            channels.add("inst_embedding")
        if cfg.inst_outlier_rejection and use_inst:
            channels.add("depth")
        voxel = epoch > cfg.voxel_raymarch_epoch_start
        base = self.pipeline.tracer_cfg
        if voxel:
            # samples_per_voxel per cell over the ray_max_travel span the
            # voxel march refits into (cells 2 / res wide): 256 at the defaults
            travel = min(base.ray_max_travel, 2.0)
            num_steps = max(1, int(round(cfg.samples_per_voxel * travel * self.occ.res / 2.0)))
        else:
            num_steps = base.num_steps
        compact = pack = 0
        if self._pruned and cfg.packed_compaction:
            # budget per ray: the batch's mean valid count (the occupied
            # share) with a 15% margin, a multiple of 8
            pack = max(8, int(np.ceil(1.15 * self._occ_frac * num_steps / 8.0)) * 8)
            if pack >= num_steps:
                pack = 0             # a dense field: packing would not help
        if pack == 0 and self._pruned and cfg.compact_steps_after_prune != 0:
            if cfg.compact_steps_after_prune > 0:
                compact = cfg.compact_steps_after_prune
            else:
                # twice the occupied share, at least S / 4, a multiple of 16
                want = int(np.ceil(2.0 * self._occ_frac * num_steps / 16.0)) * 16
                compact = min(num_steps, max(num_steps // 4, want))
                if compact >= num_steps:
                    compact = 0
        return StageConfig(
            channels=frozenset(channels),
            raymarch_type="voxel" if voxel else base.raymarch_type,
            num_steps=num_steps,
            compact_steps=compact,
            pack_steps=pack,
            use_sem=use_sem,
            use_inst=use_inst,
            # the JAX package reproduces a reference quirk: the threshold is
            # the WEIGHT, so the reg switches on at epoch > weight
            use_inst_segment_reg=(cfg.inst_segment_reg_weight > 0
                                  and epoch > cfg.inst_segment_reg_weight),
            training_val_poses=training_val_poses,
            extrinsics_on=(cfg.optimize_extrinsics
                           and cfg.extrinsics_epoch_start <= epoch <= self._extrinsics_end),
        )

    # --------------------------------------------------------------- loss
    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch on the trainer's device; on the card through pinned
        host memory and copies that do not wait for the card."""
        return {k: _host_to(np.asarray(v), self.device) for k, v in batch.items()}

    def compute_losses(self, batch: Dict[str, torch.Tensor], stage: StageConfig,
                       jitter=None, normals=None, cam_idx_host=None, lod_w=None):
        """(total, {name: loss}) of one microbatch; ``jitter`` is a [B*R, S]
        tensor of uniforms or a generator (the JAX package's ``key``);
        ``normals`` the TV windows' (grid, delta grid) normals (drawn here
        when None); ``cam_idx_host`` the batch's numpy cameras (the anchor
        check); ``lod_w`` replaces ``self.lod_w``."""
        cfg = self.cfg
        lod_w = self.lod_w if lod_w is None else lod_w
        if normals is None:
            normals = self._draw_normals()
        tracer_cfg = dataclasses.replace(self.pipeline.tracer_cfg,
                                         raymarch_type=stage.raymarch_type,
                                         num_steps=stage.num_steps,
                                         compact_steps=stage.compact_steps,
                                         pack_steps=stage.pack_steps)
        b, r = batch["imgs"].shape[:2]
        base_rays = Rays(origins=batch["base_rays_origins"],
                         dirs=batch["base_rays_dirs"], dist_min=0.0, dist_max=6.0)
        cam_idx = batch["cam_idx"].to(torch.int64)
        is_ba = isinstance(self.pipeline, BAPipeline)
        if is_ba:
            rb = self.pipeline(base_rays, stage.channels, self.occ, lod_w,
                               stage="train", cam_idx=cam_idx, jitter=jitter,
                               tracer_cfg=tracer_cfg, cam_idx_host=cam_idx_host,
                               group=self.group)
        else:
            # a pipeline without extrinsics traces the batch's world rays
            rays_in = Rays(origins=batch["rays_origins"].reshape(-1, 3),
                           dirs=batch["rays_dirs"].reshape(-1, 3), dist_min=0.0,
                           dist_max=6.0)
            rb = self.pipeline(rays_in, stage.channels, self.occ, lod_w,
                               stage="train", jitter=jitter, tracer_cfg=tracer_cfg,
                               group=self.group)

        # under a group each term is this rank's share: a mean over its
        # rays / world, a sum over them / a global count, ray-free terms / world
        group = self.group
        share = 1.0 / group.world if group is not None else 1.0
        losses: Dict[str, torch.Tensor] = {}
        total = 0.0
        if rb.ray_sparsity_loss is not None:
            sloss = rb.ray_sparsity_loss * share
            total = total + sloss
            losses["ray_sparsity_loss"] = sloss

        if cfg.rgb_weight > 0.0:
            rloss = rgb_l1_loss(rb.rgb, batch["imgs"].reshape(-1, 3)) * share
            total = total + cfg.rgb_weight * rloss
            losses["rgb_loss"] = rloss

        if stage.use_sem:
            sem_gts = batch.get("semantics_pred", batch["semantics"]).reshape(-1)
            conf = batch["sem_conf"].reshape(-1) if (
                cfg.sem_conf_enable and "sem_conf" in batch) else None
            sloss = semantic_loss(rb.semantics, sem_gts, cfg.sem_softmax,
                                  cfg.sem_temperature, conf, group)
            if cfg.sem_segment_reg_weight > 0.0:
                sloss = sloss + cfg.sem_segment_reg_weight * \
                    segment_consistency_regularizer(
                        (rb.semantics + 1e-27).reshape(b, r, -1),
                        sem_gts.reshape(b, r), self.num_classes, group)
            total = total + cfg.sem_weight * sloss
            losses["sem_loss"] = sloss
            if cfg.contrast_sem_weight > 0.0:
                closs = sup_contrastive_loss(
                    (rb.semantics + 1e-27).reshape(b, r, -1), sem_gts.reshape(b, r),
                    temperature=cfg.inst_temperature,
                    base_temperature=cfg.base_temperature, pn_ratio=cfg.inst_pn_ratio)
                total = total + cfg.contrast_sem_weight * closs
                losses["contrast_sem_loss"] = closs

        if stage.use_inst:
            inst_gts = batch.get("instance_pred", batch["instance"]).reshape(b, r)
            sem_gts = batch.get("semantics_pred", batch["semantics"]).reshape(b, r)
            inst_embed = rb.inst_embedding.reshape(b, r, -1)
            stuff = torch.isin(sem_gts, constant(self.stuff_ids, sem_gts.dtype, sem_gts.device))
            if cfg.inst_loss == "sup_contrastive":
                undetected = ~stuff & (inst_gts == 0)
                iloss = sup_contrastive_loss(
                    inst_embed, inst_gts, anchor_mask=~undetected,
                    temperature=cfg.inst_temperature,
                    base_temperature=cfg.base_temperature, pn_ratio=cfg.inst_pn_ratio)
            elif cfg.inst_loss == "linear_assignment":
                iloss = lin_assignment_loss(inst_embed, inst_gts, self.num_instances, group)
            elif cfg.inst_loss == "linear_assignment_things":
                points_3d = None
                if cfg.inst_outlier_rejection:
                    with torch.no_grad():
                        world = (self.pipeline.transform_rays(base_rays, cam_idx,
                                                              cam_idx_host)
                                 if is_ba else rays_in)
                        points_3d = rays_to_3d_points(world, rb.depth).reshape(b, r, 3)
                lmap = lin_assignment_things_loss(
                    inst_embed, inst_gts, stuff, self.num_instances,
                    points_3d=points_3d, outlier_rejection=cfg.inst_outlier_rejection,
                    group=group)
                if group is not None:
                    iloss = self._things_share(lmap, stage, batch, inst_embed, inst_gts)
                else:
                    if stage.use_inst_segment_reg:
                        lmap = lmap + cfg.inst_segment_reg_weight * \
                            segment_consistency_regularizer(
                                inst_embed + 1e-27, inst_gts, self.num_instances)
                    if cfg.inst_conf_enable and "inst_conf" in batch:
                        lmap = lmap * batch["inst_conf"].reshape(b, r)
                    iloss = lmap.mean()
            else:
                raise ValueError(f"instance loss '{cfg.inst_loss}' not supported")
            total = total + cfg.inst_weight * iloss
            losses["inst_loss"] = iloss

        nef = self.pipeline.nef
        tv = dict(sample_size=cfg.tv_window_size, num_dim_samples=cfg.tv_edge_num_samples)
        if cfg.grid_tvl1_reg > 0.0 or cfg.grid_tvl2_reg > 0.0:
            def grid_enc(c):
                return nef._grid_feats(nef.grid, c, None)
            normal = normals[0]
            if cfg.grid_tvl1_reg > 0.0:
                total = total + cfg.grid_tvl1_reg * share * \
                    grid_tv_l1_loss(grid_enc, normal, **tv)
            if cfg.grid_tvl2_reg > 0.0:
                total = total + cfg.grid_tvl2_reg * share * \
                    grid_tv_l2_loss(grid_enc, normal, **tv)
        if cfg.delta_grid_tvl1_reg > 0.0 or cfg.delta_grid_tvl2_reg > 0.0:
            def inst_enc(c):
                return nef(c, None, frozenset({"inst_embedding"}))["inst_embedding"]
            # the reference's delta-grid L2 branch calls its L1 loss too, so
            # both weights feed one L1 term
            total = total + (cfg.delta_grid_tvl1_reg + cfg.delta_grid_tvl2_reg) * share * \
                grid_tv_l1_loss(inst_enc, normals[1], **tv)

        losses["total_loss"] = total
        return total, losses

    def _things_share(self, lmap, stage, batch, inst_embed, inst_gts) -> torch.Tensor:
        """This rank's share of the 'things' instance loss mean((lmap + w *
        reg) * conf) over the global rays: sum(lmap * conf) / N + w * reg *
        mean(conf), the regulariser and mean(conf) being global (the
        regulariser as this rank's share)."""
        cfg, group = self.cfg, self.group
        b, r = lmap.shape
        n = b * r * group.world
        conf = (batch["inst_conf"].reshape(b, r) if cfg.inst_conf_enable
                and "inst_conf" in batch else None)
        iloss = (lmap if conf is None else lmap * conf).sum() / n
        if stage.use_inst_segment_reg:
            reg = segment_consistency_regularizer(inst_embed + 1e-27, inst_gts,
                                                  self.num_instances, group)
            if conf is not None:
                reg = reg * (sharding.all_reduce(conf.sum().reshape(1), group,
                                                 "inst_conf")[0] / n)
            iloss = iloss + cfg.inst_segment_reg_weight * reg
        return iloss

    def _read_pack_overflows(self, epoch: int) -> None:
        """Read the group's overflow count back (the epoch's readback) and
        log the packed layouts whose rank share overflowed its buffer this
        epoch: their rays were cut unlike the single-process step's."""
        count = int(self.group.pack_overflows)
        if count > self.pack_overflows:
            log.warning("epoch %d, rank %d: %d packed layout(s) overflowed the rank's "
                        "buffer of %.2f x B / %d and cut rays unlike one process (%d "
                        "so far); raise parallel.sharding.PACK_SHARE_MARGIN",
                        epoch, self.group.rank, count - self.pack_overflows,
                        sharding.PACK_SHARE_MARGIN, self.group.world, count)
        self.pack_overflows = count

    # ---------------------------------------------------------- train step
    def frozen_fn(self, stage: StageConfig):
        def frozen(name: str) -> bool:
            if stage.training_val_poses:
                return not name.startswith("extrinsics")
            if name.startswith("extrinsics"):
                return not stage.extrinsics_on
            return False
        return frozen

    def _micro_batches(self, batch: Dict[str, np.ndarray]):
        b = batch["imgs"].shape[0]
        mb = snap_microbatch(b, self.cfg.micro_batch_imgs or b)
        subs = []
        for m in range(b // mb):
            sl = slice(m * mb, (m + 1) * mb)
            subs.append({k: v[sl] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == b
                         else v for k, v in batch.items()})
        return subs

    def _draw_normals(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The TV windows' vertex normals of one microbatch, in the order
        ``compute_losses`` uses them: the grid's, then the delta grid's
        (None where that TV is off)."""
        cfg = self.cfg
        grid = (self.draw_normal((3,)) if cfg.grid_tvl1_reg > 0.0 or cfg.grid_tvl2_reg > 0.0
                else None)
        delta = (self.draw_normal((3,)) if cfg.delta_grid_tvl1_reg > 0.0
                 or cfg.delta_grid_tvl2_reg > 0.0 else None)
        return grid, delta

    def _shard(self, batch: Dict[str, np.ndarray]):
        """(the rank's share of ``batch``, that share or None): without a
        group the batch itself; a ``ShardedBatch`` is a share already."""
        if self.group is None:
            return batch, None
        if not isinstance(batch, sharding.ShardedBatch):
            batch = sharding.shard_ray_batch(batch, self.group)
        return batch, batch

    def _draws(self, stage: StageConfig, subs: List[Dict[str, np.ndarray]],
               jitters: Optional[List], sbatch=None) -> List[Tuple]:
        """Each microbatch's (jitter, normals), drawn in the host loop's
        order: the microbatch's [rays, steps] uniforms (unless ``jitters``
        gives them), then its TV normals. Under a group (``sbatch`` the
        rank's share) the uniforms are the global microbatch's [rays, steps]
        and the rank keeps its rays' rows."""
        out = []
        for m, sub in enumerate(subs):
            if jitters is None:
                rays = sub["imgs"].shape[1] if sbatch is None else sbatch.ray_len_global
                jitter = self.draw((sub["imgs"].shape[0] * rays, stage.num_steps))
            else:
                jitter = jitters[m]
            if sbatch is not None:
                jitter = sharding.local_rows(torch.as_tensor(jitter), sbatch)
            out.append((jitter, self._draw_normals()))
        return out

    def _global_losses(self, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The ranks' loss shares summed into the global losses (one
        collective); the losses themselves without a group."""
        if self.group is None:
            return losses
        names = sorted(losses)
        flat = sharding.all_reduce(torch.stack([losses[k].float() for k in names]),
                                   self.group, "losses")
        return dict(zip(names, flat.unbind()))

    def _backward(self, sub: Dict[str, np.ndarray], stage: StageConfig, jitter):
        """Forward + backward of one microbatch; gradients add into .grad.
        Without ``jitter`` the microbatch's [rays, steps] uniforms are drawn."""
        sub, sbatch = self._shard(sub)
        (jitter, normals), = self._draws(stage, [sub], None if jitter is None else [jitter],
                                         sbatch)
        total, losses = self.compute_losses(self._to_device(sub), stage, jitter, normals,
                                            sub.get("cam_idx"))
        total.backward()
        return self._global_losses({k: v.detach() for k, v in losses.items()})

    def grad_step(self, stage: StageConfig, sub: Dict[str, np.ndarray],
                  jitter=None):
        """One microbatch's (gradients by parameter name, losses): the JAX
        package's ``grad_step``. A parameter the losses do not reach has a
        zero gradient. Under a group, of the global microbatch: the
        gradients and losses summed over the ranks."""
        for p in self.params.values():
            p.grad = None
        losses = self._backward(sub, stage, jitter)
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                 for n, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        if self.group is not None:
            grads = dict(zip(grads, sharding.all_reduce_coalesced(list(grads.values()),
                                                                  self.group, "grad")))
        return grads, losses

    def _step_body(self, stage: StageConfig, subs: List[Dict[str, torch.Tensor]],
                   draws: List[Tuple], cams: List[np.ndarray],
                   lod_w: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The step's device work: each microbatch's forward and backward
        (gradients add into .grad in microbatch order), the summed gradients
        scaled by ``1 / num_micro``, the masked update. Returns the losses
        summed over the microbatches. Reads nothing back from the device.
        Under a group the gradients are summed over the ranks (in buckets,
        once) before the update, and the losses are the global ones."""
        num_micro = len(subs)
        for p in self.params.values():
            p.grad = None
        acc_l = None
        for sub, (jitter, normals), cams_m in zip(subs, draws, cams):
            total, losses = self.compute_losses(sub, stage, jitter, normals, cams_m, lod_w)
            total.backward()
            losses = {k: v.detach() for k, v in losses.items()}
            acc_l = losses if acc_l is None else {k: acc_l[k] + v
                                                  for k, v in losses.items()}
        grads = {n: p.grad for n, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        if self.group is not None:
            live = [n for n, g in grads.items() if g is not None]
            grads.update(zip(live, sharding.all_reduce_coalesced(
                [grads[n] for n in live], self.group, "grad")))
            acc_l = self._global_losses(acc_l)
        grads = {n: None if g is None else g * (1.0 / num_micro) for n, g in grads.items()}
        self.opt.update(grads, self.frozen_fn(stage), self.opt_cfg.clip_grad_norm)
        return acc_l

    def _fused_step_enabled(self) -> bool:
        """``fused_micro_step``, or the ``PAGNERF_FUSED_STEP`` environment
        variable where set (true for 1, true, yes, on, y in any case; false
        otherwise), as the JAX package reads it."""
        env = os.environ.get("PAGNERF_FUSED_STEP")
        if env is not None:
            return env.strip().lower() in ("1", "true", "yes", "on", "y")
        return self.cfg.fused_micro_step

    def train_step(self, stage: StageConfig, batch: Dict[str, np.ndarray],
                   jitters: Optional[List] = None) -> Dict[str, torch.Tensor]:
        """One optimisation step with image-axis gradient accumulation; returns
        the losses averaged over the microbatches (device tensors). ``jitters``
        (one [R, S] tensor per microbatch) replaces the generator's draws.
        With the fused step enabled, ``fused_train_step``."""
        if self._fused_step_enabled():
            return self.fused_train_step(stage, batch, jitters)
        batch, sbatch = self._shard(batch)
        subs = self._micro_batches(batch)
        draws = self._draws(stage, subs, jitters, sbatch)
        acc_l = self._step_body(stage, [self._to_device(sub) for sub in subs], draws,
                                [sub.get("cam_idx") for sub in subs], self.lod_w)
        self.global_step += 1
        return {k: v / len(subs) for k, v in acc_l.items()}

    def fused_train_step(self, stage: StageConfig, batch: Dict[str, np.ndarray],
                         jitters: Optional[List] = None) -> Dict[str, torch.Tensor]:
        """The step as one unit over static buffers (the JAX package's
        ``fused_step``): the batch, the draws and ``lod_w`` are copied into
        the key's buffers, then the step runs (``_FusedStep.run``: on the
        card eagerly at the key's first step, captured into a CUDA graph at
        its second, replayed after; on the CPU eagerly). A key's buffers and
        graph are dropped when a tensor they read was replaced: a prune's
        occupancy, new moments, grown tables, a restored optimizer. The
        same bits as ``train_step``'s host loop. Under a group on the card
        the graph holds the NCCL collectives; gloo's cannot be captured, and
        the fused step refuses it there."""
        group = self.group
        if group is not None and self.device.type == "cuda" and not group.capturable:
            raise RuntimeError(
                f"the fused step captures the step's collectives into a CUDA graph, and "
                f"{group.backend} collectives cannot be captured: use NCCL (one rank per "
                f"card) or the host loop")
        batch, sbatch = self._shard(batch)
        subs = self._micro_batches(batch)
        draws = self._draws(stage, subs, jitters, sbatch)
        cams = [sub.get("cam_idx") for sub in subs]
        anchors = tuple(self._all_anchor(c) for c in cams)
        key = (stage, len(subs), anchors, _signature(batch),
               tuple(tuple(x is not None for x in n) for _, n in draws))
        entry, state = self._fused_entry(key)
        if entry is not None and self.device.type == "cuda":
            # the update of its capture or replay reserves no count
            # (``MaskedOptimizer.update``); a table this grows is a new
            # tensor, and the key starts again (its eager step reserves once
            # more: the bound stays an upper bound)
            self.opt.reserve_update()
            entry, state = self._fused_entry(key)
        if entry is None:
            entry = self._fused[key] = _FusedStep(self, stage, batch, draws, cams, state)
        entry.load(batch, draws, self.lod_w)
        acc_l = entry.run()
        self.global_step += 1
        return {k: v / len(subs) for k, v in acc_l.items()}

    def _fused_entry(self, key: tuple):
        """(the key's ``_FusedStep`` or None, the graph state), the entries
        of another state dropped first (which frees their graphs' pools)."""
        state = self._graph_state()
        for k in [k for k, e in self._fused.items() if e.state != state]:
            del self._fused[k]
        return self._fused.get(key), state

    def _all_anchor(self, cams) -> bool:
        anchor = getattr(self.pipeline, "anchor_host", None)
        return bool(cams is not None and anchor is not None
                    and anchor[np.asarray(cams).astype(np.int64)].all())

    def _graph_state(self) -> tuple:
        """What a captured step read by address: the parameters, the
        optimizer's moments, counts and tables, the occupancy grid. A change
        here (a new tensor, not new values) makes a capture stale."""
        opt = self.opt
        ts = list(self.params.values()) + [opt.counts, opt.lr_table, self.occ.mask,
                                           self.occ.occupancy]
        if opt.bc_table is not None:
            ts.append(opt.bc_table)
        for key in MOMENTS[opt.cfg.optimizer_type]:
            ts += list(getattr(opt, key).values())
        return (id(opt), id(self.occ)) + tuple(t.data_ptr() for t in ts)

    # -------------------------------------------------------------- prune
    @torch.no_grad()
    def prune(self, chunk: int = 65536, seed: bool = False,
              keep_frac: Optional[float] = None, refresh: bool = False) -> None:
        """Occupancy maintenance (the JAX package's ``prune``): each cell's
        density is the max over ``prune_samples_per_cell`` jittered points
        (one ``draw`` of [3, res^3] each), queried in chunks of ``chunk``
        points; the occupancy is updated from it (decay, threshold, AND with
        the current mask when ``prune_monotone``, ``prune_dilate`` dilations).

        ``seed=True`` is the conservative early variant: one more dilation,
        a keep floor of the ``keep_frac`` (default ``seed_keep_frac``)
        densest cells when fewer are occupied, and no optimizer reset. The
        floor repeats the JAX package's dtypes: a float64 numpy quantile of
        the occupancy, one float64 step down, then the float32 comparison.
        ``refresh=True`` (a seed refresh) does not dilate. A real prune
        resets the Adam moments and keeps the counts."""
        t0 = time.perf_counter()
        cfg = self.cfg
        res3 = self.occ.res ** 3
        density = None
        for _ in range(max(1, cfg.prune_samples_per_cell)):
            centersT = self.occ.cell_centers_jittered_T(self.draw((3, res3)))
            d = torch.cat([self.pipeline.query_density(centersT[:, i:i + chunk], self.lod_w)
                           for i in range(0, res3, chunk)])
            density = d if density is None else torch.maximum(density, d)
        dilate = 0 if refresh else cfg.prune_dilate + (1 if seed else 0)
        new_occ = self.occ.update_from_density(density, dilate=dilate,
                                               monotone=cfg.prune_monotone)
        if seed:
            frac = float(new_occ.mask.float().mean())
            keep = float(keep_frac if keep_frac is not None else cfg.seed_keep_frac)
            if frac < keep:
                thr = float(np.quantile(new_occ.occupancy.cpu().numpy(), 1.0 - keep))
                thr = float(np.nextafter(thr, -np.inf))
                new_occ = new_occ.update_from_density(new_occ.occupancy, decay=1.0,
                                                      min_density=thr, dilate=dilate)
        if self.group is not None:
            sharding.assert_replicated([new_occ.mask, new_occ.occupancy], self.group,
                                       "prune_checksum")
        self.occ = new_occ
        self._pruned = True
        self._occ_frac = float(self.occ.mask.float().mean())
        if not seed:
            self.opt.reset_moments()
            self._real_pruned = True
        self.timer.record("prune", time.perf_counter() - t0, epoch=self.epoch, seed=seed,
                          refresh=refresh, kept_share=self._occ_frac)

    # -------------------------------------------------------------- epochs
    def should_prune(self, epoch: int) -> bool:
        cfg = self.cfg
        return ((cfg.prune_every > 0 and epoch > 0 and epoch % cfg.prune_every == 0)
                or epoch == cfg.prune_at_epoch
                or (cfg.prune_at_start and epoch == 0))

    def maybe_seed_prune(self, epoch: int) -> None:
        """The seed prune at ``seed_prune_epoch``, then a seed refresh every
        ``seed_refresh_every`` epochs until the real prune has run."""
        cfg = self.cfg
        if cfg.seed_prune_epoch < 0:
            return
        if epoch >= cfg.seed_prune_epoch and not self._pruned:
            self.prune(seed=True)
        elif (cfg.seed_refresh_every > 0 and self._pruned and not self._real_pruned
              and epoch > cfg.seed_prune_epoch
              and (epoch - cfg.seed_prune_epoch) % cfg.seed_refresh_every == 0):
            self.prune(seed=True, keep_frac=cfg.seed_refresh_keep_frac, refresh=True)

    def run_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch: the seed prune if due, the LoD annealing weights at
        the global step (from ``lod_annel_epoch_start``, over
        ``lod_annel_epochs``), ``steps_per_epoch`` steps of the epoch's stage
        (a val-pose stage samples the 'val' split; with ``random_lod`` each
        step first draws the levels it keeps), then the prune if due.
        Returns the epoch's mean losses. Up to ``dispatch_ahead`` steps'
        loss dicts stay on the device; the oldest is read back when one more
        is queued (0: each step's as it ends), so the host samples and
        dispatches the next steps while the card runs; the totals add the
        steps in order whatever the depth. The timer's ``train_step`` is the
        step's dispatch plus the amortised readback."""
        t0 = time.perf_counter()
        cfg = self.cfg
        self.maybe_seed_prune(epoch)
        stage = self.stage_for_epoch(epoch)
        grid = self.pipeline.nef.grid_cfg
        if cfg.lod_anneling and epoch >= cfg.lod_annel_epoch_start:
            self.lod_w = _host_to(lod_weights(
                self.global_step, grid.num_lods, grid.feature_dim,
                cfg.lod_annel_epochs, self.steps_per_epoch), self.device)
        split = "val" if stage.training_val_poses else "train"
        totals: Dict[str, float] = {}
        pending: List[Dict[str, torch.Tensor]] = []

        def drain(losses: Dict[str, torch.Tensor]) -> None:
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + float(v)

        for _ in range(self.steps_per_epoch):
            if cfg.random_lod:
                cut = int(self.rng.integers(1, grid.num_lods + 1))
                w = np.zeros(grid.num_lods, np.float32)
                w[:cut] = 1.0
                self.lod_w = _host_to(np.repeat(w, grid.feature_dim), self.device)
            self.timer.reset()
            batch = self.dataset.sample_batch(self.rng, cfg.batch_size,
                                              cfg.num_rays_sampled_per_img, split)
            self.timer.check("data_sample")
            pending.append(self.train_step(stage, batch))
            while len(pending) > max(cfg.dispatch_ahead, 0):
                drain(pending.pop(0))
            self.timer.check("train_step", epoch=epoch, stage=stage.label,
                             channels=sorted(stage.channels), pack_steps=stage.pack_steps,
                             rays=cfg.num_rays_sampled_per_img,
                             cam_idx=batch["cam_idx"].tolist())
        for losses in pending:
            drain(losses)
        if self.group is not None:
            self._read_pack_overflows(epoch)
        totals = {k: v / self.steps_per_epoch for k, v in totals.items()}
        if self.should_prune(epoch):
            self.prune()
        self.maybe_upsample_tensorf(epoch)
        self.epoch = epoch + 1
        self.log_dict = totals
        self.timer.record("epoch", time.perf_counter() - t0, epoch=epoch, losses=totals)
        return totals

    def maybe_upsample_tensorf(self, epoch: int) -> None:
        """The JAX trainer's progressive TensoRF resolution steps: when the
        NeF's grid config says ``TensoRF`` (only then: a PanopticLiftingNeF
        whose config names another grid type builds a TensoRF grid that never
        upsamples, as in the JAX package), every ``epochs //
        num_resolutions`` epochs (from epoch 1) the VM factors are resized
        to the next resolution of ``resolution_schedule`` above the current
        one, and the optimizer's moments restart at zero with each group's
        count kept (its ``_reinit_opt_state``)."""
        nef = self.pipeline.nef
        gc = nef.grid_cfg
        if gc.grid_type != "TensoRF" or gc.num_resolutions <= 1:
            return
        every = max(self.cfg.epochs // gc.num_resolutions, 1)
        if epoch <= 0 or epoch % every != 0:
            return
        from ..models.tensorf import resolution_schedule
        bigger = [r for r in resolution_schedule(gc.resolution, gc.max_resolution,
                                                 gc.num_resolutions)
                  if r > nef.grid.resolution]
        if not bigger:
            return
        nef.grid.upsample(bigger[0])
        nef.grid_cfg = dataclasses.replace(gc, resolution=bigger[0])
        self.params = dict(self.pipeline.named_parameters())
        self.opt.params = dict(self.params)
        self.opt.reset_moments()

    def train(self, on_epoch_end=None) -> None:
        """``run_epoch`` from the current epoch to ``cfg.epochs``;
        ``on_epoch_end(epoch, losses)`` after each."""
        for epoch in range(self.epoch, self.cfg.epochs):
            totals = self.run_epoch(epoch)
            if on_epoch_end is not None:
                on_epoch_end(epoch, totals)

    # ----------------------------------------------------------- rendering
    @torch.no_grad()
    def batch_render(self, rays: Rays, channels, cam_idx: Optional[int] = None,
                     stage_cfg: Optional[StageConfig] = None) -> RenderBuffer:
        """Render ``rays`` (any shape; the result is per ray, flattened) in
        chunks of ``cfg.render_batch`` rays: the JAX package's
        ``batch_render``. It runs under ``no_grad``, so the encode keeps no
        idx/bary/rank and autograd keeps no graph.

        The march, ``num_steps``, ``compact_steps`` and ``pack_steps`` are
        those of the current stage (of epoch ``self.epoch - 1``) unless
        ``stage_cfg`` is given. A BA pipeline with a ``cam_idx`` first moves
        the camera-space rays through that camera's extrinsics. In a packed
        stage a count-only march of each chunk picks the smallest doubling
        of ``pack_steps`` whose buffer holds every valid sample of the
        chunk, so water-filling keeps them all; a chunk whose budget would
        reach ``num_steps`` renders dense. No chunk truncates.

        The JAX package pads the rays to a multiple of ``render_batch``,
        because its jitted chunk needs a static shape, and sizes a chunk's
        budget over the padded rays. The port renders the last chunk at its
        own length and sizes each budget over the chunk's real rays. Since no
        chunk truncates, the outputs on the real rays agree either way, up to
        the rounding of the packed sums. ``last_render`` lists the chunks:
        their ``rays``, ``valid`` samples (packed stages), ``pack_steps`` (0:
        dense) and the ``samples`` the field was evaluated at."""
        if stage_cfg is None:
            stage_cfg = self.stage_for_epoch(max(self.epoch - 1, 0))
        cfg = dataclasses.replace(self.pipeline.tracer_cfg,
                                  raymarch_type=stage_cfg.raymarch_type,
                                  num_steps=stage_cfg.num_steps,
                                  compact_steps=stage_cfg.compact_steps,
                                  pack_steps=stage_cfg.pack_steps)
        flat = Rays(origins=rays.origins.to(self.device, torch.float32),
                    dirs=rays.dirs.to(self.device, torch.float32),
                    dist_min=rays.dist_min, dist_max=rays.dist_max).reshape(-1)
        if isinstance(self.pipeline, BAPipeline) and cam_idx is not None:
            flat = self.pipeline.transform_rays(
                flat.reshape(1, -1), torch.tensor([cam_idx], device=self.device))
        n, rbatch = flat.origins.shape[0], self.cfg.render_batch
        outs, self.last_render = [], []
        for i in range(0, n, rbatch):
            chunk = Rays(origins=flat.origins[i:i + rbatch], dirs=flat.dirs[i:i + rbatch],
                         dist_min=0.0, dist_max=6.0)
            m = chunk.origins.shape[0]
            chunk_cfg, info = cfg, {"rays": m}
            if cfg.pack_steps:
                # the march of the packed trace, midpoint samples
                valid = int(raymarch(chunk, self.occ, cfg.num_steps, cfg.raymarch_type,
                                     None, cfg.ray_max_travel).mask.sum())
                p = cfg.pack_steps
                while p < cfg.num_steps and p * m < valid:
                    p *= 2
                if p >= cfg.num_steps:
                    p = 0                    # the budget reached the dense size
                chunk_cfg = dataclasses.replace(cfg, pack_steps=p)
                info["valid"] = valid
            info["pack_steps"] = chunk_cfg.pack_steps
            info["samples"] = m * (chunk_cfg.pack_steps or chunk_cfg.compact_steps
                                   or chunk_cfg.num_steps)
            self.last_render.append(info)
            outs.append(self.pipeline(chunk, channels, self.occ, self.lod_w,
                                      stage="val", tracer_cfg=chunk_cfg))
        return RenderBuffer.concatenate(outs)


def _pinned(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a host tensor to copy to ``device``: pinned for the
    card, so the copy need not wait for it (the caching host allocator keeps
    the pinned block until the copy has run)."""
    t = torch.as_tensor(arr)
    return t.pin_memory() if device.type == "cuda" else t


def _host_to(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device``, the copy not waiting for the card."""
    return _pinned(arr, device).to(device, non_blocking=True)


def _signature(batch: Dict[str, np.ndarray]) -> tuple:
    return tuple(sorted((k, np.shape(v), np.asarray(v).dtype.str) for k, v in batch.items()))


class _FusedStep:
    """One key's fused step: static buffers for its inputs, on the card its
    CUDA graph, and its ``record`` in the trainer's ``fused_log`` (stage,
    microbatches, steps, capture ms, replays)."""

    def __init__(self, trainer: PanopticTrainer, stage: StageConfig,
                 batch: Dict[str, np.ndarray], draws: List[Tuple], cams: List,
                 state: tuple):
        dev = trainer.device
        self.trainer, self.stage, self.cams, self.state = trainer, stage, cams, state
        self.batch = {k: torch.empty(np.shape(v), dtype=torch.as_tensor(np.asarray(v)).dtype,
                                     device=dev) for k, v in batch.items()}
        self.subs = trainer._micro_batches(self.batch)
        self.jitters = [torch.empty(tuple(j.shape), dtype=torch.float32, device=dev)
                        for j, _ in draws]
        self.normals = [tuple(None if x is None else torch.empty(3, device=dev) for x in n)
                        for _, n in draws]
        self.lod_w = torch.empty_like(trainer.lod_w, device=dev)
        self.graph = self.out = None
        self.record = {"stage": stage.label, "micro": len(self.subs),
                       "all_anchor": [trainer._all_anchor(c) for c in cams],
                       "channels": sorted(stage.channels), "use_inst": stage.use_inst,
                       "steps": 0, "capture_ms": None, "replays": 0}
        trainer.fused_log.append(self.record)

    @torch.no_grad()
    def load(self, batch: Dict[str, np.ndarray], draws: List[Tuple],
             lod_w: torch.Tensor) -> None:
        """Copy a step's inputs into the buffers (on the card, in stream
        order after the previous replay that read them)."""
        for k, v in batch.items():
            self.batch[k].copy_(_pinned(np.asarray(v), self.batch[k].device),
                                non_blocking=True)
        for buf, (jitter, normals) in zip(self.jitters, draws):
            buf.copy_(torch.as_tensor(jitter), non_blocking=True)
        for bufs, (_, normals) in zip(self.normals, draws):
            for buf, x in zip(bufs, normals):
                if buf is not None:
                    buf.copy_(x, non_blocking=True)
        self.lod_w.copy_(lod_w, non_blocking=True)

    def body(self) -> Dict[str, torch.Tensor]:
        return self.trainer._step_body(self.stage, self.subs,
                                       list(zip(self.jitters, self.normals)), self.cams,
                                       self.lod_w)

    def run(self) -> Dict[str, torch.Tensor]:
        """The step on the buffers. On the CPU the body. On the card: at the
        key's first step the body on a side stream under
        ``set_sync_debug_mode("error")``, which raises on any host read (the
        warm-up a capture needs, and a real step); at its second the capture
        of the body, then its replay; after that replays."""
        t = self.trainer
        self.record["steps"] += 1
        if t.device.type != "cuda":
            return self.body()
        dev = t.device
        params = list(t.params.values())
        if self.record["steps"] == 1:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = self.body()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.current_stream(dev).wait_stream(side)
            return out
        if self.graph is None:
            t0 = time.perf_counter()
            # the capture must not read what host code derived from the
            # parameters before it (the dual encode's packed copy)
            _bump_versions(params)
            graph = torch.cuda.CUDAGraph()
            # under a group NCCL's watchdog thread queries its events while
            # this thread captures: only this thread's calls may fail it
            mode = "global" if t.group is None else "thread_local"
            with torch.cuda.graph(graph, capture_error_mode=mode):
                self.out = self.body()
            torch.cuda.synchronize(dev)
            self.graph = graph
            self.record["capture_ms"] = (time.perf_counter() - t0) * 1e3
        self.graph.replay()
        # the replay wrote the parameters in place, as ``update`` does
        _bump_versions(params)
        self.record["replays"] += 1
        return self.out


def _bump_versions(tensors) -> None:
    """Move the version counters of ``tensors``, as an in-place write does."""
    for x in tensors:
        torch.autograd.graph.increment_version(x)