"""The reference's training step: each image microbatch's losses through one
forward and one backward in float32, the gradients summed in microbatch
order and scaled by 1 / microbatches, then one masked Adam update (per-group
rates, frozen groups left alone). Plain PyTorch; the encodes' gradients are
autograd's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..core.camera import rays_to_3d_points
from ..core.rays import Rays
from ..losses.lin_assignment import lin_assignment_loss, lin_assignment_things_loss
from ..losses.photometric import rgb_l1_loss, semantic_loss
from ..losses.regularizers import segment_consistency_regularizer
from ..losses.sup_contrastive import sup_contrastive_loss
from ..models.pipeline import BAPipeline
from ..models.tracer import TracerConfig

B1, B2 = 0.9, 0.999


def group_of(name: str) -> str:
    """A parameter's optimizer group, by the reference's name matches."""
    if name.startswith("extrinsics"):
        return "extrinsics"
    for key in ("decoder", "inst", "sem", "delta_grid", "grid"):
        if key in name:
            return key
    return "rest"


def group_lr(s: Dict, group: str) -> float:
    if group == "grid":
        return s["lr"] * s["grid_lr_weight"]
    if group == "delta_grid":
        return s["lr"] * s["delta_grid_lr_weight"]
    if group == "extrinsics":
        return s["extrinsics_lr"] if s["extrinsics_lr"] >= 0 else s["lr"]
    return s["lr"]


def _check_supported(s: Dict) -> None:
    for key in ("grid_tvl1_reg", "grid_tvl2_reg", "delta_grid_tvl1_reg", "delta_grid_tvl2_reg",
                "contrast_sem_weight", "sem_segment_reg_weight", "weight_decay",
                "clip_grad_norm"):
        if s[key]:
            raise NotImplementedError(f"{key} is not part of the reference")
    if s["optimizer_type"] != "adam" or s["use_lr_scheduler"] or s["sem_conf_enable"] \
            or s["inst_conf_enable"]:
        raise NotImplementedError("the reference runs Adam at constant rates, no confidences")


def compute_losses(pipe, batch: Dict[str, torch.Tensor], stage: Dict, s: Dict,
                   jitter: torch.Tensor, occ, semantic_info: Dict):
    """(total, {name: loss}) of one microbatch."""
    tcfg: TracerConfig = pipe.tracer_cfg.__class__(**{
        **pipe.tracer_cfg.__dict__, "raymarch_type": stage["raymarch_type"],
        "num_steps": stage["num_steps"], "compact_steps": 0,
        "pack_steps": stage["pack_steps"]})
    b, r = batch["imgs"].shape[:2]
    base = Rays(origins=batch["base_rays_origins"], dirs=batch["base_rays_dirs"],
                dist_min=0.0, dist_max=6.0)
    cam = batch["cam_idx"].to(torch.int64)
    is_ba = isinstance(pipe, BAPipeline)
    if is_ba:
        rb = pipe(base, stage["channels"], occ, None, stage="train", cam_idx=cam,
                  jitter=jitter, tracer_cfg=tcfg, cam_idx_host=cam.cpu().numpy(), images=b)
    else:
        world = Rays(origins=batch["rays_origins"].reshape(-1, 3),
                     dirs=batch["rays_dirs"].reshape(-1, 3), dist_min=0.0, dist_max=6.0)
        rb = pipe(world, stage["channels"], occ, None, stage="train", jitter=jitter,
                  tracer_cfg=tcfg, images=b)
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    if rb.ray_sparsity_loss is not None:
        total = total + rb.ray_sparsity_loss
        losses["ray_sparsity_loss"] = rb.ray_sparsity_loss
    if s["rgb_weight"] > 0:
        rl = rgb_l1_loss(rb.rgb, batch["imgs"].reshape(-1, 3))
        total = total + s["rgb_weight"] * rl
        losses["rgb_loss"] = rl
    sem_gts = batch.get("semantics_pred", batch["semantics"])
    if stage["use_sem"]:
        sl = semantic_loss(rb.semantics, sem_gts.reshape(-1), s["sem_softmax"],
                           s["sem_temperature"], None, None)
        total = total + s["sem_weight"] * sl
        losses["sem_loss"] = sl
    if stage["use_inst"]:
        inst_gts = batch.get("instance_pred", batch["instance"]).reshape(b, r)
        sem_gts = sem_gts.reshape(b, r)
        emb = rb.inst_embedding.reshape(b, r, -1)
        stuff = torch.isin(sem_gts, torch.tensor(semantic_info["stuff_ids"],
                                                 dtype=sem_gts.dtype, device=sem_gts.device))
        num_inst = pipe.nef.num_instances
        if s["inst_loss"] == "sup_contrastive":
            il = sup_contrastive_loss(emb, inst_gts, anchor_mask=~(~stuff & (inst_gts == 0)),
                                      temperature=s["inst_temperature"],
                                      base_temperature=s["base_temperature"],
                                      pn_ratio=s["inst_pn_ratio"])
        elif s["inst_loss"] == "linear_assignment":
            il = lin_assignment_loss(emb, inst_gts, num_inst)
        elif s["inst_loss"] == "linear_assignment_things":
            pts = None
            if s["inst_outlier_rejection"]:
                with torch.no_grad():
                    world = (pipe.transform_rays(base, cam, cam.cpu().numpy()) if is_ba
                             else world)
                    pts = rays_to_3d_points(world, rb.depth).reshape(b, r, 3)
            lmap = lin_assignment_things_loss(emb, inst_gts, stuff, num_inst, points_3d=pts,
                                              outlier_rejection=s["inst_outlier_rejection"])
            if stage["use_inst_segment_reg"]:
                lmap = lmap + s["inst_segment_reg_weight"] * segment_consistency_regularizer(
                    emb + 1e-27, inst_gts, num_inst)
            il = lmap.mean()
        else:
            raise NotImplementedError(s["inst_loss"])
        total = total + s["inst_weight"] * il
        losses["inst_loss"] = il
    losses["total_loss"] = total
    return total, losses


class Adam:
    """Adam at one rate a group, one count for all (every update counts,
    as the program's counts do); frozen names keep their values and
    moments."""

    def __init__(self, s: Dict, params: Dict[str, torch.Tensor]):
        _check_supported(s)
        self.s, self.params = s, params
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, Optional[torch.Tensor]], frozen) -> None:
        self.count += 1
        t = self.count
        for n, p in self.params.items():
            if frozen(n):
                continue
            grp = group_of(n)
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else g
            self.mu[n] = B1 * self.mu[n] + (1 - B1) * g
            self.nu[n] = B2 * self.nu[n] + (1 - B2) * g * g
            step = (self.mu[n] / (1 - B1 ** t)) / (torch.sqrt(self.nu[n] / (1 - B2 ** t))
                                                   + self.s.get("eps", 1e-15))
            p -= group_lr(self.s, grp) * step


def frozen_fn(stage: Dict):
    def frozen(name: str) -> bool:
        if stage["training_val_poses"]:
            return not name.startswith("extrinsics")
        if name.startswith("extrinsics"):
            return not stage["extrinsics_on"]
        return False
    return frozen


def train_step(pipe, opt: Adam, stage: Dict, s: Dict, batch: Dict[str, torch.Tensor],
               jitters: List[torch.Tensor], occ, semantic_info: Dict):
    """One step over ``batch`` ([B, R, ...] tensors) in microbatches of
    ``micro_batch_imgs`` images, ``jitters`` one [rays, steps] tensor a
    microbatch. Returns (mean losses as floats, the gradients the update
    took)."""
    params = opt.params
    for p in params.values():
        p.grad = None
    b = batch["imgs"].shape[0]
    mb = max(1, min(s["micro_batch_imgs"] or b, b))
    while b % mb:
        mb -= 1
    subs = [{k: v[i:i + mb] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == b else v
             for k, v in batch.items()} for i in range(0, b, mb)]
    if len(jitters) != len(subs):
        raise ValueError(f"{len(jitters)} jitters for {len(subs)} microbatches")
    acc: Dict[str, float] = {}
    for sub, jit in zip(subs, jitters):
        total, losses = compute_losses(pipe, sub, stage, s, jit, occ, semantic_info)
        total.backward()
        for k, v in losses.items():
            acc[k] = acc.get(k, 0.0) + float(v.detach())
    grads = {n: None if p.grad is None else p.grad / len(subs) for n, p in params.items()}
    for p in params.values():
        p.grad = None
    opt.update(grads, frozen_fn(stage))
    return {k: v / len(subs) for k, v in acc.items()}, grads


def leaf_norm(t: Optional[torch.Tensor]) -> float:
    return 0.0 if t is None else math.sqrt(float(torch.sum(t.double() ** 2)))
