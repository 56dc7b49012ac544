"""The reference's modules from a configuration's ``settings`` (every option
of the run, resolved): the NeF, the tracer's settings, the pipeline with its
extrinsics worked out from the frames' view matrices, and the occupancy of
the scene fixture. Mirrors how the program's factory reads the same
options; reads nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .models.clustering_nef import (MeanShiftPanopticDDensityNeF, MeanShiftPanopticDeltaNeF,
                                    MeanShiftPanopticNeF)
from .models.nefs import GridConfig, PanopticDDensityNeF, PanopticDeltaNeF, PanopticNeF
from .models.pipeline import BAPipeline, Pipeline
from .models.tracer import TracerConfig
from .ops.occupancy import OccupancyGrid

NEFS = {c.__name__: c for c in (PanopticNeF, PanopticDeltaNeF, PanopticDDensityNeF,
                                MeanShiftPanopticNeF, MeanShiftPanopticDeltaNeF,
                                MeanShiftPanopticDDensityNeF)}


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def grid_config(s: Dict, delta: bool = False) -> GridConfig:
    return GridConfig(
        grid_type=s["grid_type"], num_lods=s["num_lods"], feature_dim=s["feature_dim"],
        capacity_log2=s["delta_capacity_log_2"] if delta else s["capacity_log_2"],
        coarsest_scale=s["coarsest_scale"], finest_scale=s["finest_scale"],
        log2_table_size=max(s["codebook_bitwidth"], 4), base_lod=s["base_lod"],
        compute_dtype=_dtype(s["compute_dtype"]))


def build_nef(s: Dict, semantic_info: Dict) -> torch.nn.Module:
    cls = NEFS[s["nef_type"]]
    kw = dict(
        grid=grid_config(s),
        num_classes=s["num_classes"] if s["num_classes"] > 0 else semantic_info["num_classes"],
        num_instances=(s["num_instances"] if s["num_instances"] > 0
                       else semantic_info["num_instances"]),
        hidden_dim=s["hidden_dim"], num_layers=s["num_layers"],
        activation_type=s["activation_type"], sem_activation_type=s["sem_activation_type"],
        sem_num_layers=s["sem_num_layers"], sem_hidden_dim=s["sem_hidden_dim"],
        sem_normalize=s["sem_normalize"], sem_softmax=s["sem_softmax"],
        sem_sigmoid=s["sem_sigmoid"], sem_detach=s["sem_detach"],
        inst_num_layers=s["inst_num_layers"], inst_hidden_dim=s["inst_hidden_dim"],
        inst_normalize=s["inst_normalize"], inst_softmax=s["inst_softmax"],
        inst_sigmoid=s["inst_sigmoid"], inst_detach=s["inst_detach"],
        inst_direct_pos=s["inst_direct_pos"], inst_soft_temperature=s["inst_soft_temperature"],
        sem_zero_init=s["sem_zero_init"], panoptic_features_type=s["panoptic_features_type"],
        multiscale_type=s["multiscale_type"], view_multires=s["view_multires"],
        pos_multires=s["pos_multires"], embedder_type=s["embedder_type"],
        compute_dtype=_dtype(s["compute_dtype"]))
    if issubclass(cls, PanopticDeltaNeF):
        return cls(delta_grid=grid_config(s, delta=True), **kw)
    import inspect
    valid = set(inspect.signature(cls.__init__).parameters)
    return cls(**{k: v for k, v in kw.items() if k in valid})


def tracer_config(s: Dict) -> TracerConfig:
    return TracerConfig(
        tracer_type=s["tracer_type"], num_steps=s["num_steps"],
        raymarch_type=s["raymarch_type"], bg_color=s["bg_color"],
        ray_max_travel=s["ray_max_travel"], ray_sparsity_reg=s["ray_sparcity_reg"],
        panoptic_bg_residual=s["panoptic_bg_residual"],
        bg_residual_sem=bool(s["sem_softmax"]), bg_residual_inst=bool(s["inst_softmax"]))


def build_pipeline(s: Dict, data: Dict, dev) -> Pipeline:
    """The pipeline on ``dev``, its extrinsics from the frames' view matrices
    (anchor frame 0) where the run optimises poses."""
    nef = build_nef(s, data["semantic_info"])
    tcfg = tracer_config(s)
    if s["optimize_extrinsics"] or s["optimize_val_extrinsics"]:
        pipe = BAPipeline(nef, tcfg, torch.from_numpy(data["view_matrices"]),
                          anchor_frame_idxs=[0])
    else:
        pipe = Pipeline(nef, tcfg)
    return pipe.to(dev)


def scene_density(scene, res: int, dev) -> torch.Tensor:
    """1e3 in the cells whose box meets one of the scene's spheres or the
    wall of the [-0.9, 0.9]^3 box, 0 elsewhere ([res^3], the occupancy's
    cell order): what a trained field of the scene would leave."""
    c = (torch.arange(res, device=dev, dtype=torch.float64) + 0.5) / res * 2 - 1
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    h = 1.0 / res
    cover = torch.zeros_like(x, dtype=torch.bool)
    for cen, r in zip(scene.centers, scene.radii):
        d = torch.sqrt((x - cen[0]) ** 2 + (y - cen[1]) ** 2 + (z - cen[2]) ** 2)
        cover |= d <= r + math.sqrt(3.0) * h
    near = torch.stack([(a.abs() - h).clamp(min=0) for a in (x, y, z)]).amax(0)
    far = torch.stack([a.abs() + h for a in (x, y, z)]).amax(0)
    cover |= (near <= 0.9) & (far >= 0.9)
    return cover.reshape(-1).float() * 1e3


def occupancy(s: Dict, scene, pruned: bool, dev) -> OccupancyGrid:
    """The run's occupancy: fully visible, or after a prune the scene
    fixture's cells dilated by one cell."""
    occ = OccupancyGrid.create(level=s["blas_level"], device=dev)
    if pruned:
        occ = occ.update_from_density(scene_density(scene, occ.res, dev), decay=0.0,
                                      dilate=1)
    return occ


def stage_for_epoch(s: Dict, epoch: int, data: Dict, pruned: bool, occ_frac: float,
                    occ_res: int, is_ba: bool) -> Dict:
    """What the step of ``epoch`` does: channels, march, steps, packed
    budget, heads and pose groups, by the run's schedule."""
    ve = s["val_extrinsics_end"] if s["val_extrinsics_end"] >= 0 else s["epochs"]
    ee = s["extrinsics_epoch_end"] if s["extrinsics_epoch_end"] >= 0 else s["epochs"]
    every = max(s["val_extrinsics_every"], 1)
    val_pose = (s["optimize_val_extrinsics"] and is_ba and s["val_extrinsics_start"] <= epoch <= ve
                and epoch % every == 0)
    use_sem = (epoch >= s["sem_epoch_start"] and s["sem_weight"] > 0 and "semantics" in data
               and not val_pose)
    use_inst = (epoch >= s["inst_epoch_start"] and epoch >= s["sem_epoch_start"]
                and s["inst_weight"] > 0 and bool(s["inst_loss"]) and "instance" in data
                and not val_pose)
    channels = {"rgb"}
    if use_sem:
        channels.add("semantics")
    if use_inst:
        channels.add("inst_embedding")
    if s["inst_outlier_rejection"] and use_inst:
        channels.add("depth")
    vstart = s["voxel_raymarch_epoch_start"] if s["voxel_raymarch_epoch_start"] > 0 else 10 ** 9
    voxel = epoch > vstart
    if voxel:
        travel = min(s["ray_max_travel"], 2.0)
        num_steps = max(1, int(round(2 * travel * occ_res / 2.0)))
    else:
        num_steps = s["num_steps"]
    pack = 0
    if pruned and s["packed_compaction"]:
        pack = max(8, int(np.ceil(1.15 * occ_frac * num_steps / 8.0)) * 8)
        if pack >= num_steps:
            pack = 0
    if pack == 0 and pruned:
        raise NotImplementedError("the compacted layout is not part of the reference")
    return dict(channels=frozenset(channels),
                raymarch_type="voxel" if voxel else s["raymarch_type"],
                num_steps=num_steps, pack_steps=pack, use_sem=use_sem, use_inst=use_inst,
                use_inst_segment_reg=(s["inst_segment_reg_weight"] > 0
                                      and epoch > s["inst_segment_reg_weight"]),
                training_val_poses=val_pose,
                extrinsics_on=(s["optimize_extrinsics"]
                               and s["extrinsics_epoch_start"] <= epoch <= ee))
