"""Validation (counterpart of ``pagnerf_tpu/train/validation.py``): the
chunked render of every image of a split (``PanopticTrainer.batch_render``),
PSNR / IoU / PQ / mAP, the 2-D-prediction baselines and their gains
(``iou_gain`` / ``pq_things_gain``), the instance-map cleanup, media and
``metrics.csv``.

The renders run on the trainer's device; metrics, clean-up and media run on
the host, on the channels read back. ``val/render_time_per_img`` times each
render up to that read, so it counts a finished render. ``writer`` is
duck-typed: anything with ``add_image(tag, image, step)``.
"""
from __future__ import annotations

import csv
import dataclasses
import logging
import os
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.rays import Rays
from ..models.pipeline import BAPipeline
from ..utils.clustering import MeanShift
from ..utils.metrics import IoU, MeanAveragePrecision, PSNR, PanopticQuality
from ..utils.postprocess import clean_instance_map, decode_instance_map
from ..utils.visualization import (depth2rgb, label2rgb, label_colormap,
                                   write_png, write_video)

log = logging.getLogger(__name__)


def _rays_from(imgs_data: Dict, idx: int, use_base: bool, device) -> Rays:
    """Image ``idx``'s world rays, or the camera-space base rays, [H*W]."""
    if use_base:
        o = imgs_data["base_rays_origins"]
        d = imgs_data["base_rays_dirs"]
    else:
        o = imgs_data["rays_origins"][idx]
        d = imgs_data["rays_dirs"][idx]
    return Rays(origins=torch.as_tensor(np.ascontiguousarray(o.reshape(-1, 3)),
                                        device=device),
                dirs=torch.as_tensor(np.ascontiguousarray(d.reshape(-1, 3)),
                                     device=device),
                dist_min=0.0, dist_max=6.0)


def _read(rb) -> Dict[str, np.ndarray]:
    """The rendered channels, read back to the host."""
    return {f.name: getattr(rb, f.name).cpu().numpy() for f in dataclasses.fields(rb)
            if getattr(rb, f.name) is not None}


def train_clustering(trainer, num_samples: int = 20000) -> Optional[MeanShift]:
    """Fit mean-shift on embeddings rendered at train-set instance pixels
    (the reference trainer's ``train_clustering``)."""
    ds = trainer.dataset
    if "instance" not in ds.data:
        return None
    is_ba = isinstance(trainer.pipeline, BAPipeline)
    rng = np.random.default_rng(0)
    n_imgs = len(ds.train_idxs)
    per_img = max(1, num_samples // n_imgs)
    embeds, labels = [], []
    for idx in ds.train_idxs:
        inst = ds.data["instance"][idx].reshape(-1)
        pick = rng.choice(inst.shape[0], size=min(per_img, inst.shape[0]),
                          replace=False)
        if is_ba:
            o = ds.data["base_rays_origins"].reshape(-1, 3)[pick]
            d = ds.data["base_rays_dirs"].reshape(-1, 3)[pick]
        else:
            o = ds.data["rays_origins"][idx].reshape(-1, 3)[pick]
            d = ds.data["rays_dirs"][idx].reshape(-1, 3)[pick]
        rays = Rays(origins=torch.as_tensor(o, device=trainer.device),
                    dirs=torch.as_tensor(d, device=trainer.device),
                    dist_min=0.0, dist_max=6.0)
        rb = trainer.batch_render(rays, {"inst_embedding"},
                                  cam_idx=int(idx) if is_ba else None)
        e = rb.inst_embedding.cpu().numpy()
        e = e / (np.linalg.norm(e, axis=-1, keepdims=True) + 1e-12)
        embeds.append(e)
        labels.append(inst[pick])
    ms = MeanShift()
    ms.train_clustering(np.stack(embeds), np.stack(labels))
    return ms


def evaluate_metrics(trainer, epoch: int, data: Dict,
                     clustering: Optional[MeanShift] = None,
                     log_dir: Optional[str] = None,
                     writer=None) -> Dict[str, float]:
    """Render every image in ``data`` and accumulate the metric suite (the
    reference trainer's ``evaluate_metrics``). With ``cfg.log_2d`` and a
    ``writer``, the saved frames also go to ``writer.add_image``."""
    cfg = trainer.cfg
    sem_info = trainer.dataset.semantic_info
    h, w = data["imgs"].shape[1:3]

    psnr = PSNR()
    iou = IoU(sem_info["num_classes"])
    iou_pred = IoU(sem_info["num_classes"])
    pq = PanopticQuality(set(sem_info["things_ids"]), set(sem_info["stuff_ids"]))
    pq_pred = PanopticQuality(set(sem_info["things_ids"]), set(sem_info["stuff_ids"]))
    mAP = MeanAveragePrecision()
    mAP_pred = MeanAveragePrecision()

    use_sem = epoch >= cfg.sem_epoch_start and "semantics" in data
    use_inst = epoch >= cfg.inst_epoch_start and "instance" in data
    if use_inst and not use_sem:
        # instance eval (decode gating, PQ) requires the semantic map; don't
        # silently render inst_embedding for every image and then skip it
        log.info("instance metrics skipped: semantic channel inactive "
                 "(sem_epoch_start=%d, epoch=%d)", cfg.sem_epoch_start, epoch)
        use_inst = False
    channels = {"rgb", "depth"}
    if use_sem:
        channels.add("semantics")
    if use_inst:
        channels.add("inst_embedding")
    have_sem_pred = "semantics_pred" in data
    have_inst_pred = have_sem_pred and "instance_pred" in data

    use_base = cfg.optimize_val_extrinsics
    render_time = 0.0
    num_imgs = data["imgs"].shape[0]
    have_labels = False
    labeled_idxs = set()
    sem_cmap = label_colormap(max(sem_info["num_classes"], 2))
    frames = {k: [] for k in ("rgb", "depth", "sem", "sem_rgb", "inst",
                              "inst_rgb", "inst_conf")}
    media_dir = os.path.join(log_dir, "val", f"epoch_{epoch}") if log_dir else None
    for i in range(num_imgs):
        cam_idx = int(data["cam_idx"][i]) if use_base else None
        rays = _rays_from(data, i, use_base, trainer.device)
        t0 = time.perf_counter()
        rb = _read(trainer.batch_render(rays, channels, cam_idx=cam_idx))
        render_time += time.perf_counter() - t0

        rgb = rb["rgb"].reshape(h, w, 3)
        psnr.update(rgb, np.asarray(data["imgs"][i])[..., :3])
        rgb_u8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        if media_dir:   # frame colorization/accumulation only when saving
            frames["rgb"].append(rgb_u8)
            frames["depth"].append(depth2rgb(rb["depth"].reshape(h, w)))

        sem_map = None
        if use_sem:
            sem_gts = np.asarray(data["semantics"][i]).reshape(h, w)
            sem_map = np.argmax(rb["semantics"], -1).reshape(h, w)
            labeled = not np.all(sem_gts == -1)
            if labeled:
                labeled_idxs.add(i)
                iou.update(sem_map, sem_gts)
                if "semantics_pred" in data:
                    iou_pred.update(np.asarray(data["semantics_pred"][i]), sem_gts)
            if media_dir:
                frames["sem"].append(label2rgb(sem_map, colormap=sem_cmap))
                frames["sem_rgb"].append(label2rgb(sem_map, colormap=sem_cmap,
                                                   image=rgb_u8))

        if use_inst and sem_map is not None:
            inst_gts = np.asarray(data["instance"][i]).reshape(h, w)
            e = rb["inst_embedding"]
            if clustering is not None:
                en = e / (np.linalg.norm(e, axis=-1, keepdims=True) + 1e-12)
                inst_map = clustering.predict_clusters(en).reshape(h, w)
                inst_conf = np.max(e, -1).reshape(h, w)
            else:
                # semantic-gated decode for things-loss heads; see
                # utils/postprocess.decode_instance_map for the contract
                inst_map, inst_conf = decode_instance_map(
                    e, sem_map, sem_info["stuff_ids"],
                    gated=trainer.cfg.inst_loss == "linear_assignment_things")
            inst_map, masks, _ = clean_instance_map(
                inst_map, cfg.inst_num_dilations,
                outlier_rejection=cfg.inst_outlier_rejection,
                min_mask_px=cfg.inst_min_mask_px)
            if media_dir:
                icmap = label_colormap(int(inst_map.max()) + 2)
                frames["inst"].append(label2rgb(inst_map, colormap=icmap))
                frames["inst_rgb"].append(label2rgb(inst_map, colormap=icmap,
                                                    image=rgb_u8, alpha=0.7))
                frames["inst_conf"].append(depth2rgb(inst_conf, 0.0, 1.0))
            if media_dir and cfg.save_preds:
                # prediction pickles for downstream evaluation: the panoptic
                # [sem, inst] stack and its confidence companion
                pp = os.path.join(media_dir, "panoptic")
                cp = os.path.join(media_dir, "inst_conf")
                os.makedirs(pp, exist_ok=True)
                os.makedirs(cp, exist_ok=True)
                with open(os.path.join(pp, f"{i}.pkl"), "wb") as f:
                    pickle.dump(np.stack([sem_map, inst_map]).astype(np.uint8), f)
                with open(os.path.join(cp, f"{i}.pkl"), "wb") as f:
                    pickle.dump(inst_conf.astype(np.float32), f)
            labeled = not np.all(sem_gts == -1) and not np.all(inst_gts == -1)
            if labeled:
                have_labels = True
                pq.update(np.stack([sem_map, inst_map])[None],
                          np.stack([sem_gts, inst_gts])[None])
                gt_ids = np.unique(inst_gts)
                gt_masks = (inst_gts[None] == gt_ids[1:][:, None, None])
                mAP.update(masks.astype(bool), np.ones(masks.shape[0]), gt_masks)
                if "instance_pred" in data and "semantics_pred" in data:
                    ip = np.asarray(data["instance_pred"][i])
                    sp = np.asarray(data["semantics_pred"][i])
                    pq_pred.update(np.stack([sp, ip])[None],
                                   np.stack([sem_gts, inst_gts])[None])
                    p_ids = np.unique(ip)
                    p_masks = (ip[None] == p_ids[1:][:, None, None])
                    mAP_pred.update(p_masks, np.ones(p_masks.shape[0]), gt_masks)

    # validation media: PNG frames + per-channel videos. render_val_labels
    # additionally saves every GT-labeled frame, with its GT label maps,
    # regardless of the save stride (as the reference does).
    if media_dir:
        os.makedirs(media_dir, exist_ok=True)
        every = max(cfg.num_val_frames_to_save, 1)
        # the reference's meaning: a stride >= the image count means "save
        # every frame", not "save only frame 0"
        save_idxs = (set(range(num_imgs)) if every >= num_imgs
                     else set(range(0, num_imgs, every)))
        if cfg.render_val_labels:
            save_idxs |= labeled_idxs
        log_2d = writer is not None and cfg.log_2d
        for i in sorted(save_idxs):
            write_png(os.path.join(media_dir, f"{i}.png"), frames["rgb"][i])
            write_png(os.path.join(media_dir, f"{i}_gt.png"),
                      np.asarray(data["imgs"][i])[..., :3])
            if frames["sem"]:
                write_png(os.path.join(media_dir, f"{i}_sem.png"), frames["sem"][i])
            if frames["inst"]:
                write_png(os.path.join(media_dir, f"{i}_inst.png"), frames["inst"][i])
            if log_2d:
                # log_2d: mirror the saved frames to the writer
                writer.add_image(f"val/{i}/rgb", frames["rgb"][i], epoch)
                if frames["sem"]:
                    writer.add_image(f"val/{i}/semantics", frames["sem"][i], epoch)
                if frames["inst"]:
                    writer.add_image(f"val/{i}/instances", frames["inst"][i], epoch)
            if i in labeled_idxs and cfg.render_val_labels:
                if use_sem:
                    write_png(os.path.join(media_dir, f"{i}_sem_gt.png"), label2rgb(
                        np.asarray(data["semantics"][i]).reshape(h, w),
                        colormap=sem_cmap))
                if use_inst:
                    ig = np.asarray(data["instance"][i]).reshape(h, w)
                    write_png(os.path.join(media_dir, f"{i}_inst_gt.png"), label2rgb(
                        ig, colormap=label_colormap(int(ig.max()) + 2)))
        for ch_name, fl in frames.items():
            if fl:
                write_video(os.path.join(media_dir, f"{ch_name}.mp4"), fl)

    metrics = {"val/psnr": psnr.compute(),
               "val/render_time_per_img": render_time / max(num_imgs, 1)}
    if use_sem:
        metrics["val/iou"] = iou.compute()
        # _pred baselines/gains ONLY when the dataset carries 2-D predictions —
        # a vacuous iou_pred of 0.0 would report the raw metric as a "gain"
        # over a baseline that does not exist
        if have_sem_pred:
            metrics["val/iou_pred"] = iou_pred.compute()
            metrics["val/iou_gain"] = metrics["val/iou"] - metrics["val/iou_pred"]
    if use_inst and have_labels:
        pq_suffixes = [(pq.compute(), "")]
        map_suffixes = [(mAP.compute(), "")]
        if have_inst_pred:
            pq_suffixes.append((pq_pred.compute(), "_pred"))
            map_suffixes.append((mAP_pred.compute(), "_pred"))
        for res, suffix in pq_suffixes:
            for group, vals in res.items():
                for k, v in vals.items():
                    if k != "n":
                        metrics[f"val/{k}_{group}{suffix}"] = v
        if have_inst_pred:
            metrics["val/pq_things_gain"] = (metrics.get("val/pq_things", 0.0)
                                             - metrics.get("val/pq_things_pred", 0.0))
        for res, suffix in map_suffixes:
            for k, v in res.items():
                metrics[f"val/{k}{suffix}"] = v

    if log_dir:
        append_metrics_csv(os.path.join(log_dir, "metrics.csv"),
                           {**metrics, "epoch": epoch})
    return metrics


def append_metrics_csv(path: str, row: Dict):
    """metrics.csv append (the reference trainer's).

    Validation passes at different epochs report different metric sets (early
    rgb-only vals have no PQ columns); when a row introduces new columns the
    file is rewritten with the merged header so the CSV stays rectangular."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if os.path.exists(path):
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            old_fields = list(reader.fieldnames or [])
            old_rows = None if set(row) <= set(old_fields) else list(reader)
    else:
        old_fields, old_rows = [], []
    if old_fields and old_rows is None:
        # columns unchanged: plain append -- never truncate-rewrite the history
        # of a long run that a crash in mid-write would erase
        with open(path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=old_fields, restval="").writerow(row)
        return
    fields = old_fields + sorted(k for k in row.keys() if k not in old_fields)
    tmp = f"{path}.tmp"     # header changed: rewrite atomically (tmp + rename)
    with open(tmp, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields, restval="")
        writer.writeheader()
        for r in old_rows or []:
            writer.writerow(r)
        writer.writerow(row)
    os.replace(tmp, path)


def validate(trainer, epoch: int = 0, log_dir: Optional[str] = None,
             split: str = "val", writer=None) -> Dict[str, float]:
    """Full validation pass (the reference trainer's ``validate``) of the
    ``split`` images ('val', or 'train' to evaluate the training views):
    at ``cfg.val_mip``, or at mip 0 for the final validation (``epoch >=
    cfg.epochs``) unless ``cfg.low_res_val``. ``writer`` receives the saved
    frames under ``cfg.log_2d``."""
    clustering = None
    if getattr(trainer.pipeline.nef, "use_clustering", False) and \
            epoch >= trainer.cfg.inst_epoch_start:
        clustering = train_clustering(trainer, trainer.cfg.num_clustering_samples)
    if log_dir and trainer.cfg.save_grid:
        # occupancy snapshot
        gp = os.path.join(log_dir, "grid")
        os.makedirs(gp, exist_ok=True)
        np.savez_compressed(
            os.path.join(gp, f"occupancy_epoch{epoch}.npz"),
            occupancy=trainer.occ.occupancy.cpu().numpy(),
            mask=trainer.occ.mask.cpu().numpy(), level=trainer.occ.level)
    mip = trainer.cfg.val_mip
    # full-res final validation unless low_res_val
    if epoch >= trainer.cfg.epochs and not trainer.cfg.low_res_val:
        mip = 0
    data = trainer.dataset.get_images(split=split, mip=mip)
    log.info("validation: %d images at %dx%d", data["imgs"].shape[0],
             data["imgs"].shape[2], data["imgs"].shape[1])
    return evaluate_metrics(trainer, epoch, data, clustering=clustering,
                            log_dir=log_dir, writer=writer)
