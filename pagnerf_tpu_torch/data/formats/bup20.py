"""BUP20 sweet-pepper dataset format (counterpart of
``pagnerf_tpu/data/formats/bup20.py``): the frame window around a labelled
centre frame through the agrobot sequence loader, odometry poses turned
from OpenCV to OpenGL axes, intrinsics rescaled per mip, poses scaled and
offset into the unit cube (from a PLY mesh beside the tree, else BUP20's
defaults), and the camera-space base rays and per-pose world rays made
with the port's torch camera functions on the CPU in float32. The result
is the standard data dict (``data/synthetic.py``).

The reference routes poses through kaolin's Camera (an extrinsics update,
then a change of coordinate system to OpenCV axes); the same axis change
is a fixed basis flip of the view matrix here, as in the JAX package.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ...core.camera import (PinholeIntrinsics, cv_to_gl_pose,
                            extrinsics_params_from_view_matrix, generate_pinhole_rays,
                            inv_transform_rays)
from ..image_io import resize_linear, resize_nearest
from ..utils_ply import get_scale_from_ply_mesh
from .agrobot_base import BUP20InferenceDataset, BUP20SequenceDataset

DEFAULT_CLASS_LABELS = ["bg", "pepper"]

# kaolin's change_coordinate_system(opencv_coords)
_CV_BASIS = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)


def get_semantic_info(class_labels: Optional[List[str]] = None) -> Dict:
    """BUP20's semantic info: class 0 is stuff, the others things."""
    class_labels = class_labels or DEFAULT_CLASS_LABELS
    info = {}
    info["class_id_to_name"] = {i: l for i, l in enumerate(class_labels)}
    info["num_classes"] = len(class_labels)
    info["classes_present"] = list(range(len(class_labels)))
    info["num_present_classes"] = len(class_labels)
    info["stuff_ids"] = [0]
    info["things_ids"] = list(range(1, len(class_labels)))
    info["num_instances"] = 200
    return info


def load_scale_and_offset(root, model_rescaling="snap_to_bottom"):
    """Scene scale/offset from a PLY mesh beside the tree if present, else
    BUP20's defaults."""
    scale, offset = None, None
    mesh_files = list(Path(root).expanduser().glob("../*.ply"))
    if mesh_files:
        scale, offset = get_scale_from_ply_mesh(mesh_files[0], model_rescaling)
    if scale is None:
        scale = 1.0
    if offset is None:
        offset = [0.0, 0.0, -1.4]
    return scale, offset


def _resize(img: np.ndarray, h: int, w: int, nearest: bool) -> np.ndarray:
    """cv2's INTER_NEAREST, or its INTER_LINEAR of the float32 image."""
    if nearest:
        return resize_nearest(img, w, h)
    return resize_linear(img.astype(np.float32), w, h)


def load_data(root, split="train", bg_color="white", mip: int = 0,
              load_modes=None, scale=None, offset=None,
              add_noise_to_train_poses=False, pose_noise_strength=0.01,
              dataset_center_idx=0, pose_src="odom", max_depth=-1.0,
              mode="label_window", class_labels=None,
              robot_mask_path=None) -> Dict:
    """The standard data dict of the window around eval image
    ``dataset_center_idx``, with both its train and its val frames
    (``train_idxs`` / ``val_idxs``)."""
    class_labels = class_labels or DEFAULT_CLASS_LABELS
    load_modes = load_modes or ["imgs", "semantics", "instance",
                                "preds_mask2former"]
    # load_modes as the reference reads them: without a preds source no
    # predictions load at all, and the trainer's batch.get("semantics_pred",
    # batch["semantics"]) precedence then supervises on the GT labels
    preds_name = next((m for m in load_modes if "preds" in m), None)
    root = Path(root).expanduser()

    cls = BUP20SequenceDataset if mode == "label_window" else BUP20InferenceDataset
    frames = []
    for sub in ("train", "val"):
        ds = cls(root / "BUP_20.json", subset=sub, seq_num_frames=40,
                 odom_src=pose_src, preds_rel_path=preds_name,
                 max_depth=max_depth, class_labels=class_labels,
                 robot_mask_path=robot_mask_path)
        data = ds[dataset_center_idx]
        for d in data:
            d["split"] = sub
        frames.extend(data)

    if scale is None or offset is None:
        s, o = load_scale_and_offset(root)
        scale = scale if scale is not None else s
        offset = offset if offset is not None else o
    offset = np.asarray(offset, np.float32)

    resize_factor = 1 << mip
    h0, w0 = frames[0]["rgb"].shape[:2]
    h, w = h0 // resize_factor, w0 // resize_factor

    imgs, sems, sems_p, insts, insts_p = [], [], [], [], []
    sem_confs, inst_confs, depths, views, ts = [], [], [], [], []
    filenames, splits = [], []
    rng = np.random.default_rng(0)
    have_preds = preds_name is not None
    for i, d in enumerate(frames):
        imgs.append(_resize(d["rgb"], h, w, nearest=False))
        sems.append(_resize(d["semantics"], h, w, nearest=True).astype(np.int32))
        insts.append(_resize(d["imap"], h, w, nearest=True).astype(np.int32))
        if have_preds:
            sems_p.append(_resize(d["semantics_pred"], h, w,
                                  nearest=True).astype(np.int32))
            insts_p.append(_resize(d["imap_pred"], h, w,
                                   nearest=True).astype(np.int32))
            sem_confs.append(_resize(d["sem_conf"], h, w, nearest=False))
            inst_confs.append(_resize(d["inst_conf"], h, w, nearest=False))
        depths.append(_resize(d["depth"], h, w, nearest=False))

        pose = cv_to_gl_pose(d["odom"].astype(np.float64)).astype(np.float32)
        pose[:3, 3] *= scale
        pose[:3, 3] += offset
        if d["split"] == "train" and add_noise_to_train_poses and i > 0:
            # rotation + translation noise, first frame kept clean as the BA
            # anchor: rotation in +-strength*pi/2, translation in +-strength
            from scipy.spatial.transform import Rotation
            ang = pose_noise_strength * (2 * rng.random(3) - 1) * np.pi / 2
            pose[:3, :3] = pose[:3, :3] @ Rotation.from_euler(
                "xyz", ang).as_matrix().astype(np.float32)
            pose[:3, 3] += pose_noise_strength * (2 * rng.random(3) - 1)
        views.append(_CV_BASIS @ pose)
        ts.append(d["odom_ts"])
        filenames.append(d["file_names"])
        splits.append(d["split"])

    intr_mat = frames[0]["intrinsics"] / resize_factor
    intr = PinholeIntrinsics(
        fx=np.float32(intr_mat[0, 0]), fy=np.float32(intr_mat[1, 1]),
        cx=np.float32(intr_mat[0, 2]), cy=np.float32(intr_mat[1, 2]),
        width=w, height=h, near=0.0, far=2.0)

    # base rays (camera space) + per-pose world rays, float32 on the CPU
    base = generate_pinhole_rays(intr, dist_min=0.0, dist_max=2.0)
    views_np = np.stack(views)
    params = extrinsics_params_from_view_matrix(torch.from_numpy(views_np))
    bo = base.origins.reshape(1, -1, 3).expand(len(views), h * w, 3)
    bd = base.dirs.reshape(1, -1, 3).expand(len(views), h * w, 3)
    wo, wd = inv_transform_rays(params, bo, bd)
    wd = wd / (torch.linalg.norm(wd, dim=-1, keepdim=True) + 1e-12)

    splits = np.asarray(splits)
    extra = {}
    if "robot_mask" in frames[0]:
        # per-sequence robot self-occlusion mask: attached by the window
        # loader; MultiviewDataset excludes robot pixels from ray sampling
        extra["robot_mask"] = _resize(frames[0]["robot_mask"], h, w,
                                      nearest=True).astype(np.uint8)
    if have_preds:
        extra.update({
            "semantics_pred": np.stack(sems_p),
            "instance_pred": np.stack(insts_p),
            "sem_conf": np.stack(sem_confs).astype(np.float32),
            "inst_conf": np.stack(inst_confs).astype(np.float32),
        })
    return {
        **extra,
        "imgs": np.stack(imgs).astype(np.float32),
        "semantics": np.stack(sems),
        "instance": np.stack(insts),
        "depths": np.stack(depths).astype(np.float32),
        "rays_origins": wo.reshape(-1, h, w, 3).numpy(),
        "rays_dirs": wd.reshape(-1, h, w, 3).numpy(),
        "base_rays_origins": base.origins.numpy(),
        "base_rays_dirs": base.dirs.numpy(),
        "view_matrices": views_np,
        "cameras_ts": np.asarray(ts),
        "filenames": filenames,
        "intrinsics": intr,
        "train_idxs": np.nonzero(splits == "train")[0],
        "val_idxs": np.nonzero(splits == "val")[0],
        "semantic_info": get_semantic_info(class_labels),
    }


def load_bup20(args) -> Dict:
    """Factory adapter: build from a parsed config namespace."""
    return load_data(
        args.dataset_path, bg_color=args.bg_color, mip=args.mip or 0,
        load_modes=args.load_modes or None,
        scale=args.scale[0] if args.scale else None,
        offset=args.offset, add_noise_to_train_poses=args.add_noise_to_train_poses,
        pose_noise_strength=args.pose_noise_strength,
        dataset_center_idx=args.dataset_center_idx, pose_src=args.pose_src,
        max_depth=args.max_depth, mode=args.dataset_mode,
        class_labels=args.class_labels or None,
        robot_mask_path=getattr(args, "mask_robot_path", None))
