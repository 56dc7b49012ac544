"""Agrobot sequence datasets (counterpart of
``pagnerf_tpu/data/formats/agrobot_base.py``): COCO annotations, odometry
and 2-D prediction pickles of a frame window around a labelled centre
frame of a robot image sequence:

- COCO annotations rasterised to semantic / instance maps (the centre frame
  only; the other frames get empty (-1) labels);
- train = odd / val = even frame offsets around the centre;
- odometry from CSV (quaternion rows) or metashape NPZ, made relative to the
  centre frame and sandwiched by the camera extrinsics;
- Mask2Former / MaskRCNN / UNet / DeepLab prediction pickles with
  confidences (a pickle may hold torch tensors);
- ``filter_masks_with_depth``, the robot mask, and the removal of eval
  frames too close to a sequence's edge.

The JAX package reads PNGs with PIL, YAML with PyYAML and resizes with cv2;
the port reads them with ``data/image_io.py`` and ``config/yaml_lite.py``,
which give the same arrays.
"""
from __future__ import annotations

import bz2
import csv
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ...config import yaml_lite
from ..image_io import read_png, resize_linear
from .coco import COCO


def csv_odom_to_transforms(path: str) -> Dict[str, np.ndarray]:
    """Odometry CSV (ts, tx..tz, qx..qw rows) -> {ts: 4x4}."""
    from scipy.spatial.transform import Rotation
    odom_tfs = {}
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        header[0] = "ts"
        for row in reader:
            odom = {l: row[i] for i, l in enumerate(header)}
            trans = np.array([float(odom[l]) for l in ("tx", "ty", "tz")])
            rot = Rotation.from_quat(
                [float(odom[l]) for l in ("qx", "qy", "qz", "qw")]).as_matrix()
            tf = np.eye(4)
            tf[:3, 3] = trans
            tf[:3, :3] = rot
            odom_tfs[odom["ts"]] = tf
    return odom_tfs


def load_odometry(odom_path: Path) -> Dict[str, np.ndarray]:
    """Odometry file -> {ts: 4x4}. CSV (quaternion rows) or metashape NPZ with
    0.03 translation scaling."""
    odom_path = Path(odom_path)
    if odom_path.suffix == ".csv":
        return csv_odom_to_transforms(str(odom_path))
    if odom_path.suffix == ".npz":
        ms = np.load(odom_path)
        tfs = ms["arr_0"].copy()
        tfs[..., :3, 3] *= 0.03
        return {ts: tf for ts, tf in zip(ms["arr_1"], tfs)}
    raise NotImplementedError(f"Unsupported odometry filetype {odom_path}")


def _to_np(x) -> np.ndarray:
    """A prediction pickle's array, torch tensors included."""
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return np.asarray(x)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class SequenceDataset:
    """The frame window around each labelled (eval) frame of a sequence."""

    def __init__(self, dataset_file, subset, class_labels, depth_rel_path,
                 odometry_rel_file_path, frame_window_size,
                 mask_robot_path=None, preds_rel_path=None, max_depth: float = -1):
        self.dataset_name = Path(dataset_file).stem
        self._root_dir = Path(dataset_file).parent.parent / self.dataset_name
        self.class_labels = class_labels
        self.subset = subset
        assert subset in ("train", "val")
        self.max_depth = max_depth
        self.depth_rel_path = depth_rel_path
        self.preds_rel_path = preds_rel_path
        self.odom_file_path = odometry_rel_file_path
        self.robot_mask_path = mask_robot_path

        with open(self._root_dir / (self.dataset_name + ".yaml")) as fp:
            self.dataset_config = yaml_lite.load(fp.read())
        self.image_sets = self.dataset_config["image_sets"]

        self.coco = COCO(self._root_dir / (self.dataset_name + ".json"))

        # category id -> class label index (by name or supercategory)
        self.id_to_class_label = {}
        self.cat_ids = set()
        for cid, c in self.coco.cats.items():
            if c.get("supercategory") in class_labels:
                self.id_to_class_label[cid] = class_labels.index(c["supercategory"])
                self.cat_ids.add(cid)
            elif c.get("name") in class_labels:
                self.id_to_class_label[cid] = class_labels.index(c["name"])
                self.cat_ids.add(cid)

        self.img_set_ids = list(self.image_sets["eval"])

        def img_path_to_ids(ids, remove_edge_frames=False):
            out = {}
            for md in self.coco.loadImgs(ids):
                im_path = self._root_dir / self.dataset_rel_path(md["path"])
                if remove_edge_frames:
                    seq = [p for p in sorted(im_path.parent.iterdir())
                           if p.suffix == im_path.suffix]
                    pos = seq.index(im_path)
                    if pos < frame_window_size + 1 or \
                            len(seq) - pos < frame_window_size + 1:
                        continue
                out[im_path] = md["id"]
            return out

        self.img_path_to_ids = img_path_to_ids(self.img_set_ids,
                                               remove_edge_frames=True)
        self.img_set_ids = list(self.img_path_to_ids.values())
        self.img_path_to_ids_train = img_path_to_ids(self.image_sets["train"])

        win = frame_window_size if frame_window_size % 2 == 0 else frame_window_size - 1
        # even offsets = train frames; odd offsets = val / pose-opt-only frames
        self.train_frames_idxs = list(range(-win - 1, win + 2, 2))
        self.val_frames_idxs = list(range(-win, win + 1, 2))

    # ------------------------------------------------------------------ paths
    def dataset_rel_path(self, path: str = "") -> str:
        parts = Path(path).parts
        if len(parts) < 4:
            raise ValueError("Invalid dataset path, it only has 2 or less subpaths")
        return str(Path(*parts[3:]))

    def __len__(self):
        return len(self.img_set_ids)

    # ------------------------------------------------------------------ labels
    def generate_mask(self, md) -> np.ndarray:
        anns = [a for a in self.coco.img_to_anns.get(md["id"], [])
                if a["category_id"] in self.cat_ids]
        m = np.zeros((md["height"], md["width"]), np.int32)
        for ann in anns:
            if not ann.get("segmentation"):
                continue
            am = self.coco.annToMask(ann)
            m[am != 0] = self.id_to_class_label[ann["category_id"]]
        return m

    def generate_instance_masks(self, md) -> np.ndarray:
        anns = [a for a in self.coco.img_to_anns.get(md["id"], [])
                if a["category_id"] in self.cat_ids]
        m = np.zeros((md["height"], md["width"]), np.int32)
        for i, ann in enumerate(anns):
            m[self.coco.annToMask(ann) != 0] = i + 1
        return m

    def _load_rgb(self, path) -> np.ndarray:
        return read_png(path, "RGB").astype(np.float32) / 255.0

    def _load_depth(self, path) -> np.ndarray:
        return read_png(path).astype(np.float32)

    def load_robot_mask(self, img_path: Path) -> Optional[np.ndarray]:
        """Per-sequence robot self-occlusion mask, grayscale; nonzero = robot
        pixel (the mask file lives two levels above the frame:
        seq_dir/../<robot_mask_path>). None when robot masking is not
        configured."""
        if self.robot_mask_path is None:
            return None
        mask_file = img_path.parent.parent / self.robot_mask_path
        if not mask_file.exists():
            raise FileNotFoundError(
                f"robot mask enabled (mask_robot_path={self.robot_mask_path!r}) "
                f"but {mask_file} does not exist")
        return (read_png(mask_file, "L") > 0).astype(np.uint8)

    # ------------------------------------------------------------------ preds
    def load_preds(self, img_path: Path):
        """Dispatch on the predictions folder name.

        ``preds_rel_path=None`` (no preds source in load_modes — the
        reference's GT-supervision regime) returns all-None: callers then
        omit the pred channels from the frame, and the trainer's
        ``batch.get("semantics_pred", batch["semantics"])`` precedence
        trains on the GT labels."""
        p = self.preds_rel_path
        if not p:
            return None, None, None, None
        if "unet" in p:
            with bz2.open(img_path.parent / p / f"{img_path.stem}.pkl.bz2") as f:
                preds = pickle.load(f)
            sem = _to_np(preds["sem_seg"]["preds"]).astype(np.int32)
            imap = _to_np(preds["instances"]["imap"]).astype(np.int32)
            conf = _to_np(preds["sem_seg"]["confidence"]).squeeze()
            return sem, imap, conf, conf
        with open(img_path.parent / p / f"{img_path.stem}.pkl", "rb") as f:
            preds = pickle.load(f)
        if "maskrcnn" in p:
            masks = _to_np(preds["masks"])
            imap = (masks > 0.5).squeeze().astype(np.int32)
            imap = ((imap.sum(0) > 0) + imap.argmax(0)).astype(np.int32)
            sem = (imap > 0).astype(np.int32)
            conf = masks.squeeze().max(0)
            conf[conf == 0.0] = 0.9
            return sem, imap, conf, conf
        if "deeplab" in p:
            imap = _to_np(preds["panoptic"])[0, 1]
            sem = _to_np(preds["panoptic"])[0, 0]
            conf = np.ones_like(imap, np.float32)
            return sem.astype(np.int32), imap.astype(np.int32), conf, conf
        if "mask2former" in p:
            sem = _to_np(preds[0]).astype(np.int32)
            imap = _to_np(preds[1]).astype(np.int32)
            conf = _to_np(preds[2]).astype(np.float32)
            conf[imap == 0] = -conf[imap == 0]
            conf = _sigmoid(conf)
            return sem, imap, conf, conf
        raise NotImplementedError(
            f"Load predictions for path name {p} not implemented")

    def filter_masks_with_depth(self, imap: np.ndarray, depth: np.ndarray):
        """Drop instance masks with < 50% of pixels within max_depth (depth
        stored in mm)."""
        d = depth * 0.001
        if d.shape != imap.shape:
            d = resize_linear(d, imap.shape[1], imap.shape[0])
        valid_ids = imap[(d <= self.max_depth) & (d > 0)]
        counts = np.bincount(imap.reshape(-1))
        vcounts = np.bincount(valid_ids.reshape(-1), minlength=counts.shape[0])
        valid_masks = vcounts / np.maximum(counts, 1) > 0.5
        return np.where(valid_masks[imap], imap, 0)

    # ------------------------------------------------------------------ window
    def __getitem__(self, index: int) -> List[Dict]:
        used = self.train_frames_idxs if self.subset == "train" \
            else self.val_frames_idxs
        img_id = self.img_set_ids[index]
        md = self.coco.loadImgs(img_id)[0]
        img_path = self._root_dir / self.dataset_rel_path(md["path"])
        parent = img_path.parent
        seq = [p for p in sorted(parent.iterdir()) if p.suffix == img_path.suffix]
        seq_idx = seq.index(img_path)

        odom_from_ts = load_odometry(parent / self.odom_file_path)

        with open(parent / "params.yaml") as yml:
            cam_params = {k: np.asarray(v, np.float32)
                          for k, v in yaml_lite.load(yml.read()).items()}
        ext = cam_params["extrinsics"]
        ext_i = np.linalg.inv(ext)

        deltas = list(reversed(sorted(used)))
        idxs = [min(len(seq) - 1, max(0, int(seq_idx - d))) for d in deltas]
        paths = [seq[i] for i in idxs]
        if not isinstance(self, InferenceDataset):
            paths = [p for p in paths if p not in self.img_path_to_ids_train]
            if self.subset == "train":
                paths = [p for p in paths if p not in self.img_path_to_ids]

        center_odom = odom_from_ts[img_path.name.split(".")[0]]
        robot_mask = self.load_robot_mask(img_path)
        data = []
        for path in paths:
            rgb = self._load_rgb(self._root_dir / path if not path.is_absolute()
                                 else path)
            sem_pred, imap_pred, sem_conf, inst_conf = self.load_preds(path)
            if path == img_path and path in self.img_path_to_ids:
                pmd = self.coco.loadImgs(self.img_path_to_ids[path])[0]
                sem_label = self.generate_mask(pmd)
                inst_label = self.generate_instance_masks(pmd)
            else:
                sem_label = np.full(rgb.shape[:2], -1, np.int32)
                inst_label = np.full(rgb.shape[:2], -1, np.int32)

            depth = self._load_depth(path.parent / self.depth_rel_path / path.name)
            if self.max_depth > 0 and imap_pred is not None:
                buf = imap_pred
                imap_pred = self.filter_masks_with_depth(imap_pred, depth)
                flipped = np.logical_xor(buf, imap_pred)
                inst_conf = inst_conf.copy()
                inst_conf[flipped] = 1
                sem_pred = sem_pred.copy()
                sem_pred[imap_pred == 0] = 0
                sem_conf = sem_conf.copy()
                sem_conf[flipped] = 1

            ts = path.name.split(".")[0]
            robot_odom = odom_from_ts[ts]
            frame_odom = ext_i @ np.linalg.inv(robot_odom) @ center_odom @ ext
            frame = {
                "rgb": rgb, "depth": depth,
                "semantics": sem_label, "imap": inst_label,
                "odom": frame_odom.astype(np.float32), "odom_ts": ts,
                "intrinsics": cam_params["intrinsics"],
                "extrinsics": cam_params["extrinsics"],
                "file_names": path.name,
            }
            if sem_pred is not None:
                frame.update({"semantics_pred": sem_pred, "imap_pred": imap_pred,
                              "sem_conf": sem_conf, "inst_conf": inst_conf})
            if robot_mask is not None:
                frame["robot_mask"] = robot_mask
            data.append(frame)
        return data


class InferenceDataset(SequenceDataset):
    """Sliding-window variant over whole sequences: indexes advance window-by-window through
    every sequence regardless of labels, with ``num_rm_frames`` trimmed from each
    window edge; all frames get empty labels (predictions only)."""

    def __init__(self, dataset_file, subset, class_labels, depth_rel_path,
                 odometry_rel_file_path, frame_window_size,
                 mask_robot_path=None, preds_rel_path=None, max_depth: float = -1,
                 num_rm_frames: int = 10):
        import math
        super().__init__(dataset_file, subset, class_labels, depth_rel_path,
                         odometry_rel_file_path, frame_window_size,
                         mask_robot_path, preds_rel_path, max_depth)
        # inference covers every image set
        self.img_set_ids = (list(self.image_sets.get("train", []))
                            + list(self.image_sets.get("valid", []))
                            + list(self.image_sets.get("eval", [])))
        metadata = self.coco.loadImgs(self.img_set_ids)
        seq_rel = sorted({Path(self.dataset_rel_path(m["path"])).parent
                          for m in metadata})
        self.seq_paths = [self._root_dir / p for p in seq_rel]
        ext = Path(metadata[0]["path"]).suffix if metadata else ".png"
        self.img_paths = [sorted(sp.glob(f"*{ext}")) for sp in self.seq_paths]
        self.seq_length = min((len(l) for l in self.img_paths), default=0)
        self.img_paths = [l[:self.seq_length] for l in self.img_paths]

        self.num_rm_frames = num_rm_frames
        win = frame_window_size if frame_window_size % 2 == 0 else frame_window_size - 1
        self.win_bound = win
        self.win_len = win * 2 + 3 - num_rm_frames * 2
        self.train_frames_idxs = list(range(-win - 1, win + 2, 2))
        self.val_frames_idxs = list(range(-win - 1 + num_rm_frames,
                                          win + 2 - num_rm_frames))
        self._math = math

    def __len__(self):
        if self.seq_length == 0:
            return 0
        win_per_seq = self._math.ceil(
            (self.seq_length - self.num_rm_frames * 2) / self.win_len)
        return win_per_seq * len(self.seq_paths)

    def center_path_for_index(self, idx: int) -> Path:
        """Window index -> centre image path."""
        win_per_seq = self._math.ceil(
            (self.seq_length - self.num_rm_frames * 2) / self.win_len)
        seq_idx = idx // win_per_seq
        img_idx = (self.win_bound + 2 + (idx * self.win_len)) % self.seq_length
        return self.img_paths[seq_idx][img_idx]

    def __getitem__(self, index: int):
        # window around the sliding centre; never load GT labels (every frame gets
        # empty labels via the predictions path)
        center = self.center_path_for_index(index)
        saved = self.img_path_to_ids
        self.img_path_to_ids = {}
        try:
            # reuse the base window loader with this centre path
            parent = center.parent
            seq = [p for p in sorted(parent.iterdir()) if p.suffix == center.suffix]
            return self._window_from_center(center, seq)
        finally:
            self.img_path_to_ids = saved

    def _window_from_center(self, img_path: Path, seq):
        # mirror of SequenceDataset.__getitem__ with an arbitrary centre path
        used = self.train_frames_idxs if self.subset == "train" \
            else self.val_frames_idxs
        parent = img_path.parent
        seq_idx = seq.index(img_path)
        # the same odometry loader as SequenceDataset.__getitem__ (CSV or NPZ)
        odom_from_ts = load_odometry(parent / self.odom_file_path)
        with open(parent / "params.yaml") as yml:
            cam_params = {k: np.asarray(v, np.float32)
                          for k, v in yaml_lite.load(yml.read()).items()}
        ext = cam_params["extrinsics"]
        ext_i = np.linalg.inv(ext)
        deltas = list(reversed(sorted(used)))
        idxs = [min(len(seq) - 1, max(0, int(seq_idx - d))) for d in deltas]
        center_odom = odom_from_ts[img_path.name.split(".")[0]]
        robot_mask = self.load_robot_mask(img_path)
        data = []
        for path in (seq[i] for i in idxs):
            rgb = self._load_rgb(path)
            sem_pred, imap_pred, sem_conf, inst_conf = self.load_preds(path)
            depth = self._load_depth(path.parent / self.depth_rel_path / path.name)
            ts = path.name.split(".")[0]
            robot_odom = odom_from_ts[ts]
            frame_odom = ext_i @ np.linalg.inv(robot_odom) @ center_odom @ ext
            empty = np.full(rgb.shape[:2], -1, np.int32)
            frame = {
                "rgb": rgb, "depth": depth, "semantics": empty, "imap": empty,
                "odom": frame_odom.astype(np.float32), "odom_ts": ts,
                "intrinsics": cam_params["intrinsics"],
                "extrinsics": cam_params["extrinsics"],
                "file_names": path.name,
            }
            if sem_pred is not None:
                frame.update({"semantics_pred": sem_pred, "imap_pred": imap_pred,
                              "sem_conf": sem_conf, "inst_conf": inst_conf})
            if robot_mask is not None:
                frame["robot_mask"] = robot_mask
            data.append(frame)
        return data


class BUP20SequenceDataset(SequenceDataset):
    """BUP20 sweet-pepper sequences."""

    def __init__(self, dataset_file, subset="train", seq_num_frames=40,
                 odom_src="odom", preds_rel_path=None, max_depth=-1,
                 class_labels=("bg", "pepper"), robot_mask_path=None):
        odo = {"rgbd": "rgbd_odom.csv", "odom": "odometry.csv",
               "metashape": "metashape_cameras.npz"}
        if odom_src not in odo:
            raise ValueError(f"unsupported odometry source {odom_src}")
        super().__init__(dataset_file=dataset_file, subset=subset,
                         class_labels=list(class_labels), depth_rel_path="depth",
                         odometry_rel_file_path=odo[odom_src],
                         frame_window_size=seq_num_frames,
                         mask_robot_path=robot_mask_path,
                         preds_rel_path=preds_rel_path, max_depth=max_depth)


class BUP20InferenceDataset(InferenceDataset):
    """BUP20 sequences, sliding windows."""

    def __init__(self, dataset_file, subset="train", seq_num_frames=40,
                 num_rm_frames=10, odom_src="odom", preds_rel_path=None,
                 max_depth=-1, class_labels=("bg", "pepper"),
                 robot_mask_path=None):
        odo = {"rgbd": "rgbd_odom.csv", "odom": "odometry.csv",
               "metashape": "metashape_cameras.npz"}
        super().__init__(dataset_file, subset, list(class_labels), "depth",
                         odo[odom_src], seq_num_frames,
                         mask_robot_path=robot_mask_path,
                         preds_rel_path=preds_rel_path, max_depth=max_depth,
                         num_rm_frames=num_rm_frames)


class SB20SequenceDataset(SequenceDataset):
    """SB20 sugar-beet sequences."""

    def __init__(self, dataset_file, subset="train", seq_num_frames=40,
                 odom_src="odom", preds_rel_path=None, max_depth=-1,
                 class_labels=("bg", "sugar_beet", "weed")):
        super().__init__(dataset_file=dataset_file, subset=subset,
                         class_labels=list(class_labels), depth_rel_path="depth",
                         odometry_rel_file_path="odometry.csv",
                         frame_window_size=seq_num_frames,
                         preds_rel_path=preds_rel_path, max_depth=max_depth)
