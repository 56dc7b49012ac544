"""Dataset dry-run validation (counterpart of ``pagnerf_tpu/data/validate.py``):
walk an on-disk tree and report schema mismatches without training.

The first contact with a real BUP20 download should fail fast and
specifically, not minutes into a training run. ``validate_bup20_tree``
checks every path and key the loader stack touches
(``data/formats/bup20.py`` and ``agrobot_base.py``):

  * root layout: ``BUP_20.json`` (COCO) + ``BUP_20.yaml`` (image_sets);
  * COCO schema: images (id/path/height/width, >= 4 path parts for
    dataset_rel_path), categories matching the class labels by name or
    supercategory, annotations with segmentations for the labelled frames;
  * per-sequence files: odometry (csv quaternion rows / metashape npz) with
    an entry for EVERY frame timestamp, ``params.yaml`` (3x3 intrinsics,
    4x4 extrinsics), ``depth/<frame>`` for every frame, prediction pickles
    for every frame when a preds source is in load_modes, robot mask;
  * sample decode: RGB / depth / prediction payloads of the centre frame are
    actually opened and shape-checked against the COCO metadata (``deep=True``
    opens every frame instead).

Returns a list of ``("ERROR"|"WARN", message)`` tuples with the JAX
package's texts; the command line (``cli.py --validate-dataset``) prints
them and exits with the number of errors. Where a file cannot be read, the
message quotes the port's reader (``data/image_io.py``,
``config/yaml_lite.py``) where the JAX package quotes PIL or PyYAML.
"""
from __future__ import annotations

import bz2
import csv
import json
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import yaml_lite
from .image_io import png_size, read_png

Issue = Tuple[str, str]

_ODOM_FILES = {"rgbd": "rgbd_odom.csv", "odom": "odometry.csv",
               "metashape": "metashape_cameras.npz"}
_QUAT_COLS = ("tx", "ty", "tz", "qx", "qy", "qz", "qw")


def _err(issues: List[Issue], msg: str) -> None:
    issues.append(("ERROR", msg))


def _warn(issues: List[Issue], msg: str) -> None:
    issues.append(("WARN", msg))


def _check_odometry(issues: List[Issue], odom_path: Path,
                    frame_stems: List[str]) -> None:
    """Parse the odometry file and check coverage of every frame timestamp
    (loader surface: agrobot_base.csv_odom_to_transforms / load_odometry)."""
    if not odom_path.exists():
        _err(issues, f"odometry file missing: {odom_path}")
        return
    ts_seen = set()
    if odom_path.suffix == ".csv":
        with open(odom_path) as f:
            reader = csv.reader(f)
            try:
                header = next(reader)
            except StopIteration:
                _err(issues, f"odometry csv is empty: {odom_path}")
                return
            header = list(header)
            header[0] = "ts"
            missing_cols = [c for c in _QUAT_COLS if c not in header]
            if missing_cols:
                _err(issues, f"odometry csv {odom_path} header lacks columns "
                             f"{missing_cols} (header: {header})")
                return
            for ln, row in enumerate(reader, start=2):
                if len(row) != len(header):
                    _err(issues, f"odometry csv {odom_path}:{ln} has "
                                 f"{len(row)} fields, header has {len(header)}")
                    return
                rec = dict(zip(header, row))
                try:
                    [float(rec[c]) for c in _QUAT_COLS]
                except ValueError as e:
                    _err(issues, f"odometry csv {odom_path}:{ln} non-numeric "
                                 f"pose field: {e}")
                    return
                ts_seen.add(rec["ts"])
    elif odom_path.suffix == ".npz":
        try:
            ms = np.load(odom_path)
        except Exception as e:  # noqa: BLE001 - report, don't crash the walk
            _err(issues, f"cannot load odometry npz {odom_path}: {e}")
            return
        for key in ("arr_0", "arr_1"):
            if key not in ms:
                _err(issues, f"odometry npz {odom_path} lacks {key} "
                             f"(has {list(ms.keys())})")
                return
        tfs = ms["arr_0"]
        if tfs.ndim != 3 or tfs.shape[-2:] != (4, 4):
            _err(issues, f"odometry npz {odom_path} arr_0 must be [N, 4, 4], "
                         f"got {tfs.shape}")
            return
        if len(ms["arr_1"]) != len(tfs):
            _err(issues, f"odometry npz {odom_path}: {len(tfs)} transforms vs "
                         f"{len(ms['arr_1'])} timestamps")
        ts_seen = {str(t) for t in ms["arr_1"]}
    else:
        _err(issues, f"unsupported odometry filetype: {odom_path}")
        return
    missing = [s for s in frame_stems if s not in ts_seen]
    if missing:
        _err(issues, f"odometry {odom_path} lacks entries for "
                     f"{len(missing)}/{len(frame_stems)} frames "
                     f"(first missing: {missing[0]})")


def _check_params_yaml(issues: List[Issue], path: Path) -> None:
    if not path.exists():
        _err(issues, f"params.yaml missing: {path}")
        return
    try:
        with open(path) as f:
            params = yaml_lite.load(f.read())
    except yaml_lite.YamlLiteError as e:
        _err(issues, f"cannot parse {path}: {e}")
        return
    for key, shape in (("intrinsics", (3, 3)), ("extrinsics", (4, 4))):
        if key not in params:
            _err(issues, f"{path} lacks key {key!r}")
            continue
        try:
            arr = np.asarray(params[key], np.float32)
        except (TypeError, ValueError):
            _err(issues, f"{path} {key} is not numeric")
            continue
        if arr.shape != shape:
            _err(issues, f"{path} {key} must be {shape}, got {arr.shape}")


def _check_pred_payload(issues: List[Issue], pred_path: Path, preds_name: str,
                        hw: Tuple[int, int]) -> None:
    """Open one prediction file and validate the per-source payload structure
    (loader surface: agrobot_base.SequenceDataset.load_preds)."""
    try:
        if "unet" in preds_name:
            with bz2.open(pred_path) as f:
                preds = pickle.load(f)
            sem = np.asarray(preds["sem_seg"]["preds"])
            imap = np.asarray(preds["instances"]["imap"])
            conf = np.asarray(preds["sem_seg"]["confidence"]).squeeze()
        else:
            with open(pred_path, "rb") as f:
                preds = pickle.load(f)
            if "maskrcnn" in preds_name:
                masks = np.asarray(preds["masks"])
                if masks.ndim < 3:
                    _err(issues, f"{pred_path}: maskrcnn 'masks' must be "
                                 f">= 3-D, got {masks.shape}")
                return
            if "deeplab" in preds_name:
                pano = np.asarray(preds["panoptic"])
                if pano.ndim != 4 or pano.shape[1] < 2:
                    _err(issues, f"{pred_path}: deeplab 'panoptic' must be "
                                 f"[1, 2, H, W]-like, got {pano.shape}")
                return
            # mask2former: (sem, imap, conf) indexable triple
            sem = np.asarray(preds[0])
            imap = np.asarray(preds[1])
            conf = np.asarray(preds[2])
    except FileNotFoundError:
        _err(issues, f"prediction file missing: {pred_path}")
        return
    except (KeyError, IndexError, TypeError, pickle.UnpicklingError,
            EOFError) as e:
        _err(issues, f"prediction payload {pred_path} does not match the "
                     f"{preds_name} schema: {type(e).__name__}: {e}")
        return
    for name, arr in (("sem", sem), ("imap", imap), ("conf", conf)):
        if tuple(arr.shape[-2:]) != hw:
            _err(issues, f"{pred_path}: {name} shape {arr.shape} does not end "
                         f"in the image size {hw}")


def _check_image_file(issues: List[Issue], path: Path,
                      hw: Tuple[int, int]) -> None:
    try:
        w, h = png_size(path)
    except Exception as e:  # noqa: BLE001
        _err(issues, f"cannot open image {path}: {e}")
        return
    if (h, w) != hw:
        _err(issues, f"{path} is {h}x{w}, COCO metadata says "
                     f"{hw[0]}x{hw[1]}")


def _check_depth_file(issues: List[Issue], path: Path) -> None:
    try:
        arr = read_png(path)
    except Exception as e:  # noqa: BLE001
        _err(issues, f"cannot open depth image {path}: {e}")
        return
    if not np.issubdtype(arr.dtype, np.integer):
        _warn(issues, f"depth {path} has dtype {arr.dtype}; the loader "
                      f"expects integer millimetres (agrobot_base "
                      f"filter_masks_with_depth scales by 0.001)")


def validate_bup20_tree(root, pose_src: str = "odom",
                        load_modes: Optional[List[str]] = None,
                        class_labels: Optional[List[str]] = None,
                        robot_mask_path: Optional[str] = None,
                        seq_num_frames: int = 40,
                        deep: bool = False) -> List[Issue]:
    """Validate a BUP20/agrobot dataset tree. Returns (severity, message)
    issues; empty list = the loader stack will find everything it touches."""
    issues: List[Issue] = []
    root = Path(root).expanduser()
    class_labels = list(class_labels or ["bg", "pepper"])
    load_modes = load_modes or ["imgs", "semantics", "instance",
                                "preds_mask2former"]
    preds_name = next((m for m in load_modes if "preds" in m), None)

    if not root.is_dir():
        _err(issues, f"dataset root is not a directory: {root}")
        return issues
    name = root.name
    if name != "BUP_20":
        # the loader opens root/"BUP_20.json" and resolves its root dir as
        # json_parent.parent / "BUP_20" (agrobot_base.SequenceDataset.__init__)
        _warn(issues, f"dataset root is named {name!r}; the BUP20 loader "
                      f"expects the directory to be named 'BUP_20' (it opens "
                      f"<root>/BUP_20.json and re-derives the root from it)")
        name = "BUP_20"
    json_path = root / f"{name}.json"
    yaml_path = root / f"{name}.yaml"

    # ------------------------------------------------------------- manifest
    if not yaml_path.exists():
        _err(issues, f"dataset config missing: {yaml_path}")
        image_sets: Dict = {}
    else:
        try:
            with open(yaml_path) as f:
                ds_cfg = yaml_lite.load(f.read())
            image_sets = ds_cfg["image_sets"]
        except (yaml_lite.YamlLiteError, KeyError, TypeError) as e:
            _err(issues, f"{yaml_path} lacks a readable 'image_sets' map: {e}")
            image_sets = {}
    for subset in ("eval", "train"):
        if subset not in image_sets:
            _err(issues, f"{yaml_path} image_sets lacks the {subset!r} list")
    eval_ids = list(image_sets.get("eval", []))
    if not eval_ids:
        _err(issues, f"{yaml_path} has no eval images — nothing to train on")

    if not json_path.exists():
        _err(issues, f"COCO annotation file missing: {json_path}")
        return issues
    try:
        with open(json_path) as f:
            coco = json.load(f)
    except json.JSONDecodeError as e:
        _err(issues, f"cannot parse {json_path}: {e}")
        return issues
    for key in ("images", "annotations", "categories"):
        if key not in coco:
            _err(issues, f"{json_path} lacks the COCO key {key!r}")
            return issues

    # ----------------------------------------------------------- categories
    matched_cat_ids = set()
    for c in coco["categories"]:
        if c.get("supercategory") in class_labels or \
                c.get("name") in class_labels:
            matched_cat_ids.add(c["id"])
    if not matched_cat_ids:
        _err(issues, f"no COCO category matches class_labels {class_labels} "
                     f"by name or supercategory (categories: "
                     f"{[c.get('name') for c in coco['categories']]})")

    # --------------------------------------------------------------- images
    imgs_by_id = {}
    for i, md in enumerate(coco["images"]):
        missing = [k for k in ("id", "path", "height", "width") if k not in md]
        if missing:
            _err(issues, f"{json_path} images[{i}] lacks keys {missing}")
            continue
        if len(Path(md["path"]).parts) < 4:
            _err(issues, f"image id {md['id']} path {md['path']!r} has fewer "
                         f"than 4 components — dataset_rel_path strips the "
                         f"first 3 (agrobot_base.dataset_rel_path)")
            continue
        imgs_by_id[md["id"]] = md

    ann_img_ids = set()
    for i, a in enumerate(coco["annotations"]):
        if "image_id" not in a or "category_id" not in a:
            _err(issues, f"{json_path} annotations[{i}] lacks "
                         f"image_id/category_id")
            continue
        if a["category_id"] in matched_cat_ids and a.get("segmentation"):
            ann_img_ids.add(a["image_id"])

    known_eval = [i for i in eval_ids if i in imgs_by_id]
    for img_id in eval_ids:
        if img_id not in imgs_by_id:
            _err(issues, f"image_sets eval id {img_id} is not in "
                         f"{json_path} images")
        elif img_id not in ann_img_ids:
            _warn(issues, f"eval image id {img_id} has no usable annotation "
                          f"(matched category + non-empty segmentation) — GT "
                          f"metrics for that centre frame will be empty")

    # ------------------------------------------------------------ sequences
    def rel(path: str) -> Path:
        return root / Path(*Path(path).parts[3:])

    seq_frames: Dict[Path, List[Path]] = {}
    for img_id in known_eval:
        md = imgs_by_id[img_id]
        img_path = rel(md["path"])
        if not img_path.exists():
            _err(issues, f"eval image file missing: {img_path} "
                         f"(COCO path {md['path']!r})")
            continue
        seq_dir = img_path.parent
        if seq_dir not in seq_frames:
            seq_frames[seq_dir] = sorted(
                p for p in seq_dir.iterdir() if p.suffix == img_path.suffix)
        seq = seq_frames[seq_dir]
        pos = seq.index(img_path)
        if pos < seq_num_frames + 1 or len(seq) - pos < seq_num_frames + 1:
            _warn(issues, f"eval frame {img_path.name} is within "
                          f"{seq_num_frames + 1} frames of the sequence edge "
                          f"— the loader drops it (remove_edge_frames)")

    for seq_dir, seq in seq_frames.items():
        stems = [p.name.split(".")[0] for p in seq]
        hw = None
        for img_id in known_eval:
            md = imgs_by_id[img_id]
            if rel(md["path"]).parent == seq_dir:
                hw = (md["height"], md["width"])
                break

        _check_odometry(issues, seq_dir / _ODOM_FILES[pose_src], stems)
        _check_params_yaml(issues, seq_dir / "params.yaml")

        depth_dir = seq_dir / "depth"
        if not depth_dir.is_dir():
            _err(issues, f"depth directory missing: {depth_dir}")
        else:
            missing = [p.name for p in seq if not (depth_dir / p.name).exists()]
            if missing:
                _err(issues, f"{depth_dir} lacks depth for "
                             f"{len(missing)}/{len(seq)} frames "
                             f"(first: {missing[0]})")

        if preds_name is not None:
            pred_dir = seq_dir / preds_name
            suffix = ".pkl.bz2" if "unet" in preds_name else ".pkl"
            if not pred_dir.is_dir():
                _err(issues, f"predictions directory missing: {pred_dir} "
                             f"(load_modes includes {preds_name!r})")
            else:
                missing = [p.stem for p in seq
                           if not (pred_dir / f"{p.stem}{suffix}").exists()]
                if missing:
                    _err(issues, f"{pred_dir} lacks predictions for "
                                 f"{len(missing)}/{len(seq)} frames "
                                 f"(first: {missing[0]})")

        if robot_mask_path is not None:
            mask_file = seq_dir.parent / robot_mask_path
            if not mask_file.exists():
                _err(issues, f"robot mask enabled but missing: {mask_file}")

        # -------------------------------------------------- sample decodes
        sample = seq if deep else [seq[len(seq) // 2]]
        for p in sample:
            if hw is not None:
                _check_image_file(issues, p, hw)
            dp = seq_dir / "depth" / p.name
            if dp.exists():
                _check_depth_file(issues, dp)
            if preds_name is not None and hw is not None:
                suffix = ".pkl.bz2" if "unet" in preds_name else ".pkl"
                pp = seq_dir / preds_name / f"{p.stem}{suffix}"
                if pp.exists():
                    _check_pred_payload(issues, pp, preds_name, hw)

    return issues


def validate_nerf_standard_tree(root) -> List[Issue]:
    """Validate an instant-ngp style tree (loader surface:
    data/formats/nerf_standard.py)."""
    issues: List[Issue] = []
    root = Path(root).expanduser()
    candidates = [root / "transforms.json", root / "transforms_train.json"]
    tf = next((p for p in candidates if p.exists()), None)
    if tf is None:
        _err(issues, f"no transforms.json / transforms_train.json under {root}")
        return issues
    try:
        with open(tf) as f:
            meta = json.load(f)
    except json.JSONDecodeError as e:
        _err(issues, f"cannot parse {tf}: {e}")
        return issues
    frames = meta.get("frames")
    if not frames:
        _err(issues, f"{tf} has no 'frames'")
        return issues
    has_global_focal = any(k in meta for k in
                           ("fl_x", "camera_angle_x", "x_fov"))
    for i, fr in enumerate(frames):
        if "file_path" not in fr or "transform_matrix" not in fr:
            _err(issues, f"{tf} frames[{i}] lacks file_path/transform_matrix")
            continue
        if not has_global_focal and not any(
                k in fr for k in ("fl_x", "camera_angle_x", "x_fov")):
            _err(issues, f"{tf} frames[{i}] has no focal/fov and none is set "
                         f"globally")
        fp = root / fr["file_path"]
        if not (fp.exists() or fp.with_suffix(".png").exists()
                or fp.with_suffix(".jpg").exists()):
            _err(issues, f"frame image missing: {fp}")
    return issues


def run_validation(args) -> int:
    """Command-line entry: dispatch on the dataset format, print the report,
    return the number of errors (``cli.py --validate-dataset``)."""
    fmt = args.multiview_dataset_format
    if fmt == "bup20":
        issues = validate_bup20_tree(
            args.dataset_path, pose_src=args.pose_src,
            load_modes=args.load_modes or None,
            class_labels=args.class_labels or None,
            robot_mask_path=getattr(args, "mask_robot_path", None),
            deep=bool(getattr(args, "validate_dataset_deep", False)))
    elif fmt in ("standard", "nerf_standard"):
        issues = validate_nerf_standard_tree(args.dataset_path)
    elif fmt == "synthetic":
        print("synthetic dataset is generated in-process; nothing to validate")
        return 0
    else:
        print(f"--validate-dataset does not support format {fmt!r}")
        return 1
    for sev, msg in issues:
        print(f"{sev}: {msg}")
    n_err = sum(1 for sev, _ in issues if sev == "ERROR")
    n_warn = len(issues) - n_err
    print(f"validate-dataset: {n_err} error(s), {n_warn} warning(s)"
          + ("" if n_err else " — tree looks loadable"))
    return n_err
