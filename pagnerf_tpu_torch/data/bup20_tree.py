"""A BUP20-format tree of the synthetic sphere scene, written with the port's
own writers (``utils/visualization.write_png``, ``config/yaml_lite.dump``,
``data/formats/coco.encode_rle``), for running the BUP20 path end to end
where the real BUP20 is not at hand.

The tree is the format ``data/formats/bup20.py`` reads::

    <root>/BUP_20.json            COCO: every frame's image, polygon and RLE
                                  annotations of the eval frames' spheres
    <root>/BUP_20.yaml            image_sets: eval (labelled) and train ids
    <root>/row_1/<ts>.png         8-bit RGB frames
    <root>/row_1/depth/<ts>.png   16-bit depth in mm (0 where a ray misses)
    <root>/row_1/preds_mask2former/<ts>.pkl   (sem, imap, conf logits)
    <root>/row_1/preds_maskrcnn/<ts>.pkl      {"masks": [K, 1, H, W] scores}
    <root>/row_1/preds_deeplab/<ts>.pkl       {"panoptic": [1, 2, H, W] sem, imap}
    <root>/row_1/params.yaml      3x3 intrinsics, 4x4 camera extrinsics
    <root>/row_1/odometry.csv     robot poses: ts, translation, quaternion
    <root>/row_1/metashape_cameras.npz   the same poses, translations / 0.03

The robot drives along a crop row: the camera, mounted on it by the
extrinsics, moves along x past the scene's spheres (``default_scene``),
1.4 m in front of them and looking at them, as BUP20's camera looks at the
canopy. The frames are rendered in closed form from the very poses the
BUP20 loader makes of the odometry (its window is centred on frame
``center``, which sits in front of the scene; the default offset places
that camera at z = -1.4), spheres on white, sphere classes 1 and 2 as two
COCO categories of the supercategory ``pepper``, and the noisy per-frame
2-D predictions of ``add_synthetic_predictions`` in the three layouts the
loader reads (``data/formats/agrobot_base.py``'s ``load_preds``). Everything else is the
format as the reader expects it; the size is the caller's (BUP20's frames
are 1280x720).
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Sequence

import numpy as np

from ..config import yaml_lite
from ..utils.visualization import write_png
from .formats.coco import encode_rle
from .synthetic import _render_analytic, add_synthetic_predictions, default_scene

SEQUENCE = "row_1"
# BUP20's default pose offset puts the window's centre camera at z = -1.4
CAMERA_Z = -1.4
STEP_M = 0.01
PREDICTIONS = ("mask2former", "maskrcnn", "deeplab")


def _mount() -> np.ndarray:
    """The camera's extrinsics on the robot: pitched by 10 degrees, offset."""
    a = np.deg2rad(10.0)
    e = np.eye(4)
    e[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    e[:3, 3] = [0.1, 0.05, 0.3]
    return e


def _polygon(mask: np.ndarray) -> list:
    """A COCO polygon [x0, y0, x1, y1, ...] through the centres of a mask's
    outermost pixels: each row's leftmost pixel top to bottom, then each
    row's rightmost bottom to top."""
    rows = np.nonzero(mask.any(1))[0]
    left = [(float(np.nonzero(mask[r])[0][0]), float(r)) for r in rows]
    right = [(float(np.nonzero(mask[r])[0][-1]), float(r)) for r in rows[::-1]]
    return [v for p in left + right for v in p]


def _maskrcnn_masks(imap: np.ndarray, conf: np.ndarray, k: int) -> np.ndarray:
    """Mask R-CNN-like scores [k, 1, H, W] float32 of instance ids 1..k
    (k >= 2, so the loader's squeeze keeps the instance axis): mask i holds
    the confidence, above 0.5, where the prediction is instance i + 1,
    else 0."""
    score = (0.5 + 0.5 * conf).astype(np.float32)
    masks = [np.where(imap == i + 1, score, 0.0) for i in range(k)]
    return np.stack(masks)[:, None].astype(np.float32)


def _rays(width: int, height: int, fx: float, fy: float, cx: float, cy: float,
          ss: int):
    """World directions [H*ss*W*ss, 3] of the loader's cameras (rotation
    diag(-1, 1, -1): looking along +z) through an ss x ss grid per pixel,
    and each direction's camera-space length before normalising."""
    px, py = np.meshgrid((np.arange(width * ss) + 0.5) / ss,
                         (np.arange(height * ss) + 0.5) / ss)
    cam = np.stack([(px - cx) / fx, -(py - cy) / fy, -np.ones_like(px)], -1)
    norm = np.linalg.norm(cam, axis=-1).reshape(-1)
    return (cam.reshape(-1, 3) / norm[:, None]) @ np.diag([-1.0, 1.0, -1.0]), norm


def write_bup20_tree(root: str, width: int = 320, height: int = 180,
                     num_frames: int = 90, center: int = 47,
                     eval_frames: Sequence[int] = (42, 43, 44, 45, 46, 47),
                     train_frames: Sequence[int] = (0, 1, 2), num_spheres: int = 4,
                     supersample: int = 2, seed: int = 0, paeth: bool = False,
                     predictions: Sequence[str] = PREDICTIONS) -> list:
    """Write the tree under ``root`` (a directory named ``BUP_20``) and
    return the frames' timestamps (frame f is ``<ts>.png``). ``paeth``
    filters every PNG row with the Paeth predictor (the slowest to decode);
    else rows are unfiltered. ``predictions`` names the prediction folders
    written (``preds_<name>``; Mask R-CNN's masks are the largest)."""
    seq = os.path.join(root, SEQUENCE)
    for d in ("depth", *(f"preds_{p}" for p in predictions)):
        os.makedirs(os.path.join(seq, d), exist_ok=True)
    scene = default_scene(num_spheres, seed)
    fx = fy = 0.9 * width
    cx, cy = width / 2.0, height / 2.0
    intr = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    mount = _mount()
    stamps = [f"{1600000000000 + 100 * i}" for i in range(num_frames)]
    xs = (np.arange(num_frames) - center) * STEP_M

    # the loader's camera of frame f (window centred on ``center``) sits at
    # (x_f, 0, CAMERA_Z); colour is the mean over ss x ss rays per pixel,
    # labels and depth are taken at the pixel centres
    ss = max(int(supersample), 1)
    dirs, norm = _rays(width, height, fx, fy, cx, cy, 1)
    dirs_ss = _rays(width, height, fx, fy, cx, cy, ss)[0] if ss > 1 else None
    sems, insts = [], []
    for f in range(num_frames):
        origin = np.array([xs[f], 0.0, CAMERA_Z])
        rgb, sem, inst, t = _render_analytic(scene, np.broadcast_to(origin, dirs.shape),
                                             dirs, backdrop=False)
        if ss > 1:
            rgb, _, _, _ = _render_analytic(scene, np.broadcast_to(origin, dirs_ss.shape),
                                            dirs_ss, backdrop=False)
        rgb = rgb.reshape(height, ss, width, ss, 3).mean((1, 3))
        zdepth = (t / norm).reshape(height, width)        # distance -> z-depth
        name = f"{stamps[f]}.png"
        write_png(os.path.join(seq, name), np.round(rgb * 255).astype(np.uint8), paeth)
        write_png(os.path.join(seq, "depth", name),
                  np.round(np.clip(zdepth * 1000.0, 0, 65535)).astype(np.uint16), paeth)
        sems.append(sem.reshape(height, width))
        insts.append(inst.reshape(height, width))

    # Mask2Former-like predictions: (sem, imap, conf) with conf as logits
    # whose sign the loader flips on background pixels before its sigmoid
    preds = add_synthetic_predictions(
        {"semantics": np.stack(sems), "instance": np.stack(insts),
         "semantic_info": {"num_instances": num_spheres + 2}}, seed=seed)
    num_masks = max(int(preds["instance_pred"].max()), 2)
    for f in range(num_frames):
        imap = preds["instance_pred"][f]
        sem = (preds["semantics_pred"][f] > 0).astype(np.uint8)
        conf = np.clip(preds["sem_conf"][f], 1e-4, 1 - 1e-4)
        logit = np.log(conf / (1.0 - conf))
        logit = np.where(imap == 0, -logit, logit).astype(np.float32)
        payloads = {
            "mask2former": lambda: (sem, imap.astype(np.uint8), logit),
            "maskrcnn": lambda: {"masks": _maskrcnn_masks(imap, conf, num_masks)},
            "deeplab": lambda: {"panoptic": np.stack([preds["semantics_pred"][f],
                                                      imap])[None].astype(np.int32)}}
        for p in predictions:
            with open(os.path.join(seq, f"preds_{p}", f"{stamps[f]}.pkl"), "wb") as fh:
                pickle.dump(payloads[p](), fh)

    # odometry: robot poses B_f = T(x_f e_x) mount^-1, so that the camera
    # K_f = B_f mount moves along x and inv(K_f) K_c is a pure translation
    from scipy.spatial.transform import Rotation
    robot = np.tile(np.eye(4), (num_frames, 1, 1))
    robot[:, 0, 3] = xs
    robot = robot @ np.linalg.inv(mount)
    with open(os.path.join(seq, "odometry.csv"), "w") as fh:
        fh.write("#ts,tx,ty,tz,qx,qy,qz,qw\n")
        for f, b in enumerate(robot):
            q = Rotation.from_matrix(b[:3, :3]).as_quat()
            fh.write(",".join([stamps[f]] + [repr(float(v)) for v in (*b[:3, 3], *q)])
                     + "\n")
    # metashape's cameras: the loader scales their translations by 0.03
    shots = robot.copy()
    shots[:, :3, 3] /= 0.03
    np.savez(os.path.join(seq, "metashape_cameras.npz"), shots, np.asarray(stamps))
    with open(os.path.join(seq, "params.yaml"), "w") as fh:
        fh.write(yaml_lite.dump({"intrinsics": intr.tolist(), "extrinsics": mount.tolist()}))

    # COCO: every frame an image; the eval frames' spheres annotated, the
    # first as a polygon, the others as compressed RLE
    images = [{"id": f + 1, "path": f"/datasets/BUP_20/{SEQUENCE}/{stamps[f]}.png",
               "height": height, "width": width, "file_name": f"{stamps[f]}.png"}
              for f in range(num_frames)]
    annotations = []
    for f in eval_frames:
        for k, iid in enumerate(np.unique(insts[f][insts[f] > 0])):
            mask = insts[f] == iid
            cls = int(np.bincount(sems[f][mask]).argmax())
            seg = _polygon(mask) if k == 0 else encode_rle(mask.astype(np.uint8))
            ys, xs_ = np.nonzero(mask)
            annotations.append({
                "id": len(annotations) + 1, "image_id": f + 1, "category_id": cls,
                "iscrowd": 0, "segmentation": [seg] if k == 0 else seg,
                "area": float(mask.sum()),
                "bbox": [float(xs_.min()), float(ys.min()), float(np.ptp(xs_) + 1),
                         float(np.ptp(ys) + 1)]})
    categories = [{"id": 1, "name": "yellow", "supercategory": "pepper"},
                  {"id": 2, "name": "red", "supercategory": "pepper"}]
    with open(os.path.join(root, "BUP_20.json"), "w") as fh:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, fh)
    with open(os.path.join(root, "BUP_20.yaml"), "w") as fh:
        fh.write(yaml_lite.dump({"image_sets": {
            "eval": [f + 1 for f in eval_frames], "train": [f + 1 for f in train_frames]}}))
    return stamps
