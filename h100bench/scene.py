"""The benchmark's frames: the synthetic sphere scene along a crop row.

A camera on a robot drives along x past four coloured spheres in the unit
cube, 1.4 m in front of them and looking at them, as BUP20's camera looks at
the canopy; the frames are the window that BUP20's loader makes around its
centre frame (40 frames each side: odd offsets train, even offsets val).
Colour is the mean over ``supersample``^2 rays a pixel, labels and depth are
taken at the pixel centres, missed rays are white. On top: the noisy
per-frame 2-D predictions of a Mask2Former-like detector (dropped, split,
eroded or dilated masks, per-view instance ids, per-pixel confidence).

The scene renderer and the prediction noise are frozen copies of the
program's synthetic scene (``data/synthetic.py``: ``default_scene``,
``_render_analytic`` without the backdrop, ``add_synthetic_predictions``),
the renderer written in torch so that it runs on the card. The cameras and
rays come from the reference's camera functions. The result is the data
dict that the program's BUP20 reader yields, made in memory. The scene and
its predictions are fixed; ``--seed`` chooses the weights, the rays and the
jitter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .reference.core.camera import (PinholeIntrinsics, extrinsics_params_from_view_matrix,
                                    generate_pinhole_rays, inv_transform_rays,
                                    view_from_c2w)


@dataclasses.dataclass
class SphereScene:
    centers: np.ndarray    # [K, 3]
    radii: np.ndarray      # [K]
    colors: np.ndarray     # [K, 3]
    classes: np.ndarray    # [K] semantic class (1, 2; 0 is background)
    instances: np.ndarray  # [K] instance id (>= 1)


def default_scene(num_spheres: int = 4, seed: int = 0) -> SphereScene:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.45, 0.45, (num_spheres, 3))
    radii = rng.uniform(0.12, 0.22, num_spheres)
    colors = rng.uniform(0.2, 1.0, (num_spheres, 3))
    classes = 1 + (np.arange(num_spheres) % 2)
    instances = np.arange(1, num_spheres + 1)
    return SphereScene(centers, radii, colors, classes, instances)


def render_spheres(scene: SphereScene, origins: torch.Tensor, dirs: torch.Tensor):
    """Closed-form ray/sphere render of rays [N, 3] (float64) -> rgb [N, 3],
    sem [N], inst [N], distance [N] (0 where a ray misses: white)."""
    n, dev = origins.shape[0], origins.device
    best_t = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
    rgb = torch.ones((n, 3), dtype=torch.float64, device=dev)
    sem = torch.zeros(n, dtype=torch.int32, device=dev)
    inst = torch.zeros(n, dtype=torch.int32, device=dev)
    light = torch.tensor([0.5, 0.8, 0.3], dtype=torch.float64, device=dev)
    light = light / torch.linalg.norm(light)
    for c, r, col, cls, iid in zip(scene.centers, scene.radii, scene.colors,
                                   scene.classes, scene.instances):
        c = torch.as_tensor(c, dtype=torch.float64, device=dev)
        oc = origins - c
        b = (oc * dirs).sum(-1)
        disc = b ** 2 - ((oc * oc).sum(-1) - float(r) ** 2)
        t = -b - torch.sqrt(torch.clamp(disc, min=0))
        hit = (disc > 0) & (t > 0) & (t < best_t)
        best_t = torch.where(hit, t, best_t)
        normal = (origins + dirs * t[:, None] - c) / float(r)
        shade = 0.4 + 0.6 * torch.clamp(normal @ light, 0, 1)
        colour = torch.clamp(torch.as_tensor(col, device=dev)[None] * shade[:, None], 0, 1)
        rgb = torch.where(hit[:, None], colour, rgb)
        sem = torch.where(hit, int(cls), sem)
        inst = torch.where(hit, int(iid), inst)
    dist = torch.where(torch.isfinite(best_t), best_t, torch.zeros_like(best_t))
    return rgb, sem, inst, dist


def _shift2d(m: np.ndarray, dy: int, dx: int) -> np.ndarray:
    out = np.zeros_like(m)
    h, w = m.shape
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        m[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return out


def _dilate3(m: np.ndarray) -> np.ndarray:
    out = m.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out |= _shift2d(m, dy, dx)
    return out


def _erode3(m: np.ndarray) -> np.ndarray:
    out = m.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out &= _shift2d(m, dy, dx)
    return out


def synthetic_predictions(sem_gt: np.ndarray, inst_gt: np.ndarray, seed: int = 0,
                          drop_prob: float = 0.15, split_prob: float = 0.2,
                          boundary_noise_prob: float = 0.7):
    """Mask2Former-like predictions of label maps [V, H, W]: (sem_pred,
    inst_pred, conf, the largest predicted id)."""
    v, h, w = inst_gt.shape
    inst_pred = np.zeros_like(inst_gt)
    sem_pred = np.zeros_like(sem_gt)
    conf_all = np.empty((v, h, w), np.float32)
    max_gt = int(inst_gt.max())
    id_class = np.zeros(max_gt + 1, sem_gt.dtype)
    for iid in range(1, max_gt + 1):
        px = inst_gt == iid
        if px.any():
            id_class[iid] = np.bincount(sem_gt[px]).argmax()
    max_pred_id = 0
    for vi in range(v):
        rng = np.random.default_rng(seed * 7919 + vi)
        pool = rng.permutation(np.arange(1, 2 * max_gt + 2)).tolist()
        for iid in np.unique(inst_gt[vi]):
            if iid == 0:
                continue
            mask = inst_gt[vi] == iid
            if rng.random() < drop_prob:
                continue
            parts = [mask]
            if rng.random() < split_prob and mask.sum() >= 40:
                ys, xs = np.nonzero(mask)
                if rng.random() < 0.5:
                    cut = mask & (np.arange(w)[None, :] < xs.mean())
                else:
                    cut = mask & (np.arange(h)[:, None] < ys.mean())
                a, b = mask & cut, mask & ~cut
                if a.sum() >= 10 and b.sum() >= 10:
                    parts = [a, b]
            for part in parts:
                if rng.random() < boundary_noise_prob:
                    part = _erode3(part) if rng.random() < 0.5 else _dilate3(part)
                if not part.any():
                    continue
                pid = pool.pop()
                inst_pred[vi][part] = pid
                sem_pred[vi][part] = id_class[iid]
                max_pred_id = max(max_pred_id, pid)
        lab = inst_pred[vi]
        boundary = np.zeros((h, w), bool)
        for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
            boundary |= _shift2d(lab, dy, dx) != lab
        conf = np.where(lab > 0, 0.95, 0.85).astype(np.float32)
        conf[boundary] = 0.6
        conf += rng.uniform(-0.05, 0.05, (h, w)).astype(np.float32)
        np.clip(conf, 0.05, 1.0, out=conf)
        conf_all[vi] = conf
    return sem_pred, inst_pred, conf_all, max_pred_id


def crop_row_frames(frames: Dict, predictions: bool, dev) -> Dict:
    """The data dict of ``frames`` (a configuration's ``frames`` entry:
    ``size`` [W, H], ``window`` frames each side of the centre, ``step_m``,
    ``camera_z``, ``supersample``, ``num_spheres``), rendered on ``dev``.
    ``predictions`` adds the 2-D predictions and their confidences."""
    width, height = (int(x) for x in frames["size"])
    win = int(frames["window"])
    ss = int(frames["supersample"])
    scene = default_scene(int(frames["num_spheres"]), 0)
    fx = np.float32(0.9 * width)
    intr = PinholeIntrinsics(fx=fx, fy=fx, cx=np.float32(width / 2.0),
                             cy=np.float32(height / 2.0), width=width, height=height,
                             near=0.0, far=2.0)
    # train frames at odd offsets -win-1..win+1, val frames at even offsets
    # -win..win, in offset order as the window loader lists them
    train_off = np.arange(-win - 1, win + 2, 2)
    val_off = np.arange(-win, win + 1, 2)
    offsets = np.concatenate([train_off, val_off])
    c2w = np.tile(np.diag([-1.0, 1.0, -1.0, 1.0]), (len(offsets), 1, 1))
    c2w[:, 0, 3] = offsets * float(frames["step_m"])
    c2w[:, 2, 3] = float(frames["camera_z"])
    views = view_from_c2w(c2w).astype(np.float32)

    base = generate_pinhole_rays(intr, dist_min=0.0, dist_max=2.0)
    params = extrinsics_params_from_view_matrix(torch.from_numpy(views))
    n = len(views)
    bo = base.origins.reshape(1, -1, 3).expand(n, height * width, 3)
    bd = base.dirs.reshape(1, -1, 3).expand(n, height * width, 3)
    wo, wd = inv_transform_rays(params, bo, bd)
    wd = wd / (torch.linalg.norm(wd, dim=-1, keepdim=True) + 1e-12)

    # colour over an ss x ss grid a pixel, in float64 on the device
    sub = (torch.arange(ss, dtype=torch.float64, device=dev) + 0.5) / ss
    px = torch.arange(width, dtype=torch.float64, device=dev)[None, :, None, None] + sub[None, None, None, :]
    py = torch.arange(height, dtype=torch.float64, device=dev)[:, None, None, None] + sub[None, None, :, None]
    px, py = torch.broadcast_tensors(px, py)                              # [H, W, ss, ss]
    cam = torch.stack([(px - float(intr.cx)) / float(fx), -(py - float(intr.cy)) / float(fx),
                       -torch.ones_like(px)], -1).reshape(-1, 3)
    cam = cam / torch.linalg.norm(cam, dim=-1, keepdim=True)
    centre_dirs = wd.to(dev, torch.float64).reshape(n, -1, 3)
    imgs, sems, insts, depths = [], [], [], []
    for i in range(n):
        origin = torch.as_tensor(c2w[i, :3, 3], dtype=torch.float64, device=dev)
        rot = torch.as_tensor(c2w[i, :3, :3], dtype=torch.float64, device=dev)
        d_ss = cam @ rot.T
        rgb, _, _, _ = render_spheres(scene, origin.expand_as(d_ss), d_ss)
        _, sem, inst, dist = render_spheres(scene, origin.expand_as(centre_dirs[i]),
                                            centre_dirs[i])
        imgs.append(rgb.reshape(height, width, ss * ss, 3).mean(2))
        sems.append(sem.reshape(height, width))
        insts.append(inst.reshape(height, width))
        depths.append(dist.reshape(height, width))
    data = {
        "imgs": torch.stack(imgs).float().cpu().numpy(),
        "semantics": torch.stack(sems).cpu().numpy(),
        "instance": torch.stack(insts).cpu().numpy(),
        "depths": torch.stack(depths).float().cpu().numpy(),
        "rays_origins": wo.reshape(n, height, width, 3).numpy(),
        "rays_dirs": wd.reshape(n, height, width, 3).numpy(),
        "base_rays_origins": base.origins.numpy(),
        "base_rays_dirs": base.dirs.numpy(),
        "view_matrices": views,
        "cameras_ts": offsets.astype(np.int64),
        "intrinsics": intr,
        "train_idxs": np.arange(len(train_off)),
        "val_idxs": np.arange(len(train_off), n),
        "semantic_info": {"class_id_to_name": {0: "bg", 1: "pepper"}, "num_classes": 2,
                          "classes_present": [0, 1], "num_present_classes": 2,
                          "stuff_ids": [0], "things_ids": [1], "num_instances": 200},
        "scene": scene,
    }
    # BUP20 has one thing class: both sphere classes are peppers
    data["semantics"] = (data["semantics"] > 0).astype(np.int32)
    if predictions:
        sem_p, inst_p, conf, _ = synthetic_predictions(data["semantics"], data["instance"])
        data.update(semantics_pred=sem_p.astype(np.int32), instance_pred=inst_p.astype(np.int32),
                    sem_conf=conf, inst_conf=conf.copy())
    return data
