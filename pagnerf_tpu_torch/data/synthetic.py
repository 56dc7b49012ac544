"""Synthetic multiview panoptic dataset (counterpart of
``pagnerf_tpu/data/synthetic.py``).

A numpy copy of the JAX package's analytic sphere scene: K coloured spheres
in the unit cube with semantic classes and instance ids, rendered in closed
form from a ring of cameras. ``make_dataset`` returns arrays bit-identical
to the JAX package's for the same arguments, and so does
``add_synthetic_predictions``, the noisy per-frame 2-D predictions that
validation reports its ``_pred`` baselines against (the tests check both).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..core.camera import PinholeIntrinsics, view_from_c2w


@dataclasses.dataclass
class SphereScene:
    centers: np.ndarray    # [K, 3]
    radii: np.ndarray      # [K]
    colors: np.ndarray     # [K, 3]
    classes: np.ndarray    # [K] semantic class id (>= 1; 0 = background/stuff)
    instances: np.ndarray  # [K] instance id (>= 1; 0 = background)


def default_scene(num_spheres: int = 4, seed: int = 0) -> SphereScene:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.45, 0.45, (num_spheres, 3))
    radii = rng.uniform(0.12, 0.22, num_spheres)
    colors = rng.uniform(0.2, 1.0, (num_spheres, 3))
    classes = 1 + (np.arange(num_spheres) % 2)
    instances = np.arange(1, num_spheres + 1)
    return SphereScene(centers, radii, colors, classes, instances)


def _ring_c2w(idx: int, num: int, radius: float = 2.2, height: float = 0.4) -> np.ndarray:
    """Camera-to-world pose on an undulating ring, GL convention (camera looks
    down -z at the origin). Height and radius vary sinusoidally around the ring:
    a constant-height ring is a 1-D viewpoint manifold with no vertical parallax,
    which leaves the backdrop ill-constrained vertically and caps novel-view
    quality regardless of training (real robot sequences move in 2+ dims too)."""
    ang = 2 * np.pi * idx / num
    h = height + 0.35 * np.sin(3.0 * ang)
    r = radius + 0.15 * np.cos(2.0 * ang)
    eye = np.array([r * np.cos(ang), h, r * np.sin(ang)])
    fwd = -eye / np.linalg.norm(eye)                 # toward origin
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up); right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, up, -fwd   # GL: z backward
    c2w[:3, 3] = eye
    return c2w


def _render_analytic(scene: SphereScene, origins: np.ndarray, dirs: np.ndarray,
                     backdrop: bool = True):
    """Closed-form ray/sphere render. origins/dirs [N, 3] -> rgb [N,3], sem [N],
    inst [N], depth [N]. ``backdrop`` adds a checkered ground+back plane (class 0,
    instance 0) so most rays hit geometry — like the real BUP20 canopy scenes, where
    alpha ~= 1 everywhere and the semantic NLL is well-conditioned."""
    n = origins.shape[0]
    best_t = np.full(n, np.inf)
    rgb = np.ones((n, 3), np.float32)
    sem = np.zeros(n, np.int32)
    inst = np.zeros(n, np.int32)
    if backdrop:
        # The inside of the [-0.9, 0.9]^3 box acts as the background surface: rays
        # terminate on the box EXIT face (cameras orbit outside the box, so the far
        # wall is what they see behind the spheres).
        safe = np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
        ta = (0.9 - origins) / safe
        tb = (-0.9 - origins) / safe
        t_enter = np.minimum(ta, tb).max(axis=1)
        t_exit = np.minimum(np.maximum(ta, tb).min(axis=1), 1e9)
        # a ray MISSES the box when entry > exit; painting those corner rays
        # with a phantom wall sample would be multiview-INCONSISTENT GT (each
        # view sees a different off-surface point — the exact supervision
        # hazard this module exists to avoid). Missed rays keep the white bg.
        ok = (t_enter <= t_exit) & (t_exit > 0)
        p = origins + dirs * t_exit[:, None]
        # Smooth (band-limited) wall texture. A hard floor()-checker point-sampled
        # at pixel centres aliases with a different phase in every view, making the
        # multi-view supervision mutually inconsistent at the wall — which caps any
        # 3-D-consistent reconstruction (NeRF or otherwise) at ~16-17 dB PSNR. The
        # sine product keeps per-pixel texture (alpha ~= 1 scenes, semantic NLL
        # well-conditioned) while staying consistent across views.
        wave = (np.sin(8.0 * p[:, 0]) + np.sin(8.0 * p[:, 1])
                + np.sin(8.0 * p[:, 2])) / 3.0
        base = 0.5 + 0.35 * wave
        rgb[ok] = np.stack([base, base * 1.05, base * 0.95], -1)[ok]
        best_t[ok] = t_exit[ok]
    for c, r, col, cls, iid in zip(scene.centers, scene.radii, scene.colors,
                                   scene.classes, scene.instances):
        oc = origins - c
        b = np.einsum("nd,nd->n", oc, dirs)
        disc = b ** 2 - (np.einsum("nd,nd->n", oc, oc) - r ** 2)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit &= (t > 0) & (t < best_t)
        best_t[hit] = t[hit]
        # simple lambertian shading from a fixed light for texture
        p = origins[hit] + dirs[hit] * t[hit, None]
        normal = (p - c) / r
        light = np.array([0.5, 0.8, 0.3]); light = light / np.linalg.norm(light)
        shade = 0.4 + 0.6 * np.clip(normal @ light, 0, 1)
        rgb[hit] = np.clip(col[None] * shade[:, None], 0, 1)
        sem[hit] = cls
        inst[hit] = iid
    depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
    return rgb, sem, inst, depth


def _shift2d(m: np.ndarray, dy: int, dx: int) -> np.ndarray:
    out = np.zeros_like(m)
    h, w = m.shape
    ys = slice(max(dy, 0), h + min(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[ys, xs] = m[yd, xd]
    return out


def _dilate3(m: np.ndarray) -> np.ndarray:
    """3x3 binary dilation via shifts (no scipy dependency)."""
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


def add_synthetic_predictions(data: Dict, seed: int = 0, drop_prob: float = 0.15,
                              split_prob: float = 0.2,
                              boundary_noise_prob: float = 0.7) -> Dict:
    """Attach Mask2Former-like per-frame predictions to a synthetic data dict.

    Models the properties of the reference's real 2-D supervision (its
    Mask2Former predictions; the paper's whole point is lifting
    *inconsistent* per-frame predictions to a consistent 3-D panoptic field):

      * **per-view instance-ID permutation** — each view assigns its detections
        arbitrary ids from a shuffled pool, so the same sphere has a different id
        in every view (2-D networks carry no cross-frame identity);
      * **dropped detections** — a visible instance is missed entirely with
        ``drop_prob`` (its pixels fall back to background in sem+inst preds);
      * **split masks** — with ``split_prob`` a detection is broken into two ids
        along a random axis through its centroid (over-segmentation);
      * **boundary noise** — each surviving mask is randomly eroded or dilated by
        one pixel (mask-boundary jitter);
      * **per-pixel confidence** — sigmoid-like maps in (0, 1): high in mask
        interiors and confident background, low in the boundary band (mirroring
        the reference's ``sigmoid(conf)`` with negated background logits).

    Adds ``semantics_pred`` / ``instance_pred`` / ``sem_conf`` / ``inst_conf``
    channels ([V, H, W]) and raises ``semantic_info.num_instances`` to cover the
    per-view id space. GT channels are left untouched (metrics baseline).
    """
    inst_gt = np.asarray(data["instance"])
    sem_gt = np.asarray(data["semantics"])
    v, h, w = inst_gt.shape
    inst_pred = np.zeros_like(inst_gt)
    sem_pred = np.zeros_like(sem_gt)
    sem_conf = np.empty((v, h, w), np.float32)
    inst_conf = np.empty((v, h, w), np.float32)
    # class of each GT instance id (things only; 0 stays background)
    max_gt = int(inst_gt.max())
    id_class = np.zeros(max_gt + 1, sem_gt.dtype)
    for iid in range(1, max_gt + 1):
        px = inst_gt == iid
        if px.any():
            id_class[iid] = np.bincount(sem_gt[px]).argmax()

    max_pred_id = 0
    for vi in range(v):
        rng = np.random.default_rng(seed * 7919 + vi)
        # per-view shuffled id pool: detection k gets an arbitrary id
        pool = rng.permutation(np.arange(1, 2 * max_gt + 2)).tolist()
        for iid in np.unique(inst_gt[vi]):
            if iid == 0:
                continue
            mask = inst_gt[vi] == iid
            if rng.random() < drop_prob:
                continue                       # missed detection
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
        # confidence: interior high, boundary band low, background confident
        lab = inst_pred[vi]
        boundary = np.zeros((h, w), bool)
        for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
            boundary |= _shift2d(lab, dy, dx) != lab
        conf = np.where(lab > 0, 0.95, 0.85).astype(np.float32)
        conf[boundary] = 0.6
        conf += rng.uniform(-0.05, 0.05, (h, w)).astype(np.float32)
        np.clip(conf, 0.05, 1.0, out=conf)
        sem_conf[vi] = conf
        inst_conf[vi] = conf

    data = dict(data)
    data["semantics_pred"] = sem_pred
    data["instance_pred"] = inst_pred
    data["sem_conf"] = sem_conf
    data["inst_conf"] = inst_conf
    si = dict(data["semantic_info"])
    si["num_instances"] = max(si["num_instances"], max_pred_id + 2)
    data["semantic_info"] = si
    return data


def _pixel_dirs(width: int, height: int, focal: float, ss: int = 1) -> np.ndarray:
    """Camera-space ray dirs through an ss x ss sub-pixel grid, GL convention."""
    px, py = np.meshgrid((np.arange(width * ss) + 0.5) / ss,
                         (np.arange(height * ss) + 0.5) / ss)
    x = (px - width / 2) / focal
    y = (py - height / 2) / focal
    dirs = np.stack([x, -y, -np.ones_like(x)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.reshape(-1, 3).astype(np.float32)


def make_dataset(num_views: int = 8, width: int = 40, height: int = 30,
                 num_spheres: int = 4, seed: int = 0,
                 pose_noise: float = 0.0, supersample: int = 3) -> Dict:
    """Build the full data dict. ``pose_noise`` perturbs train poses to exercise the
    BA path (reference --add-noise-to-train-poses, bup20.py:276-279).

    ``supersample``: RGB ground truth is rendered on an ss x ss sub-pixel grid and
    box-averaged, making every image the true pixel integral of one consistent 3-D
    scene. Point-sampled GT of hard edges (sphere silhouettes) aliases with a
    different phase per view, which makes the views mutually inconsistent and caps
    any 3-D-consistent reconstruction several dB below the scene's real ceiling.
    Labels and depth stay point-sampled at pixel centres (labels don't average).
    """
    scene = default_scene(num_spheres, seed)
    focal = 0.9 * width
    intr = PinholeIntrinsics(fx=np.float32(focal), fy=np.float32(focal),
                             cx=np.float32(width / 2), cy=np.float32(height / 2),
                             width=width, height=height)

    ss = max(int(supersample), 1)
    base_dirs = _pixel_dirs(width, height, focal, 1)      # pixel centres
    ss_dirs = _pixel_dirs(width, height, focal, ss) if ss > 1 else base_dirs

    rng = np.random.default_rng(seed + 1)
    imgs, sems, insts, depths, views, world_o, world_d = [], [], [], [], [], [], []
    for i in range(num_views):
        c2w = _ring_c2w(i, num_views)
        o = np.broadcast_to(c2w[:3, 3], base_dirs.shape).astype(np.float32)
        d = (base_dirs @ c2w[:3, :3].T).astype(np.float32)
        _, sem, inst, depth = _render_analytic(scene, o, d)
        if ss > 1:
            o_ss = np.broadcast_to(c2w[:3, 3], ss_dirs.shape).astype(np.float32)
            d_ss = (ss_dirs @ c2w[:3, :3].T).astype(np.float32)
            rgb_ss, _, _, _ = _render_analytic(scene, o_ss, d_ss)
            rgb = rgb_ss.reshape(height, ss, width, ss, 3).mean((1, 3)).reshape(-1, 3)
        else:
            rgb, _, _, _ = _render_analytic(scene, o, d)
        imgs.append(rgb.reshape(height, width, 3))
        sems.append(sem.reshape(height, width))
        insts.append(inst.reshape(height, width))
        depths.append(depth.reshape(height, width))
        world_o.append(o.reshape(height, width, 3))
        world_d.append(d.reshape(height, width, 3))
        noisy = c2w.copy()
        # TRAIN poses only (even idxs — MultiviewDataset interleave), keeping
        # the BA anchor frame 0 clean, like the reference (bup20.py:123-130:
        # split=='train' and i>0). Noising val poses would misalign BA-mode
        # validation renders against GT rendered from the true poses.
        if pose_noise > 0 and i > 0 and i % 2 == 0:
            noisy[:3, 3] += rng.normal(0, pose_noise, 3)
        views.append(view_from_c2w(noisy))

    num_classes = int(scene.classes.max()) + 1
    data = {
        "imgs": np.stack(imgs).astype(np.float32),
        "semantics": np.stack(sems),
        "instance": np.stack(insts),
        "sem_conf": np.ones((num_views, height, width), np.float32),
        "inst_conf": np.ones((num_views, height, width), np.float32),
        "depths": np.stack(depths),
        "rays_origins": np.stack(world_o),
        "rays_dirs": np.stack(world_d),
        "base_rays_origins": np.zeros((height, width, 3), np.float32),
        "base_rays_dirs": base_dirs.reshape(height, width, 3),
        "view_matrices": np.stack(views).astype(np.float32),
        "cameras_ts": np.arange(num_views),
        "intrinsics": intr,
        "semantic_info": {
            "num_classes": num_classes,
            "num_instances": num_spheres + 2,
            "stuff_ids": [0],
            "things_ids": list(range(1, num_classes)),
        },
        "scene": scene,
    }
    return data
