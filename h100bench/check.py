"""How ``correct`` is decided: the plain reference (``h100bench/reference``)
run over the inputs the benchmark handed the program, and the numbers that
compare the two.

Training: the reference follows the program's first three steps from the
same weights, batches and jitter; compared are each step's total loss, the
first gradient as the optimizer got it (the program's from its Adam state
after one step, mu / (1 - beta1)) and the parameters' change after the three
steps, both by the worst leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger. Leaves whose reference gradient is under a thousandth
of the median leaf's are left out (their moves are round-off under Adam).
The batches' rows are checked against the frames exactly.

Rendering: the reference renders the sampled views that the window
finished; compared is the widest gap of any channel, over that view's and
channel's largest reference value.

The control is the reference itself with TF32 matmuls on, in the
program's place: ``tf32=True``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference.build import build_pipeline, occupancy, stage_for_epoch
from .reference.core.rays import Rays
from .reference.models.pipeline import BAPipeline
from .reference.ops.raymarch import raymarch
from .reference.train.step import Adam, leaf_norm, train_step

EXCLUDE_BELOW = 1e-3
# the reading of every number where the reference cannot follow the program's
# steps (JSON has no infinity)
UNFOLLOWED = 1e30
TRAIN_NUMBERS = ("loss_gap", "grad_gap", "grad_median_gap", "change_gap",
                 "change_median_gap")


def _precision(tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)


def _ref_pipeline(settings, data, weights, dev):
    from .harness import load_weights
    pipe = build_pipeline(settings, data, dev)
    load_weights(pipe, weights)
    pipe.requires_grad_(True)
    return pipe


def batch_rows_mismatch(batch: Dict[str, np.ndarray], data: Dict) -> int:
    """Rows of a sampled batch that are not their frame's pixel (the pixel
    found from the camera-space ray), plus repeated pixels of one image."""
    intr = data["intrinsics"]
    d = np.asarray(batch["base_rays_dirs"], np.float64)
    px = d[..., 0] / -d[..., 2] * float(intr.fx) + float(intr.cx)
    py = float(intr.cy) - d[..., 1] / -d[..., 2] * float(intr.fy)
    col = np.rint(px - 0.5).astype(np.int64)
    row = np.rint(py - 0.5).astype(np.int64)
    bad = 0
    for b, cam in enumerate(np.asarray(batch["cam_idx"]).astype(np.int64)):
        flat = row[b] * intr.width + col[b]
        bad += len(flat) - len(np.unique(flat))
        for key in ("imgs", "semantics", "instance", "semantics_pred", "instance_pred"):
            if key in batch:
                want = data[key][cam].reshape(intr.height * intr.width, *data[key].shape[3:])
                rows_ok = np.all(np.asarray(batch[key][b]).reshape(len(flat), -1)
                                 == want[flat].reshape(len(flat), -1), axis=1)
                bad += int((~rows_ok).sum())
    return bad


def reference_train(settings: Dict, data: Dict, weights: Dict, epoch: int, pruned: bool,
                    batches: List[Dict], jitters: List[List[torch.Tensor]], dev,
                    tf32: bool = False) -> Dict:
    """The reference's three steps: {"losses": [total per step], "grad":
    {leaf: norm of step 1's gradient}, "change": {leaf: norm of the change
    after the steps}}."""
    _precision(tf32)
    try:
        pipe = _ref_pipeline(settings, data, weights, dev)
        occ = occupancy(settings, data["scene"], pruned, dev)
        frac = float(occ.mask.float().mean())
        stage = stage_for_epoch(settings, epoch, data, pruned, frac, occ.res,
                                isinstance(pipe, BAPipeline))
        params = dict(pipe.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        opt = Adam(settings, params)
        losses, terms, grad = [], [], {}
        for k, (batch, jit) in enumerate(zip(batches, jitters)):
            tb = {key: torch.as_tensor(np.asarray(v)).to(dev) for key, v in batch.items()
                  if isinstance(v, np.ndarray)}
            out, grads = train_step(pipe, opt, stage, settings, tb,
                                    [j.to(dev) for j in jit], occ, data["semantic_info"])
            losses.append(out["total_loss"])
            terms.append(out)
            if k == 0:
                grad = {n: leaf_norm(g) for n, g in grads.items()}
        change = {n: leaf_norm(params[n].detach() - start[n]) for n in params}
        return {"losses": losses, "terms": terms, "grad": grad, "change": change}
    finally:
        _precision(False)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """max over kept leaves of |prog - ref| / max(ref, median ref)."""
    vals = [ref[n] for n in keep]
    if not vals:
        return 0.0
    med = float(np.median(vals))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in keep)


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    live = [v for v in ref_grad.values() if v > 0]
    if not live:
        return []
    med = float(np.median(live))
    return sorted(n for n, v in ref_grad.items() if v >= EXCLUDE_BELOW * med)


def train_details(prog: Dict, ref: Dict, top: int = 6) -> List[str]:
    """Lines for standard error: each step's loss terms on both sides and
    the leaves with the widest gaps."""
    nums = train_numbers(prog, ref)
    lines = [f"number {k}: {v!r}" for k, v in nums.items()]
    lines += [f"step {k + 1} {name}: program {p.get(name)!r} reference {r.get(name)!r}"
             for k, (p, r) in enumerate(zip(prog.get("terms", []), ref.get("terms", [])))
             for name in sorted(r)]
    keep = kept_leaves(ref["grad"])
    med_g = float(np.median([ref["grad"][n] for n in keep])) if keep else 0.0
    med_c = float(np.median([ref["change"][n] for n in keep])) if keep else 0.0
    worst = sorted(keep, key=lambda n: -abs(prog["change"][n] - ref["change"][n])
                   / max(ref["change"][n], med_c, 1e-30))[:top]
    worst_g = sorted(keep, key=lambda n: -abs(prog["grad"][n] - ref["grad"][n])
                     / max(ref["grad"][n], med_g, 1e-30))[:2]
    lines += [f"leaf {n}: grad {prog['grad'][n]!r} / {ref['grad'][n]!r} (median {med_g!r}), "
              f"change {prog['change'][n]!r} / {ref['change'][n]!r} (median {med_c!r})"
              for n in worst_g + worst]
    return lines


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a training cell may compare (its limits file names
    those it does): the worst step's loss gap, the first gradient's worst
    and median leaf, and the change's worst and median leaf after the
    steps."""
    keep = kept_leaves(ref["grad"])
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    def median_gap(key):
        med = float(np.median([ref[key][n] for n in keep])) if keep else 0.0
        return float(np.median([abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med, 1e-30)
                                for n in keep])) if keep else 0.0
    return {"loss_gap": float(max(gaps)),
            "grad_gap": float(leaf_gap(prog["grad"], ref["grad"], keep)),
            "grad_median_gap": median_gap("grad"),
            "change_gap": float(leaf_gap(prog["change"], ref["change"], keep)),
            "change_median_gap": median_gap("change"),
            "leaves_compared": len(keep)}


# ------------------------------------------------------------------ render
@torch.no_grad()
def _ref_batch_render(pipe, occ, stage: Dict, rays: Rays, channels, cam_idx: int,
                      render_batch: int):
    """The chunked render: the view's base rays through the camera's
    extrinsics, chunks of ``render_batch`` rays, each chunk's packed budget
    doubled until it holds every valid sample (dense once it would reach the
    march's steps)."""
    cfg = pipe.tracer_cfg.__class__(**{**pipe.tracer_cfg.__dict__,
                                       "raymarch_type": stage["raymarch_type"],
                                       "num_steps": stage["num_steps"], "compact_steps": 0,
                                       "pack_steps": stage["pack_steps"]})
    dev = occ.mask.device
    flat = Rays(origins=rays.origins.to(dev, torch.float32),
                dirs=rays.dirs.to(dev, torch.float32), dist_min=rays.dist_min,
                dist_max=rays.dist_max).reshape(-1)
    if isinstance(pipe, BAPipeline):
        flat = pipe.transform_rays(flat.reshape(1, -1), torch.tensor([cam_idx], device=dev))
    outs = {c: [] for c in channels}
    n = flat.origins.shape[0]
    for i in range(0, n, render_batch):
        chunk = Rays(origins=flat.origins[i:i + render_batch], dirs=flat.dirs[i:i + render_batch],
                     dist_min=0.0, dist_max=6.0)
        m = chunk.origins.shape[0]
        ccfg = cfg
        if cfg.pack_steps:
            valid = int(raymarch(chunk, occ, cfg.num_steps, cfg.raymarch_type, None,
                                 cfg.ray_max_travel).mask.sum())
            p = cfg.pack_steps
            while p < cfg.num_steps and p * m < valid:
                p *= 2
            ccfg = cfg.__class__(**{**cfg.__dict__, "pack_steps": 0 if p >= cfg.num_steps else p})
        rb = pipe(chunk, frozenset(channels), occ, None, stage="val", tracer_cfg=ccfg)
        for c in channels:
            outs[c].append(getattr(rb, c).float())
    return {c: torch.cat(v).cpu().numpy() for c, v in outs.items()}


def reference_render(settings: Dict, data: Dict, weights: Dict, epoch: int, pruned: bool,
                     views: List[int], channels, dev, tf32: bool = False) -> List[Dict]:
    _precision(tf32)
    try:
        pipe = _ref_pipeline(settings, data, weights, dev)
        occ = occupancy(settings, data["scene"], pruned, dev)
        frac = float(occ.mask.float().mean())
        stage = stage_for_epoch(settings, epoch, data, pruned, frac, occ.res,
                                isinstance(pipe, BAPipeline))
        rays = Rays(origins=torch.as_tensor(data["base_rays_origins"].reshape(-1, 3)),
                    dirs=torch.as_tensor(data["base_rays_dirs"].reshape(-1, 3)),
                    dist_min=0.0, dist_max=6.0)
        rbatch = settings["render_batch"] or 8000
        return [_ref_batch_render(pipe, occ, stage, rays, channels, v, rbatch) for v in views]
    finally:
        _precision(False)


def render_gap(prog: List[Dict], ref: List[Dict]) -> float:
    """The widest gap of any sampled view and channel, over that channel's
    largest reference value in the view."""
    worst = 0.0
    for p, r in zip(prog, ref):
        for c in r:
            scale = max(float(np.abs(r[c]).max()), 1e-30)
            worst = max(worst, float(np.abs(p[c].reshape(r[c].shape) - r[c]).max()) / scale)
    return worst


