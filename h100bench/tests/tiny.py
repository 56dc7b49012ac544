"""A checkout-like directory of tiny cells for the CPU tests: the real
configurations with their sizes cut (levels, tables, widths, frames, rays,
steps), the real traffic mixes with short windows, the real metric readers
and limits files made for the tiny cells."""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "h100bench")

TINY = {"num_lods": 4, "capacity_log_2": 10, "delta_capacity_log_2": 10, "codebook_bitwidth": 10,
        "hidden_dim": 16, "sem_hidden_dim": 16, "inst_hidden_dim": 16, "num_steps": 24,
        "batch_size": 2, "num_rays_sampled_per_img": 16, "blas_level": 5, "render_batch": 40}
FRAMES = {"size": [12, 8], "window": 3}
CELLS = {"pagnerf_best.train_panoptic": ("pagnerf_best", "train_panoptic"),
         "panoptic_nerf_hash.train": ("panoptic_nerf_hash", "train"),
         "pagnerf_best.train_rgb_dense": ("pagnerf_best", "train_rgb_dense"),
         "pagnerf_best.render_val": ("pagnerf_best", "render_val")}


# the render cell, which BENCHMARK.json leaves out for now (its runs spread
# too widely to bound), with its metrics: its driver and readers stay tested
RENDER_CELL = {"name": "pagnerf_best.render_val", "config": "pagnerf_best",
               "traffic": "render_val", "chips": 1, "why": "the chunked render of val views"}
RENDER_METRICS = {
    "end_to_end": [{"name": "render_rays_per_s", "unit": "rays/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock"},
                   {"name": "view_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock"}],
    "per_layer": [{"name": n, "unit": "%", "better": b, "source": "device_trace", "layer": layer,
                   "moves": "render_rays_per_s"}
                  for n, b, layer in (("idle_share.render", "lower", "device"),
                                      ("mfu.render", "higher", "chunked render"),
                                      ("roofline.encode_fwd.render", "higher", "fused encode"))]}


def _load(path):
    with open(path) as f:
        return json.load(f)


def make_root(root: str, limits=None, cells=CELLS) -> str:
    """Write the tiny checkout under ``root``; ``limits`` replaces the
    limits of every cell (default: the real files' keys at 1e-4, mismatches
    at 0)."""
    bench = _load(os.path.join(REPO, "BENCHMARK.json"))
    if RENDER_CELL["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(RENDER_CELL)
        for kind, metrics in RENDER_METRICS.items():
            bench[kind] += [{**m, "workloads": [RENDER_CELL["name"]]} for m in metrics]
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, "h100bench", sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(root, "h100bench", "metrics"),
                    dirs_exist_ok=True)
    for c in bench["configs"]:
        cfg = _load(os.path.join(REPO, c["file"]))
        cfg["settings"].update(TINY)
        cfg["frames"].update(FRAMES)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name, (_, traffic) in cells.items():
        t = _load(os.path.join(BENCH, "traffic", traffic + ".json"))
        t.update({"trace_epochs": 1, "trace_views": 2, "warm_views": 1, "check_views": 2})
        with open(os.path.join(root, "h100bench", "traffic", traffic + ".json"), "w") as f:
            json.dump(t, f)
        lim = _load(os.path.join(BENCH, "limits", name + ".json"))
        lim = limits if limits is not None else {k: (0 if "mismatch" in k else 1e-4)
                                                 for k in lim}
        with open(os.path.join(root, "h100bench", "limits", name + ".json"), "w") as f:
            json.dump(lim, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
