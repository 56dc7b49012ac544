"""The render driver: ``PanopticTrainer.batch_render`` of one validation
view after another (a closed loop, one client), every channel that
validation reads copied to the host as validation reads it.

Set-up builds the trainer through the program's factory, loads the weights
drawn from the seed, sets the scene fixture's occupancy and the epoch whose
stage the render follows, and renders ``warm_views`` views. The window
renders views in an order drawn from the seed until ``--seconds`` have
passed; a view is timed from its request until its channels are on the
host. A reservoir drawn from the seed keeps ``check_views`` of the finished
views, which the reference renders once the window has closed.
"""
from __future__ import annotations

import random
import time
from typing import Dict

import numpy as np
import torch

from . import check, harness, probes as probes_mod, tracing
from .reference.build import build_nef
from .train import _sync, apply_fixture

# views rendered after the traced window with the host recorded
LABEL_VIEWS = 3


def run(cell: Dict, seed: int, seconds: float, trace: bool, t_start: float, dev,
        control: bool = False, alter=None) -> Dict:
    from pagnerf_tpu_torch.core.rays import Rays
    from .scene import crop_row_frames
    cfg_file, traffic = cell["config"], cell["traffic"]
    settings = harness.settings_of(cfg_file, traffic)
    epoch, pruned = int(traffic["epoch"]), bool(traffic["pruned"])
    channels = set(traffic["channels"])
    data = crop_row_frames(cfg_file["frames"], cfg_file["frames"]["predictions"], dev)
    pipe, ds, trainer = harness.build_program(settings, data, dev, seed,
                                              lambda s: torch.rand(tuple(s), device=dev))
    shapes = {n: tuple(p.shape) for n, p in pipe.named_parameters()}
    weights = harness.make_weights(shapes, cfg_file["weights"], seed, dev)
    harness.load_weights(pipe, weights)
    if pruned:
        apply_fixture(trainer, data, dev)
    trainer.epoch = epoch + 1
    base = Rays(origins=torch.as_tensor(data["base_rays_origins"].reshape(-1, 3), device=dev),
                dirs=torch.as_tensor(data["base_rays_dirs"].reshape(-1, 3), device=dev),
                dist_min=0.0, dist_max=6.0)
    views = [int(v) for v in ds.val_idxs]
    order = np.random.default_rng(int(seed)).permutation(views)
    pick = random.Random(int(seed))

    def render(view: int) -> Dict[str, np.ndarray]:
        rb = trainer.batch_render(base, channels, cam_idx=view)
        out = {c: getattr(rb, c).cpu().numpy() for c in sorted(channels)}
        if alter is not None:
            alter(out)
        return out

    probes = None
    if trace:
        probes = probes_mod.Probes(settings, build_nef(settings, data["semantic_info"]).to("cpu"),
                                   dev)
    with probes_mod.installed(probes):
        for i in range(int(traffic["warm_views"])):
            render(int(order[i % len(order)]))
        _sync(dev)
        setup_s = time.perf_counter() - t_start
        before = probes.read() if probes else None
        keep, kept_views, done, lat = int(traffic["check_views"]), [], 0, []
        limit = None if trace else seconds
        with tracing.profiled(trace) as prof:
            t0 = time.perf_counter()
            while True:
                view = int(order[done % len(order)])
                t_req = time.perf_counter()
                with torch.profiler.record_function("bench.view"):
                    out = render(view)
                lat.append(time.perf_counter() - t_req)
                # a reservoir of the finished views, drawn from the seed
                if len(kept_views) < keep:
                    kept_views.append((view, out))
                else:
                    j = pick.randrange(done + 1)
                    if j < keep:
                        kept_views[j] = (view, out)
                done += 1
                if limit is not None and time.perf_counter() - t0 >= limit:
                    break
                if limit is None and done >= int(traffic["trace_views"]):
                    break
            window = time.perf_counter() - t0
        counters = probes_mod.difference(probes.read(), before) if probes else None
        labels = None
        if trace:
            # a few more views with the host recorded, for the idle gaps' labels
            with tracing.profiled(True, labelled=True) as lab:
                for i in range(LABEL_VIEWS):
                    render(int(order[(done + i) % len(order)]))
                _sync(dev)
            labels = tracing.summarize(lab.events)["idle_gaps"]
    rays = done * base.origins.shape[0]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    record = {"window_s": window, "views": done, "rays": rays, "counters": counters,
              "setup_s": setup_s, "rays_per_s": rays / window,
              "view_ms_p95": float(np.percentile(np.asarray(lat) * 1e3, 95)),
              "trace": tracing.summarize(prof.events, window) if trace and prof.events
              else None,
              "labels": labels, "peak": peak}
    del trainer, pipe, ds
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = [v for v, _ in kept_views]
    ref = check.reference_render(settings, data, weights, epoch, pruned, sample, channels, dev)
    prog = [o for _, o in kept_views]
    if control:
        prog = check.reference_render(settings, data, weights, epoch, pruned, sample, channels,
                                      dev, tf32=True)
    record["numbers"] = {"render_gap": check.render_gap(prog, ref), "views_compared": len(ref)}
    record["details"] = [f"number {k}: {v!r}" for k, v in record["numbers"].items()]
    record["attempted"] = done
    return record
