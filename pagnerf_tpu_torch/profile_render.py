"""Where the flagship render's time goes, on the CUDA card.

    python -m pagnerf_tpu_torch.profile_render

Prints one JSON object: the render's wall time (host clock around a
synchronised render, median of 5), the device time of each stage of the
render run on its own (CUDA events, median of 5: ray transform + march,
lattice + gather (the fused dual encode), decoders, compositing), and the top device
kernels of one profiled render and their summed device time
(``torch.profiler``; "not measured" if the profiler reports none).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from .core.rays import Rays
from .entry import entry
from .ops import permuto_encoding
from .ops.composite import composite_channel_T, exponential_integration_weights
from .ops.occupancy import OccupancyGrid
from .ops.raymarch import raymarch


def _event_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_render: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=20, check=True).stdout.strip()
    fn, (pipe, origins, dirs, cam_idx) = entry(device="cuda")
    nef = pipe.nef
    occ = OccupancyGrid.create(level=7, device="cuda")
    steps = pipe.tracer_cfg.num_steps

    wall = []
    for i in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(pipe, origins, dirs, cam_idx)
        torch.cuda.synchronize()
        if i:                                   # the first call is warm-up
            wall.append((time.perf_counter() - t) * 1e3)

    with torch.inference_mode():
        base = Rays(origins=origins, dirs=dirs, dist_min=0.0, dist_max=6.0)
        march = lambda: raymarch(pipe.transform_rays(base, cam_idx), occ, steps)
        rm = march()
        r, s = rm.depths.shape
        coordsT = rm.positionsT.reshape(3, r * s).contiguous()
        ray_dT = dirs[0].T[:, :, None].expand(3, r, s).reshape(3, r * s)
        encode = lambda: permuto_encoding.fused_encode_dual(
            nef.grid.tables, nef.delta_grid.tables, coordsT, nef.grid.spec.scales)
        fa, fb = encode()
        feats, panop = fa.reshape(-1, r * s), fa.reshape(-1, r * s) + fb.reshape(-1, r * s)

        def decoders():
            density_feats, density = nef._density(feats)
            return (density, nef._rgb(density_feats, ray_dT),
                    nef._semantics(panop), nef._inst(panop))
        density, rgb, sem, inst = decoders()

        def composite():
            tau = density.reshape(r, s) * rm.deltas
            w, _ = exponential_integration_weights(tau, rm.mask)
            return [composite_channel_T(c.reshape(-1, r, s), w)
                    for c in (rgb, sem, inst)]
        stages = {"march": _event_ms(march), "lattice_gather": _event_ms(encode),
                  "decoders": _event_ms(decoders),
                  "composite": _event_ms(composite)}

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(pipe, origins, dirs, cam_idx)
        torch.cuda.synchronize()
    # device-side rows only: an operator row repeats its kernels' time
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key[:160], e.count))
    rows.sort(reverse=True)
    device_ms = sum(row[0] for row in rows)
    print(json.dumps({
        "card": card, "rays": r, "steps": s, "samples": r * s,
        "render_wall_ms_median": statistics.median(wall), "render_wall_ms": wall,
        "stage_device_ms": stages, "stage_sum_ms": sum(stages.values()),
        "profiled_kernel_ms": device_ms if rows else "not measured",
        "top_device_ops": [{"ms": ms, "op": key, "count": n}
                           for ms, key, n in rows[:15]],
    }), flush=True)


if __name__ == "__main__":
    main()
