"""The table-gradient scatter at the flagship training shapes, on the card.

    python -m pagnerf_tpu_torch.profile_scatter [--parent OLD.cu] [--skip-levels] [--out FILE]

One real training microbatch (a non-anchor camera, 4096 rays x 512 jittered
steps; idx/bary from the port's march and lattice) feeds:

- ``stats``: per level, the events per touched row (largest, mean), the
  touched rows, the distinct rows per 256- and per 1024-sample block, the
  share of warp lanes that start a run of equal indices, and the rows (and
  share of events) beyond 120 events -- what decides each level's
  accumulation in ``csrc/permuto_scatter.cu``;
- ``check``: the scatter (single and dual, default per-level modes, other
  splits, every level forced to one mode, and the hash grid's window mode
  in place of the float32 one) against the plain version with
  random and same-signed cotangents, as the largest error over the
  tolerance 64 eps_f32 * sum|bary * g| per entry;
- ``time``: median device ms (CUDA events, L2 evicted, 10 launches) of the
  whole scatter, single and dual, under each per-level plan, with the
  device ms of each of its kernels (``torch.profiler``); and the device ms
  of each level alone under each mode (profiler: kernels only, without
  the launch gaps that dominate a call this small);
  with ``--parent``, the same for another version of ``permuto_scatter.cu``
  (its pre-redesign C interface: caller-zeroed float64 scratch per table),
  built with the same flags into a temporary directory and timed in turns
  with this one (parent, this, this, parent).

Prints one JSON object per part, and writes all of them to ``--out`` if given.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .ops import _build
from .ops import table_gather as tg

F32_EPS = 2.0 ** -23


def training_coords(dev, seed: int = 0, tiny: bool = False):
    """(spec, x [3, N]) of one flagship training microbatch: the sample
    coordinates of a non-anchor camera's rays x 512 jittered steps, through
    the port's own march."""
    from .core.rays import Rays
    from .entry import flagship, train_config
    from .ops.occupancy import OccupancyGrid
    from .ops.raymarch import raymarch

    pipe, ds = flagship(tiny=tiny, device=dev, seed=seed)
    cfg = train_config("rgb", tiny)
    batch = ds.sample_batch(np.random.default_rng(seed), cfg.batch_size,
                            cfg.num_rays_sampled_per_img)
    m = int(np.nonzero(batch["cam_idx"] != 0)[0][0])
    steps = pipe.tracer_cfg.num_steps
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        base = Rays(origins=torch.from_numpy(batch["base_rays_origins"][m:m + 1]).to(dev),
                    dirs=torch.from_numpy(batch["base_rays_dirs"][m:m + 1]).to(dev),
                    dist_min=0.0, dist_max=6.0)
        rays = pipe.transform_rays(base, torch.tensor([int(batch["cam_idx"][m])],
                                                      device=dev))
        rm = raymarch(rays, OccupancyGrid.create(level=7, device=dev), steps,
                      jitter=gen)
    return pipe.nef.grid.spec, rm.positionsT.reshape(3, -1).contiguous()


def microbatch_lattice(spec, x):
    """idx, bary [L, 4, N] of coordinates x [3, N] through the port's plain
    lattice."""
    from .ops import permuto_encoding

    # lattice() reads only the tables' shape
    tables = torch.empty((spec.num_levels, spec.capacity, spec.feature_dim), device="meta")
    with torch.no_grad():
        return permuto_encoding.lattice(tables, x, spec.scales)


def training_microbatch(dev, seed: int = 0, tiny: bool = False):
    """(spec, idx, bary) of one flagship training microbatch
    (``training_coords`` through ``microbatch_lattice``)."""
    spec, x = training_coords(dev, seed, tiny)
    return (spec, *microbatch_lattice(spec, x))


def level_stats(idx: torch.Tensor, capacity: int, over: int = 120) -> list:
    """Per-level event statistics of idx [L, 4, N] (see the module doc)."""
    out = []
    n = idx.shape[2]
    s = torch.arange(n, device=idx.device)
    for lv in range(idx.shape[0]):
        rows = idx[lv].reshape(-1).long()
        counts = torch.bincount(rows, minlength=capacity)
        touched = int((counts > 0).sum())
        hot = counts > over
        entry = dict(level=lv, events=int(rows.numel()), touched_rows=touched,
                     events_per_row_max=int(counts.max()),
                     events_per_row_mean=rows.numel() / max(touched, 1),
                     rows_over_120=int(hot.sum()),
                     events_share_over_120=float(counts[hot].sum()) / rows.numel())
        for block in (256, 1024):
            keys = (s // block)[None, :] * capacity + idx[lv].long()
            entry[f"distinct_rows_per_{block}"] = (
                int(torch.unique(keys).numel()) / ((n + block - 1) // block))
        heads = torch.ones_like(idx[lv], dtype=torch.bool)
        heads[:, 1:] = idx[lv][:, 1:] != idx[lv][:, :-1]
        heads[:, ::32] = True
        entry["run_head_share"] = float(heads.float().mean())
        out.append(entry)
    return out


def cuda_ms(fn, reps: int = 10, flush=None) -> float:
    """Median device ms of ``fn()`` over ``reps`` launches after a warm-up,
    CUDA events around each; ``flush()`` between launches evicts L2."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def parent_scatter(source: str, workdir: str):
    """Build another version of ``permuto_scatter.cu`` with this package's
    nvcc flags into ``workdir`` and return f(idx, bary, gs, capacity) -> its
    float32 gradients, through its pre-redesign C interface (caller-zeroed
    float64 scratch [L, C, F] per table)."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    lib_path = os.path.join(workdir, "libparent_scatter.so")
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", lib_path, source],
                          capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    fn = ctypes.CDLL(lib_path).pagnerf_table_grad
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(idx, bary, gs, capacity):
        l, _, n = idx.shape
        f = gs[0].shape[1]
        outs = [torch.empty((l, capacity, f), device=idx.device) for _ in gs]
        acc = [torch.zeros((l, capacity, f), dtype=torch.float64, device=idx.device)
               for _ in gs]
        err = fn(idx.data_ptr(), bary.data_ptr(), gs[0].data_ptr(), gs[-1].data_ptr(),
                 acc[0].data_ptr(), acc[-1].data_ptr(), outs[0].data_ptr(),
                 outs[-1].data_ptr(), l, capacity, n, f, len(gs),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent scatter failed: cudaError_t {err}")
        return outs
    return call


def kernel_breakdown(fn) -> dict:
    """Device ms per kernel name of one call of ``fn`` (``torch.profiler``),
    or "not measured" if the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t:
            key = ev.key[:80]
            out[key] = out.get(key, 0.0) + t / 1e3
    return out or "not measured"


def device_ms(fn) -> dict:
    """{"scatter": ms of the event kernels, "total": ms of every kernel} of
    one call of ``fn`` on the device (``kernel_breakdown``; memsets count in
    the total only); None for both if the profiler saw no device time."""
    kernels = kernel_breakdown(fn)
    if not isinstance(kernels, dict):
        return {"scatter": None, "total": None}
    scatter = sum(t for k, t in kernels.items()
                  if any(w in k for w in ("_grad_kernel", "table_grad_kernel")))
    return {"scatter": scatter, "total": sum(kernels.values())}


def scatter_worst(got, idx, bary, gs, capacity, rows_used=None) -> float:
    """Largest |kernel - plain| / (64 eps_f32 * sum|bary * g|) over entries."""
    worst = 0.0
    for d, g in zip(got, gs):
        diff = (d - tg.table_grad_plain(idx, bary, g, capacity, rows_used)).abs()
        tol = 64 * F32_EPS * tg.table_grad_plain(idx, bary.abs(), g.abs(), capacity,
                                                 rows_used)
        worst = max(worst, float((diff / tol.clamp(min=1e-30)).max()))
        del diff, tol
    return worst


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another permuto_scatter.cu to time beside this one")
    ap.add_argument("--out", help="also write every part to this JSON file")
    ap.add_argument("--skip-levels", action="store_true",
                    help="skip the per-level times under each mode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scatter: needs a CUDA card")
    from .ops.permuto_encoding import scatter_plan

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=20).stdout.strip().splitlines()[0]
    results = []

    def emit(part, **fields):
        rec = {"part": part, "card": card, **fields}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    spec, idx, bary = training_microbatch(dev)
    l, _, n = idx.shape
    c, f = spec.capacity, spec.feature_dim
    rows_used, modes = scatter_plan(spec.scales, c, f)
    emit("stats", L=l, C=c, F=f, N=n, rows_used=list(rows_used), modes=list(modes),
         levels=level_stats(idx, c))

    gen = torch.Generator(device=dev).manual_seed(1)
    g_rand = [torch.randn((l, f, n), generator=gen, device=dev) for _ in range(2)]
    g_same = [g.abs() for g in g_rand]
    rows = tg.live_rows(rows_used, l, c)
    plans = {"default": modes, "by_rows": tg.level_modes(rows, c),
             "all_shared": (tg.SHARED,) * l, "all_float": (tg.FLOAT,) * l,
             "all_global": (tg.GLOBAL,) * l}
    for last in (1, 2, 3):
        plans[f"shared_to_{last}"] = tuple(
            tg.SHARED if lv <= last else m if m != tg.SHARED else tg.GLOBAL
            for lv, m in enumerate(modes))
    for last in (10, 12, 13):
        plans[f"float_from_{last + 1}"] = tuple(
            m if m == tg.SHARED else tg.GLOBAL if lv <= last else tg.FLOAT
            for lv, m in enumerate(modes))
    # the hash grid's window merge in place of the float32 mode
    plans["window_fine"] = tuple(tg.WINDOW if m == tg.FLOAT else m for m in modes)
    for plan, plan_modes in plans.items():
        worst = {}
        for kind, gs in (("random", g_rand), ("same_signed", g_same)):
            single = tg._launch_grad(idx, bary, gs[:1], c, rows_used, plan_modes)
            worst[f"single_{kind}"] = scatter_worst(single, idx, bary, gs[:1], c, rows_used)
            del single
            dual = tg._launch_grad(idx, bary, gs, c, rows_used, plan_modes)
            worst[f"dual_{kind}"] = scatter_worst(dual, idx, bary, gs, c, rows_used)
            del dual
        emit("check", plan=plan, modes=list(plan_modes), worst_err_over_tol=worst,
             ok=all(w <= 1.0 for w in worst.values()))

    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    workdir = tempfile.mkdtemp(prefix="parent_scatter_")
    try:
        old = parent_scatter(args.parent, workdir) if args.parent else None
        for name, k in (("single", 1), ("dual", 2)):
            gs = g_rand[:k]
            new_fn = lambda: tg._launch_grad(idx, bary, gs, c, rows_used, modes)
            times = {"new": []}
            if old is not None:
                old_fn = lambda: old(idx, bary, gs, c)
                times["parent"] = []
                parent_worst = scatter_worst(old_fn(), idx, bary, gs, c)
                for fn_name in ("parent", "new", "new", "parent"):
                    times[fn_name].append(cuda_ms(old_fn if fn_name == "parent" else new_fn,
                                                  flush=flush))
            else:
                parent_worst = None
                times["new"].append(cuda_ms(new_fn, flush=flush))
            plan_ms = {plan: cuda_ms(lambda m=m: tg._launch_grad(idx, bary, gs, c, rows_used, m),
                                     flush=flush) for plan, m in plans.items()}
            emit("time", kernel=name, ms={k_: statistics.mean(v) for k_, v in times.items()},
                 ms_runs=times, parent_worst_err_over_tol=parent_worst, plan_ms=plan_ms,
                 kernels_ms=kernel_breakdown(new_fn))
            if args.skip_levels:
                continue
            # device time of each level's scatter alone (profiler: kernels
            # only, no launch gaps), under each mode and in the parent
            per_level = {}
            for plan in ("all_shared", "all_float", "all_global"):
                per_level[plan] = [device_ms(lambda lv=lv, m=plans[plan]: tg._launch_grad(
                    idx[lv:lv + 1], bary[lv:lv + 1], [g[lv:lv + 1] for g in gs], c,
                    rows_used[lv:lv + 1], m[lv:lv + 1])) for lv in range(l)]
            if old is not None:
                per_level["parent"] = [device_ms(lambda lv=lv: old(
                    idx[lv:lv + 1], bary[lv:lv + 1], [g[lv:lv + 1] for g in gs], c))
                    for lv in range(l)]
            emit("time_levels", kernel=name, device_ms=per_level)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh)


if __name__ == "__main__":
    sys.exit(main())
