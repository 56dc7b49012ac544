#!/usr/bin/env python3
"""Drive the PyTorch port (``pagnerf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing one JSON line as it ends:

1. device  -- refuse to run without CUDA; name the card and its power limit.
2. build   -- compile ``ops/csrc/permuto_gather.cu`` and
   ``ops/csrc/permuto_scatter.cu`` (backward kernels and the row
   scatter-add) with nvcc (ctypes route), one nvcc each, both started
   together.
3. kernels -- the forward gathers at the flagship render's shapes (L=24
   levels, C=2^18 entries, F=2, V=4, N = 3072 rays (camera 0's 64x48 image)
   x 512 steps = 1,572,864 samples), idx/bary from the port's lattice at the
   render's sample coordinates: single and dual kernels against their plain
   PyTorch versions in float32 (the flagship's gather dtype) and bfloat16,
   timed beside ``torch.nn.functional.embedding_bag``.
4. kernels_bwd -- the backward kernels at the flagship training shapes
   (N = 4096 rays x 512 steps = 2,097,152 samples of one microbatch), idx/bary
   from the port's lattice at a real training microbatch's jittered samples:
   first the microbatch's per-level statistics (events per row, distinct
   rows per 256-sample block), then the table-gradient scatter (single,
   dual; the main path's per-level live rows and modes) with random and
   with same-signed cotangents, and dbary, against their plain versions,
   timed beside ``index_add_`` (the scatter's library yardstick), with the
   single scatter's device time per level.
   scatter_rows -- the row scatter-add (no main path runs it): M = 2,097,152
   same-signed rows of 128 into 4096 rows (the microbatch's level-0 indices
   // 64), into 640 and into 128 rows, and no events, against its plain
   version, timed beside ``index_add_``.
5. tiny    -- the tiny configuration rendered on the card against the same
   render on the CPU (whose plain path the CPU tests hold against the JAX
   package), float32 decoders.
6. render  -- main path 1: launch counts set to 0, the flagship render
   ``entry()`` (rgb, depth, semantics, inst_embedding; dual kernel) and the
   same render with rgb and depth only (single kernel), counts read. Outputs
   must be finite, of the right shapes, and match the render routed through
   the plain gathers on the card.
7. train   -- main paths 2 and 3: launch counts set to 0, then
   ``train_flagship("rgb", steps=3)`` and ``train_flagship("panoptic",
   steps=3)`` at full width (6 images requested, 4 training views, 4096
   rays each, one image per microbatch), counts read: the forward gather and
   the table-gradient kernel once per microbatch (single in the RGB stage,
   dual in the panoptic stage), dbary once per microbatch whose camera is not
   an anchor frame, the row scatter-add never. Losses must be finite. Then
   one microbatch's gradients through the kernels against the same
   microbatch through the plain backward versions on the card. Step times, rays/s and peak memory.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Published H100 SXM peaks (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores. The kernels' arithmetic is float32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32_EPS = 2.0 ** -23
BF16_ULP = 2.0 ** -7
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase,
                      "elapsed_s": time.perf_counter() - T0, **fields}),
          flush=True)


def cuda_ms(fn, reps: int = 10, flush=None) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` launches after one
    warm-up, CUDA events around each launch. ``flush()`` runs between
    launches, outside the timed span, to evict L2."""
    import torch
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


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def gather_bound(l, c, f, n, num_tables, itemsize):
    """Least time for the gather at these shapes: bytes (idx read once, bary
    and each table read once, each output written once) over the memory rate,
    against flops (V products and sums per output) over the float32 rate."""
    v = 4
    nbytes = l * v * n * 4 + l * v * n * itemsize \
        + num_tables * (l * c * f * itemsize + l * f * n * itemsize)
    return _bound(nbytes, num_tables * l * f * n * v * 2)


def scatter_bound(l, c, f, n, num_tables):
    """Least time for the table-gradient scatter: idx and bary read once,
    each table's cotangent g [L, F, N] read once and gradient [L, C, F]
    written once (float32); one product and one sum per event and feature."""
    v = 4
    nbytes = 2 * l * v * n * 4 + num_tables * (l * f * n * 4 + l * c * f * 4)
    return _bound(nbytes, num_tables * l * v * n * f * 2)


def dbary_bound(l, c, f, n):
    """Least time for dbary: idx, g and the table read once, dbary written
    once (float32); F products and sums per output."""
    v = 4
    nbytes = l * v * n * 4 + l * f * n * 4 + l * c * f * 4 + l * v * n * 4
    return _bound(nbytes, l * v * n * f * 2)


def _kernel_wrappers():
    """Every kernel wrapper of the port, by name, with its launch count."""
    from pagnerf_tpu_torch.ops import scatter_rows, table_gather
    return {**table_gather.KERNELS, "scatter_rows": scatter_rows.scatter_rows}


def _reset_launches() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _launches() -> dict:
    return {k: fn.launches for k, fn in _kernel_wrappers().items()}


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from pagnerf_tpu_torch.ops import _build, table_gather

    def timed(name):
        t = time.perf_counter()
        path = _build.build(name)
        return os.path.relpath(path, ROOT), time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        futures = {n: ex.submit(timed, n) for n in ("permuto_gather", "permuto_scatter")}
        built = {n: f.result() for n, f in futures.items()}
    table_gather._kernel()
    table_gather._scatter_kernels()
    emit("build", wall_seconds=time.perf_counter() - t,
         seconds={n: s for n, (_, s) in built.items()},
         libraries={n: p for n, (p, _) in built.items()},
         flags=" ".join(_build.NVCC_FLAGS))


def phase_kernels_fwd(dev, pipe, origins, dirs, cam_idx, flush):
    import torch
    import torch.nn.functional as F

    from pagnerf_tpu_torch.core.rays import Rays
    from pagnerf_tpu_torch.ops import permuto_encoding, table_gather
    from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid
    from pagnerf_tpu_torch.ops.raymarch import raymarch

    spec = pipe.nef.grid.spec
    occ = OccupancyGrid.create(level=7, device=dev)
    with torch.inference_mode():
        rays = pipe.transform_rays(
            Rays(origins=origins, dirs=dirs, dist_min=0.0, dist_max=6.0), cam_idx)
        coordsT = raymarch(rays, occ, pipe.tracer_cfg.num_steps).positionsT
        coordsT = coordsT.reshape(3, -1)
        idx, bary32 = permuto_encoding.lattice(pipe.nef.grid.tables, coordsT,
                                                spec.scales)
    l, _, n = idx.shape
    c, f = spec.capacity, spec.feature_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    offs = torch.arange(l, device=dev, dtype=torch.int64)[:, None, None] * c
    bag_idx = (idx.to(torch.int64) + offs).permute(0, 2, 1).reshape(l * n, 4)

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        ta = torch.randn((l, c, f), generator=gen, device=dev).to(dtype)
        tb = torch.randn((l, c, f), generator=gen, device=dev).to(dtype)
        bary = bary32.to(dtype)
        bag_w = bary.permute(0, 2, 1).reshape(l * n, 4)
        tmax = max(ta.float().abs().max().item(), tb.float().abs().max().item())
        for name, num_tables in (("single", 1), ("dual", 2)):
            if num_tables == 1:
                def kern():
                    return (table_gather.multilevel_table_gather(ta, idx, bary),)

                def plain():
                    return (table_gather.multilevel_gather_plain(ta, idx, bary),)
                bag_table = ta.reshape(l * c, f)
            else:
                def kern():
                    return table_gather.dual_multilevel_table_gather(ta, tb, idx, bary)

                def plain():
                    return table_gather.dual_gather_plain(ta, tb, idx, bary)
                bag_table = torch.cat([ta, tb], dim=2).reshape(l * c, 2 * f)
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
            ref_max = max(r.float().abs().max().item() for r in ref)
            # float32: a few ulp of reordered/fused sums of 4 products;
            # bfloat16: the same, then one rounding that may land 1 ulp apart
            tol = 8 * F32_EPS * tmax + (BF16_ULP * ref_max
                                        if dtype == torch.bfloat16 else 0.0)
            if not err <= tol:
                raise AssertionError(f"{name} {dtype} kernel vs plain: max abs "
                                     f"err {err} > tol {tol}")
            if num_tables == 2:
                singles = (table_gather.multilevel_table_gather(ta, idx, bary),
                           table_gather.multilevel_table_gather(tb, idx, bary))
                if not all(torch.equal(d, s) for d, s in zip(got, singles)):
                    raise AssertionError(f"dual {dtype} kernel is not bit-exact "
                                         "against two single launches")
            lib_out = F.embedding_bag(bag_idx, bag_table, mode="sum",
                                      per_sample_weights=bag_w)
            lib_err = (lib_out.float().reshape(l, n, num_tables, f)
                       .permute(2, 0, 3, 1)
                       - torch.stack([r.float() for r in ref])).abs().max().item()
            del got, ref, lib_out
            bound_ms, bound_by, nbytes, flops = gather_bound(
                l, c, f, n, num_tables, ta.element_size())
            results[(name, dtype)] = dict(
                max_abs_err=err, tol=tol,
                ms=cuda_ms(kern, flush=flush), plain_ms=cuda_ms(plain, flush=flush),
                library_ms=cuda_ms(lambda: F.embedding_bag(
                    bag_idx, bag_table, mode="sum", per_sample_weights=bag_w),
                    flush=flush),
                library_max_abs_err=lib_err,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
            emit("kernels", kernel=name, dtype=str(dtype).replace("torch.", ""),
                 L=l, C=c, F=f, N=n, **results[(name, dtype)])
        del ta, tb, bary, bag_w
    return results


def phase_kernels_bwd(dev, flush):
    import torch

    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.ops.permuto_encoding import scatter_plan
    from pagnerf_tpu_torch.profile_scatter import device_ms, level_stats, training_microbatch

    spec, idx, bary = training_microbatch(dev)
    l, _, n = idx.shape
    c, f = spec.capacity, spec.feature_dim
    # the main path's per-level live rows and accumulation modes
    rows_used, modes = scatter_plan(spec.scales, c, f)
    plan = dict(rows_used=rows_used, modes=modes)
    stats = level_stats(idx, c)
    emit("kernels_bwd", part="level_stats", L=l, C=c, N=n, modes=list(modes),
         levels=[{k: e[k] for k in ("level", "events_per_row_max", "events_per_row_mean",
                                    "touched_rows", "distinct_rows_per_256",
                                    "rows_over_120")} for e in stats])
    gen = torch.Generator(device=dev).manual_seed(1)
    g_a = torch.randn((l, f, n), generator=gen, device=dev)
    g_b = torch.randn((l, f, n), generator=gen, device=dev)
    table = torch.randn((l, c, f), generator=gen, device=dev)
    rows = tg._flat_rows(idx, c)
    vals_a = (bary[..., None] * g_a.permute(0, 2, 1)[:, None]).reshape(-1, f)
    vals_b = (bary[..., None] * g_b.permute(0, 2, 1)[:, None]).reshape(-1, f)
    vals_ab = torch.cat([vals_a, vals_b], dim=1)
    del vals_b

    def scatter_check(got, gs):
        """(max abs err, largest err / tol): per entry, the tolerance is
        64 eps_f32 * the sum over its events of |bary * g| (the kernel's
        accumulations in a varying order against a float64 sum rounded once;
        csrc/permuto_scatter.cu, "Accuracy")."""
        worst, err = 0.0, 0.0
        for d, g in zip(got, gs):
            diff = (d - tg.table_grad_plain(idx, bary, g, c)).abs()
            tol = 64 * F32_EPS * tg.table_grad_plain(idx, bary.abs(), g.abs(), c)
            err = max(err, diff.max().item())
            worst = max(worst, (diff / tol.clamp(min=1e-30)).max().item())
            del diff, tol
        return err, worst

    def require(ok_, name, fields):
        if not ok_:
            emit("kernels_bwd", kernel=name, ok=False, **fields)
            raise AssertionError(f"{name} kernel outside its tolerance of the "
                                 f"plain version: {fields}")

    def checks(name, kernel, gs):
        """The kernel against the plain version with random cotangents and
        with same-signed ones (|randn|: a coarse row's ~1e5 events then
        all add up, as the delta grid's real gradients do)."""
        out = {}
        for kind, g in (("random", gs), ("same_signed", [x.abs() for x in gs])):
            got = kernel(*g)
            out[kind] = scatter_check(got if isinstance(got, tuple) else (got,), g)
            del got
        fields = dict(max_abs_err=out["random"][0], worst_err_over_tol=out["random"][1],
                      same_signed_max_abs_err=out["same_signed"][0],
                      same_signed_worst_err_over_tol=out["same_signed"][1])
        require(max(w for _, w in out.values()) <= 1.0, name, fields)
        return fields

    results = {}
    # single scatter
    single = lambda g: tg.multilevel_table_grad(idx, bary, g, c, **plan)
    fields = checks("table_grad_single", single, [g_a])
    lib_single = lambda: torch.zeros((l * c, f), device=dev).index_add_(0, rows, vals_a)
    lib_err = (lib_single().reshape(l, c, f)
               - tg.table_grad_plain(idx, bary, g_a, c)).abs().max().item()
    bound_ms, bound_by, nbytes, flops = scatter_bound(l, c, f, n, 1)
    # each level alone: device time of its kernels (the profiler), since a
    # call this small is dominated by launch gaps on the host clock
    per_level = [device_ms(lambda lv=lv: tg.multilevel_table_grad(
        idx[lv:lv + 1], bary[lv:lv + 1], g_a[lv:lv + 1], c, rows_used[lv:lv + 1],
        modes[lv:lv + 1]))["total"] for lv in range(l)]
    results["table_grad_single"] = dict(
        **fields, tol="64 eps_f32 * sum|bary*g| per entry",
        ms=cuda_ms(lambda: single(g_a), flush=flush),
        plain_ms=cuda_ms(lambda: tg.table_grad_plain(idx, bary, g_a, c), flush=flush),
        library_ms=cuda_ms(lib_single, flush=flush), library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
        per_level_device_ms=per_level)
    emit("kernels_bwd", kernel="table_grad_single", L=l, C=c, F=f, N=n,
         **results["table_grad_single"])

    # dual scatter
    dual = lambda ga, gb: tg.dual_multilevel_table_grad(idx, bary, ga, gb, c, **plan)
    fields = checks("table_grad_dual", dual, [g_a, g_b])
    lib_dual = lambda: torch.zeros((l * c, 2 * f), device=dev).index_add_(0, rows, vals_ab)
    lib_out = lib_dual().reshape(l, c, 2 * f)
    lib_err = max((lib_out[..., :f] - tg.table_grad_plain(idx, bary, g_a, c)).abs().max().item(),
                  (lib_out[..., f:] - tg.table_grad_plain(idx, bary, g_b, c)).abs().max().item())
    del lib_out
    bound_ms, bound_by, nbytes, flops = scatter_bound(l, c, f, n, 2)
    results["table_grad_dual"] = dict(
        **fields, tol="64 eps_f32 * sum|bary*g| per entry",
        ms=cuda_ms(lambda: dual(g_a, g_b), flush=flush),
        plain_ms=cuda_ms(lambda: tg.dual_table_grad_plain(idx, bary, g_a, g_b, c),
                         flush=flush),
        library_ms=cuda_ms(lib_dual, flush=flush), library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    emit("kernels_bwd", kernel="table_grad_dual", L=l, C=c, F=f, N=n,
         **results["table_grad_dual"])
    del rows, vals_a, vals_ab

    # dbary: within 4 eps_f32 of its sum over F of |g * T| (fma chain vs products)
    got = tg.multilevel_gather_dbary(table, idx, g_a)
    want = tg.gather_dbary_plain(table, idx, g_a)
    mag = tg.gather_dbary_plain(table.abs(), idx, g_a.abs())
    diff = (got - want).abs()
    err = diff.max().item()
    worst = (diff / (4 * F32_EPS * mag).clamp(min=1e-30)).max().item()
    del got, want, mag, diff
    require(worst <= 1.0, "gather_dbary", dict(max_abs_err=err, worst_err_over_tol=worst))
    bound_ms, bound_by, nbytes, flops = dbary_bound(l, c, f, n)
    results["gather_dbary"] = dict(
        max_abs_err=err, tol="4 eps_f32 * sum_f |g*T| per entry",
        worst_err_over_tol=worst,
        ms=cuda_ms(lambda: tg.multilevel_gather_dbary(table, idx, g_a), flush=flush),
        plain_ms=cuda_ms(lambda: tg.gather_dbary_plain(table, idx, g_a), flush=flush),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
        flops=flops)
    emit("kernels_bwd", kernel="gather_dbary", L=l, C=c, F=f, N=n,
         **results["gather_dbary"])
    return results, idx[0, 0].clone()


def phase_scatter_rows(dev, level0_rows, flush):
    """The row scatter-add (no main path runs it) at the flagship table's 2 MB
    legacy layout: M = 2,097,152 events into 4096 rows of 128, rows = a real
    microbatch's level-0 indices // 64 (about 84 rows of ~1e5 events each),
    same-signed values; then the same events into 640 rows, into 128 rows
    (each block then copies the whole output into shared memory, not only the
    rows it touches), and no events."""
    import torch

    from pagnerf_tpu_torch.ops import scatter_rows as sr

    m = level0_rows.numel()
    row = (level0_rows // 64).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(3)
    vals = torch.randn((m, sr.WIDTH), generator=gen, device=dev).abs()
    checks = {}
    for num_rows in (4096, 640, 128):
        got = sr.scatter_rows(row, vals, num_rows)
        want = sr.scatter_rows_plain(row, vals, num_rows)
        tol = 64 * F32_EPS * sr.scatter_rows_plain(row, vals.abs(), num_rows)
        diff = (got - want).abs()
        checks[num_rows] = dict(max_abs_err=diff.max().item(),
                                worst_err_over_tol=(diff / tol.clamp(min=1e-30)).max().item())
        if not checks[num_rows]["worst_err_over_tol"] <= 1.0:
            emit("scatter_rows", ok=False, num_rows=num_rows, **checks[num_rows])
            raise AssertionError(f"scatter_rows kernel vs plain at {num_rows} rows: "
                                 f"{checks[num_rows]}")
    empty = sr.scatter_rows(row[:0], vals[:0], 640)
    if not (empty.shape == (640, sr.WIDTH) and bool((empty == 0).all())):
        emit("scatter_rows", ok=False, zero_events="not all zeros")
        raise AssertionError("scatter_rows with no events is not zeros")
    num_rows = 4096
    lib = lambda: torch.zeros((num_rows, sr.WIDTH), device=dev).index_add_(0, row.long(), vals)
    lib_err = (lib() - sr.scatter_rows_plain(row, vals, num_rows)).abs().max().item()
    nbytes = m * 4 + m * sr.WIDTH * 4 + num_rows * sr.WIDTH * 4
    bound_ms, bound_by, _, flops = _bound(nbytes, m * sr.WIDTH)
    result = dict(
        M=m, num_rows=num_rows, touched_rows=int(torch.unique(row).numel()),
        max_abs_err=checks[num_rows]["max_abs_err"],
        worst_err_over_tol=checks[num_rows]["worst_err_over_tol"],
        tol="64 eps_f32 * sum|vals| per entry", checks_by_num_rows=checks,
        zero_events_ok=True,
        ms=cuda_ms(lambda: sr.scatter_rows(row, vals, num_rows), flush=flush),
        ms_128_rows=cuda_ms(lambda: sr.scatter_rows(row, vals, 128), flush=flush),
        plain_ms=cuda_ms(lambda: sr.scatter_rows_plain(row, vals, num_rows), flush=flush),
        library_ms=cuda_ms(lib, flush=flush), library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    emit("scatter_rows", **result)
    return result


def phase_tiny(dev):
    import torch

    from pagnerf_tpu_torch.entry import entry

    outs = []
    for d in (dev, torch.device("cpu")):
        tfn, targs = entry(device=d, tiny=True, compute_dtype=torch.float32)
        outs.append([o.cpu() for o in tfn(*targs)])
    tiny_err = max((a - b).abs().max().item() for a, b in zip(*outs))
    if not tiny_err <= 1e-4:
        raise AssertionError(f"tiny render, card vs CPU: max abs err {tiny_err} > 1e-4")
    emit("tiny", max_abs_err=tiny_err, tol=1e-4,
         shapes=[list(o.shape) for o in outs[0]])


def phase_render(fn, pipe, origins, dirs, cam_idx):
    import torch
    from unittest import mock

    from pagnerf_tpu_torch.ops import table_gather

    rd = frozenset({"rgb", "depth"})
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = fn(pipe, origins, dirs, cam_idx)
    out_rd = fn(pipe, origins, dirs, cam_idx, channels=rd)
    torch.cuda.synchronize()
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("gather", "dual_gather"):
        if launches[name] < 1:
            raise AssertionError(f"the render launched the {name} kernel "
                                 f"{launches[name]} times")

    n_rays = dirs.shape[1]
    nef = pipe.nef
    shapes = {"rgb": (n_rays, 3), "depth": (n_rays, 1),
              "semantics": (n_rays, nef.num_classes),
              "inst_embedding": (n_rays, nef.num_instances)}
    for (ch, shape), o in zip(shapes.items(), out):
        if tuple(o.shape) != shape or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{ch}: shape {tuple(o.shape)} (want {shape}), "
                                 f"finite={bool(torch.isfinite(o).all())}")
    rd_err = max((a - b).abs().max().item() for a, b in zip(out[:2], out_rd[:2]))
    if not rd_err <= 1e-5:
        raise AssertionError(f"rgb/depth render (single kernel) differs from the "
                             f"panoptic render (dual kernel) by {rd_err}")

    with mock.patch.object(table_gather, "multilevel_table_gather",
                           lambda t, i, b, rows_used=None, modes=None:
                           table_gather.multilevel_gather_plain(t, i, b)), \
         mock.patch.object(table_gather, "dual_multilevel_table_gather",
                           lambda ta, tb, i, b, rows_used=None, modes=None:
                           table_gather.dual_gather_plain(ta, tb, i, b)):
        plain_out = fn(pipe, origins, dirs, cam_idx)
        plain_ms = [0.0] * 3
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(pipe, origins, dirs, cam_idx)
            torch.cuda.synchronize()
            plain_ms[i] = (time.perf_counter() - t) * 1e3
    # Kernel and plain gathers round differently only in the last float32
    # bits; the bfloat16 decoders can turn that into one bf16 ulp of a hidden
    # unit, which integrates to well under 1e-2 in a probability or colour.
    errs, tols = {}, {}
    for ch, a, b in zip(shapes, out, plain_out):
        errs[ch] = (a - b).abs().max().item()
        tols[ch] = 1e-2 * (b.abs().max().item() if ch == "depth" else 1.0)
        if not errs[ch] <= tols[ch]:
            raise AssertionError(f"{ch}: kernel render vs plain-gather render "
                                 f"max abs err {errs[ch]} > {tols[ch]}")
    render_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(pipe, origins, dirs, cam_idx)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t) * 1e3)
    emit("render", rays=n_rays, steps=pipe.tracer_cfg.num_steps,
         samples=n_rays * pipe.tracer_cfg.num_steps, launches=launches,
         rgb_depth_vs_panoptic_err=rd_err, vs_plain_max_abs_err=errs,
         vs_plain_tol=tols, render_ms_median=statistics.median(render_ms),
         render_ms=render_ms, plain_gather_render_ms_median=statistics.median(plain_ms),
         peak_allocated_gib=peak_gb)
    return launches


def _plain_backward_grads(trainer, stage, sub, jitter):
    """The microbatch's gradients with the three backward kernels swapped
    for their plain versions (the forward kernel stays, so both runs see the
    same cotangents), and each table's per-entry sum of |bary * g|."""
    from unittest import mock

    from pagnerf_tpu_torch.ops import table_gather as tg

    mags = {}

    def single(idx, bary, g, c, rows_used=None, modes=None):
        mags["nef.grid.tables"] = tg.table_grad_plain(idx, bary.abs(), g.abs(), c,
                                                      rows_used)
        return tg.table_grad_plain(idx, bary, g, c, rows_used)

    def dual(idx, bary, g_a, g_b, c, rows_used=None, modes=None):
        mags["nef.grid.tables"] = tg.table_grad_plain(idx, bary.abs(), g_a.abs(), c,
                                                      rows_used)
        mags["nef.delta_grid.tables"] = tg.table_grad_plain(idx, bary.abs(), g_b.abs(),
                                                            c, rows_used)
        return tg.dual_table_grad_plain(idx, bary, g_a, g_b, c, rows_used)

    with mock.patch.object(tg, "multilevel_table_grad", single), \
         mock.patch.object(tg, "dual_multilevel_table_grad", dual), \
         mock.patch.object(tg, "multilevel_gather_dbary", tg.gather_dbary_plain):
        grads, losses = trainer.grad_step(stage, sub, jitter)
    return grads, losses, mags


def phase_train(dev, stage_name):
    import numpy as np
    import torch

    from pagnerf_tpu_torch.entry import train_flagship
    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.ops.assignment import lap_assign

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    assign_s = lap_assign.seconds
    _reset_launches()
    trainer, log = train_flagship(stage_name, steps=3, device=dev)
    torch.cuda.synchronize()
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    assign_s = lap_assign.seconds - assign_s

    anchor = trainer.pipeline.anchor_mask.cpu().numpy()
    micro = sum(len(s["cam_idx"]) for s in log)
    non_anchor = sum(int(not anchor[c]) for s in log for c in s["cam_idx"])
    fwd, grad = (("gather", "table_grad") if stage_name == "rgb"
                 else ("dual_gather", "dual_table_grad"))
    other_fwd, other_grad = (("dual_gather", "dual_table_grad") if stage_name == "rgb"
                             else ("gather", "table_grad"))
    expected = {fwd: micro, grad: micro, other_fwd: 0, other_grad: 0,
                "dbary": non_anchor, "scatter_rows": 0}
    if launches != expected:
        raise AssertionError(f"{stage_name} training launched {launches}, "
                             f"expected {expected}")
    for s in log:
        if not all(np.isfinite(v) for v in s["losses"].values()):
            raise AssertionError(f"{stage_name} step losses not finite: {s}")

    # one microbatch through the kernels and through the plain backward
    stage = trainer.stage_for_epoch(log[-1]["epoch"])
    cfg = trainer.cfg
    batch = trainer.dataset.sample_batch(np.random.default_rng(1), cfg.batch_size,
                                         cfg.num_rays_sampled_per_img)
    m = int(np.nonzero(~anchor[batch["cam_idx"]])[0][0])
    sub = {k: v[m:m + 1] if getattr(v, "ndim", 0) >= 1
           and v.shape[0] == batch["imgs"].shape[0] else v for k, v in batch.items()}
    jitter = torch.rand((cfg.num_rays_sampled_per_img, stage.num_steps),
                        generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    g_k, l_k = trainer.grad_step(stage, sub, jitter)
    g_p, l_p, mags = _plain_backward_grads(trainer, stage, sub, jitter)
    table_err, worst = {}, {}
    for name, mag in mags.items():
        diff = (g_k[name] - g_p[name]).abs()
        table_err[name] = diff.max().item()
        worst[name] = (diff / (64 * F32_EPS * mag).clamp(min=1e-30)).max().item()
    # extrinsics: dbary's fused dot rounds 1 ulp apart from the plain
    # products per sample; 2.1M samples sum into 9 numbers through the
    # lattice and ray-transform backward
    ext_ref = g_p["extrinsics"].abs().max().item()
    ext_err = (g_k["extrinsics"] - g_p["extrinsics"]).abs().max().item()
    loss_err = max(abs(float(l_k[k]) - float(l_p[k])) for k in l_k)
    check = dict(plain_check_microbatch_cam=int(sub["cam_idx"][0]),
                 plain_check_table_max_abs_err=table_err,
                 plain_check_table_worst_err_over_tol=worst,
                 plain_check_extrinsics_err=ext_err,
                 plain_check_extrinsics_max=ext_ref, plain_check_loss_err=loss_err)
    if not (all(w <= 1.0 for w in worst.values()) and ext_ref > 0
            and ext_err <= 1e-3 * ext_ref):
        emit(f"train_{stage_name}", ok=False, launches=launches, **check)
        raise AssertionError(f"{stage_name}: gradients through the kernels vs the "
                             f"plain backward outside tolerance: {check}")

    step_ms = [s["seconds"] * 1e3 for s in log]
    imgs = len(log[-1]["cam_idx"])
    steady_ms = statistics.median(step_ms[1:])
    result = dict(
        steps=len(log), microbatches_per_step=imgs,
        rays_per_step=imgs * cfg.num_rays_sampled_per_img,
        samples_per_microbatch=cfg.num_rays_sampled_per_img * stage.num_steps,
        launches=launches, expected_launches=expected,
        losses=[s["losses"] for s in log], cam_idx=[s["cam_idx"] for s in log],
        step_ms=step_ms, step_ms_steady_median=steady_ms,
        rays_per_s=imgs * cfg.num_rays_sampled_per_img / (steady_ms / 1e3),
        peak_allocated_gib=peak_gb,
        host_assignment_s=assign_s, **check)
    emit(f"train_{stage_name}", **result)
    del trainer
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    # import the port first: without it (or without a card) nothing is printed
    import torch

    from pagnerf_tpu_torch.entry import entry
    from pagnerf_tpu_torch.ops import table_gather

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")

    # ---------------------------------------------------------------- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=20, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    emit("device", card=smi_line, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)

    phase_build()

    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    fn, (pipe, origins, dirs, cam_idx) = entry(device=dev)
    fwd = phase_kernels_fwd(dev, pipe, origins, dirs, cam_idx, flush)
    torch.cuda.empty_cache()
    bwd, level0_rows = phase_kernels_bwd(dev, flush)
    bwd["scatter_rows"] = phase_scatter_rows(dev, level0_rows, flush)
    del flush_buf, flush, level0_rows
    torch.cuda.empty_cache()
    phase_tiny(dev)
    paths = {"render": phase_render(fn, pipe, origins, dirs, cam_idx)}
    del fn, pipe
    torch.cuda.empty_cache()
    for stage_name in ("rgb", "panoptic"):
        paths[f"train_{stage_name}"] = phase_train(dev, stage_name)

    # ---------------------------------------------------------------- report
    sources = {"fwd": "pagnerf_tpu_torch/ops/csrc/permuto_gather.cu",
               "bwd": "pagnerf_tpu_torch/ops/csrc/permuto_scatter.cu"}
    rows = []
    for name, key, replaces in (("single", "gather", "pagnerf_tpu/ops/pallas_gather.py:101"),
                                ("dual", "dual_gather", "pagnerf_tpu/ops/pallas_gather.py:119")):
        r32 = fwd[(name, torch.float32)]
        r16 = fwd[(name, torch.bfloat16)]
        rows.append({
            "name": f"permuto_gather_{name}", "route": "cuda", "source": sources["fwd"],
            "replaces": replaces, "launches": sum(p[key] for p in paths.values()),
            "launches_by_path": {p: c[key] for p, c in paths.items()},
            "dtype": "float32", "shapes": "render N=1,572,864",
            **{k: r32[k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            "bf16": {k: r16[k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                         "bound_ms", "library_ms")},
        })
    for name, key, replaces, shapes in (
            ("table_grad_single", "table_grad", "pagnerf_tpu/ops/pallas_scatter.py:339",
             "training microbatch N=2,097,152"),
            ("table_grad_dual", "dual_table_grad", "pagnerf_tpu/ops/pallas_scatter.py:243",
             "training microbatch N=2,097,152"),
            ("gather_dbary", "dbary", "pagnerf_tpu/ops/pallas_gather.py:110",
             "training microbatch N=2,097,152"),
            ("scatter_rows", "scatter_rows", "pagnerf_tpu/ops/pallas_scatter.py:84",
             "M=2,097,152 events into 4096 rows x 128 (off the main path)")):
        r = bwd[name]
        rows.append({
            "name": name, "route": "cuda", "source": sources["bwd"],
            "replaces": replaces, "launches": sum(p[key] for p in paths.values()),
            "launches_by_path": {p: c[key] for p, c in paths.items()},
            "dtype": "float32", "shapes": shapes,
            **{k: r[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
