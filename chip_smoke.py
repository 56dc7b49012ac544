#!/usr/bin/env python3
"""Drive the PyTorch port (``pagnerf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing one JSON line as it ends:

1. device  -- refuse to run without CUDA; name the card and its power limit.
2. build   -- compile ``ops/csrc/permuto_encode.cu`` (the fused encode),
   ``ops/csrc/permuto_gather.cu`` and ``ops/csrc/permuto_scatter.cu``
   (backward kernels and the row scatter-add) with nvcc (ctypes route), one
   nvcc each, all started together.
3. encode  -- the fused encode kernels (lattice, index, gather and weighted
   sum in one launch; single and dual, the dual from packed rows and from
   two tables) against their plain versions (the port's lattice on the card,
   then the plain gathers) at the render's N = 1,572,864 without idx/bary
   and at a training microbatch's N = 2,097,152 with idx/bary, float32 and
   bfloat16, random tables: idx mismatches at most 1e-6 of the entries,
   features within the per-level bound, single bit-equal to the dual's A
   side, the idx mismatches and the share of bit-equal bary; times and
   bounds (table bytes: the rows the lattice can index).
   kernels -- the forward gathers at the flagship render's shapes (L=24
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
   ``entry()`` (rgb, depth, semantics, inst_embedding; dual encode) and the
   same render with rgb and depth only (single encode), counts read: one
   launch of each encode kernel, none of the gathers. Outputs must be
   finite, of the right shapes, and match the render routed through the
   plain encodes on the card.
7. train   -- main paths 2 and 3: launch counts set to 0, then
   ``train_flagship("rgb", steps=3)`` and ``train_flagship("panoptic",
   steps=3)`` at full width (6 images requested, 4 training views, 4096
   rays each, one image per microbatch), counts read: the fused encode and
   the table-gradient kernel once per microbatch (single in the RGB stage,
   dual in the panoptic stage), dbary once per microbatch whose camera is not
   an anchor frame, the gathers and the row scatter-add never. Losses must be finite. Then
   one microbatch's gradients through the kernels against the same
   microbatch through the plain backward versions on the card. Step times, rays/s and peak memory.

8. train_post_prune -- main path 4: launch counts set to 0, then
   ``train_flagship_schedule(steps=3)``: the default schedule's real prune
   of the full-width flagship (density of 4 jittered points per cell of the
   128^3 grid in chunks of 65,536, the single encode without idx/bary; counts
   read after it and set to 0 again), the entry's scene fixture (the
   occupancy of the synthetic scene's spheres and wall, dilated by one
   cell), 3 steps of the first panoptic epochs past the prune and 1 of the
   next val-pose epoch on the voxel march (256 steps) and the packed layout
   (counts read): the launches those steps imply; the steps must render
   the panoptic channels and the last train the val poses. Checks: one
   chunk of the prune's density through the kernel vs the plain encode
   (1e-2); the packed trace vs the dense voxel trace under the same jitter
   on every ray water-filling kept whole (rgb, semantics, inst_embedding
   within 1e-4, depth within 1e-4 of its largest value; float32 decoders,
   the bfloat16 difference reported); the packed layout's backward
   bit-equal over two runs; one microbatch's gradients through the kernels
   vs the plain backward (default algorithms; a second run's spread
   reported); the encode's coordinate gradient on the forward's rank at
   N = B (``profile_encode.backward_rank_check``); ``reset_moments``
   keeping the counts. Then, on random tables through the wrappers, the
   single encode at the prune's N = 65,536 and at N = B, the dual encode at
   N = B (outputs within the encode phase's per-level bound, the kept
   idx/bary against the plain lattice: a vertex may differ only where the
   plain weight is within an ulp of el of 0), the dual scatter (64 eps) and
   dbary (4 eps) at B against their plain versions, and their times. Prune
   ms, kept share, occupied share, pack_steps, B, step ms, rays/s, peak
   memory, truncated share.

9. validate -- main path 5: ``validate_flagship`` at full width, its launch
   counts set to 0 before and read after each part: the schedule's first
   validation before the prune (epoch 99: mip 2, 4 'val' images of 16x12
   rays, 512 dense steps, rgb and depth, the single encode once per image
   at N = 98,304), the schedule past the prune (as in ``train_post_prune``),
   the final validation (mip 0, 3072 rays per image in one chunk, the voxel
   march and the packed layout at each chunk's budget, all four channels,
   the dual encode once per image, synthetic 2-D predictions for the
   ``_pred`` baselines), and the point-cloud map (8 views at mip 2, the
   dual encode once per view); media go to ``pagnerf_tpu_torch/_build/
   validate``. Checks: those launches, none with idx/bary; no packed chunk
   truncated: each final image packed vs dense within 1e-4 (float32
   decoders); the final validation through the
   kernels vs through the plain encodes (channels 1e-2, PSNR 0.05 dB,
   flipped argmax pixels counted); finite, complete metrics and a
   well-formed map; the single and dual encode at the largest N each part
   ran, on random tables, against the plain encode (the encode phase's
   per-level bound, the kernel's lattice against the plain one by the
   boundary rule), and their times (the dual also with two table loads,
   no packed copy). Metrics, ``val/render_time_per_img``,
   wall times and the map's point count.

10. cli -- main path 6: ``cli.main`` (the command line) on
   ``configs/synthetic/schedule_preds_flagship_tuned_60ep.yaml`` at full
   width (24 LoDs x 2^18 x F=2, main and delta grid, 120 views at 96x72,
   4096 rays per image, 5 images per step, 96 dense steps, the voxel march
   of 256 steps and the packed layout after the prune) for 4 epochs, its
   milestones moved by ``CLI_FLAGS``: LoD annealing and an LR step, the
   seed prune, the real prune and the voxel switch, the panoptic heads with
   sem_conf / inst_conf, a val-pose epoch, checkpoints, a validation and the
   final validation; ``--perf`` makes the trainer's timer write each step,
   prune, epoch and validation to the run's ``perf.jsonl``. Launch counts
   set to 0 before and read after: the encodes, scatters and dbary the
   sampled cameras, the prunes and the validation chunks imply, the
   gathers never. Then ``--valid-only --pretrained`` the final checkpoint
   must reproduce the final metrics exactly. While the run goes, the first
   call of each kernel at each N the training path gives it is recorded
   (the dense microbatch's N = 4096 x 96 = 393,216, the seed prune's packed
   B, the voxel stage's packed B); after it, each is held against its plain
   version there: the single and dual encode on the recorded coordinates
   with random tables (the encode phase's per-level bound, the kept
   idx/bary by the boundary rule), the single and dual scatter (64 eps) and
   dbary (4 eps) on the recorded idx, bary, cotangents and tables (the dual
   scatter also where the path ran only the single one, its second
   cotangent random); their times and bounds. Each epoch's wall and
   losses, the prunes' walls and kept shares, B and the truncated share;
   run directories under ``pagnerf_tpu_torch/_build/cli``.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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


def table_bytes(rows_used, c, f, itemsize):
    """Bytes of a [L, C, F] table that the lattice can index: a direct
    level's ``4 * Dm^3`` reachable rows (``rows_used``, from
    ``permuto_encoding.level_statics``), a hashed level's (0) all C."""
    return sum(min(r or c, c) for r in rows_used) * f * itemsize


def gather_bound(l, c, f, n, num_tables, itemsize, rows_used):
    """Least time for the gather at these shapes: bytes (idx read once, bary
    and each table's reachable rows read once, each output written once)
    over the memory rate, against flops (V products and sums per output)
    over the float32 rate."""
    v = 4
    nbytes = l * v * n * 4 + l * v * n * itemsize \
        + num_tables * (table_bytes(rows_used, c, f, itemsize) + l * f * n * itemsize)
    return _bound(nbytes, num_tables * l * f * n * v * 2)


# float32 operations of the fused encode's lattice per (level, sample):
# scaling 3, elevation 16, rounding 12, differences and deltas 12, weights 7
# (csrc/permuto_encode.cu ``simplex``; the index math is integer)
LATTICE_FLOPS = 50


def encode_bound(l, c, f, n, num_tables, itemsize, with_lattice, rows_used):
    """Least time for the fused encode: bytes (x read once, each table's
    reachable rows read once, each output written once, and idx/bary when
    written) over the memory rate, against flops (the lattice, and V
    products and sums per output) over the float32 rate."""
    v = 4
    nbytes = 3 * n * 4 + num_tables * (table_bytes(rows_used, c, f, itemsize)
                                       + l * f * n * itemsize)
    if with_lattice:
        nbytes += 2 * l * v * n * 4
    return _bound(nbytes, l * n * (LATTICE_FLOPS + num_tables * f * v * 2))


def scatter_bound(l, c, f, n, num_tables):
    """Least time for the table-gradient scatter: idx and bary read once,
    each table's cotangent g [L, F, N] read once and gradient [L, C, F]
    written once in full, unreachable rows being zeros of the output too
    (float32); one product and one sum per event and feature."""
    v = 4
    nbytes = 2 * l * v * n * 4 + num_tables * (l * f * n * 4 + l * c * f * 4)
    return _bound(nbytes, num_tables * l * v * n * f * 2)


def dbary_bound(l, c, f, n, rows_used):
    """Least time for dbary: idx, g and the table's reachable rows read
    once, dbary written once (float32); F products and sums per output."""
    v = 4
    nbytes = l * v * n * 4 + l * f * n * 4 + table_bytes(rows_used, c, f, 4) \
        + l * v * n * 4
    return _bound(nbytes, l * v * n * f * 2)


def _kernel_wrappers():
    """Every kernel wrapper of the port, by name, with its launch count."""
    # importing permuto_encoding registers the fused encodes in KERNELS
    from pagnerf_tpu_torch.ops import permuto_encoding  # noqa: F401
    from pagnerf_tpu_torch.ops import scatter_rows, table_gather
    return {**table_gather.KERNELS, "scatter_rows": scatter_rows.scatter_rows}


def _reset_launches() -> None:
    from pagnerf_tpu_torch.ops import scatter_rows, table_gather
    _kernel_wrappers()                  # registers the fused encodes first
    table_gather.reset_launches()
    scatter_rows.scatter_rows.launches = 0


def _launches() -> dict:
    return {k: fn.launches for k, fn in _kernel_wrappers().items()}


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from pagnerf_tpu_torch.ops import _build, permuto_encoding, table_gather

    def timed(name):
        t = time.perf_counter()
        path = _build.build(name)
        return os.path.relpath(path, ROOT), time.perf_counter() - t

    t = time.perf_counter()
    sources = ("permuto_encode", "permuto_gather", "permuto_scatter")
    with ThreadPoolExecutor(len(sources)) as ex:
        futures = {n: ex.submit(timed, n) for n in sources}
        built = {n: f.result() for n, f in futures.items()}
    permuto_encoding._encode_kernel()
    table_gather._kernel()
    table_gather._scatter_kernels()
    emit("build", wall_seconds=time.perf_counter() - t,
         seconds={n: s for n, (_, s) in built.items()},
         libraries={n: p for n, (p, _) in built.items()},
         flags=" ".join(_build.NVCC_FLAGS))


def render_coords(pipe, origins, dirs, cam_idx):
    """Sample coordinates [3, N] of the flagship render (its march)."""
    import torch

    from pagnerf_tpu_torch.core.rays import Rays
    from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid
    from pagnerf_tpu_torch.ops.raymarch import raymarch

    occ = OccupancyGrid.create(level=7, device=origins.device)
    with torch.no_grad():
        rays = pipe.transform_rays(
            Rays(origins=origins, dirs=dirs, dist_min=0.0, dist_max=6.0), cam_idx)
        coordsT = raymarch(rays, occ, pipe.tracer_cfg.num_steps).positionsT
    return coordsT.reshape(3, -1).contiguous()


def phase_encode(dev, spec, coords, flush):
    """The fused encode kernels against their plain versions, at the render's
    and a training microbatch's coordinates (``coords``: name -> x [3, N])."""
    import torch

    from pagnerf_tpu_torch.ops import permuto_encoding as pe
    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.profile_scatter import microbatch_lattice

    l, c, f = spec.num_levels, spec.capacity, spec.feature_dim
    st = pe.level_statics(spec.scales, c, f)
    gen = torch.Generator(device=dev).manual_seed(4)
    results = {}
    for where, x in coords.items():
        n = x.shape[1]
        with_lattice = where == "train"      # training keeps idx/bary for the backward
        idx_p, bary_p = microbatch_lattice(spec, x)
        el_ulp = el_ulps(x, st)
        for dtype in (torch.float32, torch.bfloat16):
            ta = torch.randn((l, c, f), generator=gen, device=dev).to(dtype)
            tb = torch.randn((l, c, f), generator=gen, device=dev).to(dtype)
            (single,), idx_k, bary_k, _ = pe._launch_encode(x, (ta,), st, True, False)
            (oa, ob), idx_d, bary_d, _ = pe._launch_encode(x, (ta, tb), st, True, True)
            (oa2, ob2), _, _, _ = pe._launch_encode(x, (ta, tb), st, False, False)
            pa, pb = tg.dual_gather_plain(ta, tb, idx_p, bary_p.to(dtype))
            torch.cuda.synchronize()
            # per level: one ulp of el moves each of the 4 weights by at most
            # ulp/4, and the products and sums round in float32; bfloat16
            # outputs may then round one bf16 ulp apart
            worst, err = 0.0, 0.0
            for lv in range(l):
                tmax = max(ta[lv].float().abs().max().item(), tb[lv].float().abs().max().item())
                tol = (4 * el_ulp[lv] + 8 * F32_EPS) * tmax
                if dtype == torch.bfloat16:
                    tol += BF16_ULP * max(pa[lv].float().abs().max().item(),
                                          pb[lv].float().abs().max().item())
                e_lv = max((oa[lv].float() - pa[lv].float()).abs().max().item(),
                           (ob[lv].float() - pb[lv].float()).abs().max().item())
                err, worst = max(err, e_lv), max(worst, e_lv / tol)
            mismatches = int((idx_k != idx_p).sum())
            check = dict(
                idx_mismatches=mismatches, idx_entries=idx_p.numel(),
                idx_equal_share=1.0 - mismatches / idx_p.numel(),
                bary_bit_equal_share=(bary_k.view(torch.int32) == bary_p.view(torch.int32))
                .float().mean().item(),
                max_abs_err=err, worst_err_over_tol=worst,
                tol="(4 ulp_f32(max|el_l|) + 8 eps_f32) max|table_l| per level"
                    + (" + 1 bf16 ulp of max|out_l|" if dtype == torch.bfloat16 else ""),
                single_equals_dual_a=torch.equal(single, oa),
                packed_equals_two_loads=torch.equal(oa, oa2) and torch.equal(ob, ob2),
                dual_lattice_equals_single=torch.equal(idx_d, idx_k)
                and torch.equal(bary_d, bary_k))
            del single, idx_k, bary_k, oa, ob, idx_d, bary_d, oa2, ob2, pa, pb
            ok = (mismatches <= 1e-6 * idx_p.numel() and worst <= 1.0
                  and check["single_equals_dual_a"] and check["packed_equals_two_loads"]
                  and check["dual_lattice_equals_single"])
            if not ok:
                emit("encode", ok=False, at=where, dtype=str(dtype).replace("torch.", ""),
                     **check)
                raise AssertionError(f"fused encode {where} {dtype} vs plain: {check}")

            # times: the wrappers as the main path calls them (idx/bary kept
            # when the tables need a gradient, as in training)
            ta.requires_grad_(with_lattice)
            tb.requires_grad_(with_lattice)
            scales = spec.scales
            itemsize = ta.element_size()
            times = {}
            for name, num_tables, kern, plain in (
                    ("single", 1, lambda: pe.fused_encode(ta, x, scales),
                     lambda: pe.encode_plain(ta.detach(), x, scales)),
                    ("dual", 2, lambda: pe.fused_encode_dual(ta, tb, x, scales),
                     lambda: pe.dual_encode_plain(ta.detach(), tb.detach(), x, scales)),
                    ("dual_two_loads", 2,
                     lambda: pe._launch_encode(x, (ta, tb), st, with_lattice, False), None)):
                bound_ms, bound_by, nbytes, flops = encode_bound(
                    l, c, f, n, num_tables, itemsize, with_lattice, st.rows_used)
                times[name] = dict(ms=cuda_ms(kern, flush=flush),
                                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                                   flops=flops)
                if plain is not None:
                    with torch.no_grad():
                        times[name]["plain_ms"] = cuda_ms(plain, reps=5, flush=flush)
            results[(where, dtype)] = dict(check, **times)
            emit("encode", at=where, dtype=str(dtype).replace("torch.", ""), L=l, C=c,
                 F=f, N=n, idx_bary_written=with_lattice, **results[(where, dtype)])
            del ta, tb
        del idx_p, bary_p
    return results


def phase_kernels_fwd(dev, pipe, coordsT, flush):
    import torch
    import torch.nn.functional as F

    from pagnerf_tpu_torch.ops import permuto_encoding, table_gather

    spec = pipe.nef.grid.spec
    with torch.no_grad():
        idx, bary32 = permuto_encoding.lattice(pipe.nef.grid.tables, coordsT,
                                                spec.scales)
    l, _, n = idx.shape
    c, f = spec.capacity, spec.feature_dim
    rows_used = permuto_encoding.level_statics(spec.scales, c, f).rows_used
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
                l, c, f, n, num_tables, ta.element_size(), rows_used)
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


def phase_kernels_bwd(dev, spec, x_train, flush):
    import torch

    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.ops.permuto_encoding import scatter_plan
    from pagnerf_tpu_torch.profile_scatter import device_ms, level_stats, microbatch_lattice

    idx, bary = microbatch_lattice(spec, x_train)
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
    bound_ms, bound_by, nbytes, flops = dbary_bound(l, c, f, n, rows_used)
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

    from pagnerf_tpu_torch.ops import permuto_encoding as pe

    rd = frozenset({"rgb", "depth"})
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = fn(pipe, origins, dirs, cam_idx)
    out_rd = fn(pipe, origins, dirs, cam_idx, channels=rd)
    torch.cuda.synchronize()
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {"encode": 1, "dual_encode": 1, "gather": 0, "dual_gather": 0}
    if {k: launches[k] for k in expected} != expected:
        raise AssertionError(f"the renders launched {launches}, expected {expected}")

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

    with mock.patch.object(pe, "fused_encode", pe.encode_plain), \
         mock.patch.object(pe, "fused_encode_dual", pe.dual_encode_plain):
        plain_out = fn(pipe, origins, dirs, cam_idx)
        plain_ms = [0.0] * 3
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(pipe, origins, dirs, cam_idx)
            torch.cuda.synchronize()
            plain_ms[i] = (time.perf_counter() - t) * 1e3
    # Kernel and plain encodes round differently only in the last float32
    # bits; the bfloat16 decoders can turn that into one bf16 ulp of a hidden
    # unit, which integrates to well under 1e-2 in a probability or colour.
    errs, tols = {}, {}
    for ch, a, b in zip(shapes, out, plain_out):
        errs[ch] = (a - b).abs().max().item()
        tols[ch] = 1e-2 * (b.abs().max().item() if ch == "depth" else 1.0)
        if not errs[ch] <= tols[ch]:
            raise AssertionError(f"{ch}: kernel render vs plain-encode render "
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
         render_ms=render_ms, plain_encode_render_ms_median=statistics.median(plain_ms),
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
    fwd, grad = (("encode", "table_grad") if stage_name == "rgb"
                 else ("dual_encode", "dual_table_grad"))
    other_fwd, other_grad = (("dual_encode", "dual_table_grad") if stage_name == "rgb"
                             else ("encode", "table_grad"))
    expected = {fwd: micro, grad: micro, other_fwd: 0, other_grad: 0,
                "gather": 0, "dual_gather": 0, "dbary": non_anchor, "scatter_rows": 0}
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


class _Float32Decoders:
    """Run a pipeline's bfloat16 decoders in float32 inside the block."""

    def __init__(self, pipe):
        import torch
        self.saved = [(m, a) for m in pipe.modules() for a in ("compute_dtype", "dtype")
                      if getattr(m, a, None) is torch.bfloat16]

    def __enter__(self):
        import torch
        for m, a in self.saved:
            setattr(m, a, torch.float32)

    def __exit__(self, *exc):
        import torch
        for m, a in self.saved:
            setattr(m, a, torch.bfloat16)


def el_ulps(x, st):
    """Per level, one float32 ulp of the largest |el| = |E @ (x / s_l)|."""
    import torch

    from pagnerf_tpu_torch.ops import permuto_encoding as pe

    e = torch.as_tensor(pe._E, dtype=torch.float32, device=x.device)
    with torch.no_grad():
        return [2.0 ** (math.floor(math.log2(
            (e @ (x * torch.tensor(inv_s, device=x.device))).abs().max().item())) - 23)
            for inv_s in st.inv_scales]


def encode_vs_plain(spec, x, tables, outs, idx_k=None, bary_k=None):
    """A float32 fused encode's outputs, and the lattice it kept, against the
    plain encode on the same tables at one of the main path's N. Outputs per
    level within (4 ulp_f32(max|el_l|) + 8 eps_f32) max|table_l| (the encode
    phase's bound). cuBLAS picks the plain lattice's rounding order of E @ s
    by N, and at some N rounds el apart from the kernel: a vertex may differ
    from the plain lattice's only where the plain weight is within one ulp
    of el of 0, and where they agree each weight is within that ulp.
    Returns the check's fields, with ``ok``."""
    import torch

    from pagnerf_tpu_torch.ops import permuto_encoding as pe

    st = pe.level_statics(spec.scales, spec.capacity, spec.feature_dim)
    ulps = el_ulps(x, st)
    with torch.no_grad():
        want = ((pe.encode_plain(tables[0], x, spec.scales),) if len(tables) == 1
                else pe.dual_encode_plain(*tables, x, spec.scales))
    worst, err = 0.0, 0.0
    for lv, ulp in enumerate(ulps):
        tol = (4 * ulp + 8 * F32_EPS) * max(t[lv].abs().max().item() for t in tables)
        e_lv = max((o[lv] - w[lv]).abs().max().item() for o, w in zip(outs, want))
        err, worst = max(err, e_lv), max(worst, e_lv / tol)
    fields = dict(N=x.shape[1], tables=len(tables), max_abs_err=err,
                  worst_err_over_tol=worst,
                  tol="(4 ulp_f32(max|el_l|) + 8 eps_f32) max|table_l| per level")
    ok = worst <= 1.0
    if idx_k is not None:
        idx_p, bary_p = pe.lattice(tables[0], x, spec.scales)
        bad = idx_k != idx_p
        off_boundary = sum(int((bary_p[lv][bad[lv]].abs() > ulp).sum())
                           for lv, ulp in enumerate(ulps))
        # where the vertices agree, each weight within one ulp of el
        bary_err = [(bary_k[lv] - bary_p[lv])[~bad[lv]].abs().max().item() / ulp
                    for lv, ulp in enumerate(ulps)]
        fields.update(idx_mismatches=int(bad.sum()), idx_entries=bad.numel(),
                      idx_mismatches_off_boundary=off_boundary,
                      bary_worst_err_over_el_ulp=max(bary_err))
        ok = ok and off_boundary == 0 and max(bary_err) <= 1.0
        del idx_p, bary_p, bad
    fields["ok"] = ok
    return fields


def packed_layout_grads(rays, occ, stage, jitter, ray_max_travel, budget, seed):
    """Gradients of random per-ray targets of the packed layout (the voxel
    march, ``pack_samples``, ``packed_integration_weights`` and
    ``packed_composite``, with random per-sample densities and features) to
    the rays' origins and directions: the layout's backward alone."""
    import torch

    from pagnerf_tpu_torch.core.rays import Rays
    from pagnerf_tpu_torch.ops.packed import (pack_samples, packed_composite,
                                              packed_integration_weights)
    from pagnerf_tpu_torch.ops.raymarch import raymarch

    dev = jitter.device
    o = rays.origins.detach().clone().requires_grad_()
    d = rays.dirs.detach().clone().requires_grad_()
    rm = raymarch(Rays(origins=o, dirs=d, dist_min=rays.dist_min, dist_max=rays.dist_max),
                  occ, stage.num_steps, "voxel", jitter, ray_max_travel)
    ps = pack_samples(rm, o.T, d.T, budget)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w_tau = torch.rand((budget,), generator=gen, device=dev) * 8
    w_f = torch.rand((5, budget), generator=gen, device=dev)
    tau = w_tau * (ps.positionsT.sum(0) * ps.depths).abs()
    weights, alpha = packed_integration_weights(tau, ps)
    comp = packed_composite(w_f * ps.depths[None], weights, ps)
    g_c = torch.randn(comp.shape, generator=gen, device=dev)
    g_a = torch.randn(alpha.shape, generator=gen, device=dev)
    return torch.autograd.grad((comp * g_c).sum() + (alpha * g_a).sum(), (o, d))


def schedule_launches(trainer, steps):
    """The launches ``run_past_prune`` implies: its training ``steps`` (its
    log past the prune's entry) and its prune (the single encode once per
    chunk of 65,536 cell points per jittered sample)."""
    anchor = trainer.pipeline.anchor_mask.cpu().numpy()
    keys = _launches()
    expected = {k: 0 for k in keys}
    for s_ in steps:
        dual = "semantics" in s_["stage"].channels
        expected["dual_encode" if dual else "encode"] += len(s_["cam_idx"])
        expected["dual_table_grad" if dual else "table_grad"] += len(s_["cam_idx"])
        expected["dbary"] += sum(int(not anchor[c]) for c in s_["cam_idx"])
    chunks = (max(1, trainer.cfg.prune_samples_per_cell)
              * math.ceil(trainer.occ.res ** 3 / 65536))
    return expected, {k: (chunks if k == "encode" else 0) for k in keys}


def phase_train_post_prune(dev, flush):
    """Main path 4: the default schedule past its prune at full width
    (``train_flagship_schedule``): the prune, the scene fixture's occupancy,
    3 panoptic steps and 1 val-pose step on the voxel march and the packed
    layout. Then the checks, and the kernels against their plain versions
    and timed at this path's N."""
    import numpy as np
    import torch
    from unittest import mock

    from pagnerf_tpu_torch.core.rays import Rays
    from pagnerf_tpu_torch.entry import train_flagship_schedule
    from pagnerf_tpu_torch.ops import permuto_encoding as pe
    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.ops.packed import pack_samples
    from pagnerf_tpu_torch.ops.raymarch import raymarch
    from pagnerf_tpu_torch.profile_encode import backward_rank_check

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    info = {}

    def after_prune(trainer):
        torch.cuda.synchronize()
        info["prune_launches"] = _launches()
        _reset_launches()

    _reset_launches()
    trainer, log = train_flagship_schedule(steps=3, device=dev, after_prune=after_prune)
    torch.cuda.synchronize()
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    prune, steps = log[0], log[1:]
    pipe, cfg = trainer.pipeline, trainer.cfg
    anchor = pipe.anchor_mask.cpu().numpy()

    expected, expected_prune = schedule_launches(trainer, steps)
    stage = steps[0]["stage"]
    fields = dict(
        prune_ms=prune["seconds"] * 1e3, prune_kept_share=prune["occupied_share"],
        prune_launches=info["prune_launches"], expected_prune_launches=expected_prune,
        fixture="scene spheres and wall, dilated by one cell (smoke fixture)",
        occupied_share=trainer._occ_frac, num_steps=stage.num_steps,
        pack_steps=stage.pack_steps, B=stage.pack_steps * cfg.num_rays_sampled_per_img,
        launches=launches, expected_launches=expected,
        losses=[s_["losses"] for s_ in steps], cam_idx=[s_["cam_idx"] for s_ in steps],
        step_epochs=[s_["epoch"] for s_ in steps],
        step_channels=[sorted(s_["stage"].channels) for s_ in steps])

    def fail(msg):
        emit("train_post_prune", ok=False, **fields)
        raise AssertionError(msg)

    if info["prune_launches"] != expected_prune:
        fail(f"the prune launched {info['prune_launches']}, expected {expected_prune}")
    if launches != expected:
        fail(f"post-prune steps launched {launches}, expected {expected}")
    if not all(np.isfinite(v) for s_ in steps for v in s_["losses"].values()):
        fail("post-prune losses not finite")
    if not (len(steps) == 4 and all(
            {"semantics", "inst_embedding"} <= s_["stage"].channels
            and not s_["stage"].training_val_poses for s_ in steps[:3])
            and steps[3]["stage"].training_val_poses):
        fail("post-prune steps are not 3 panoptic steps and 1 val-pose step")
    if not (0.01 <= trainer._occ_frac <= 0.40 and all(
            s_["stage"].raymarch_type == "voxel" and s_["stage"].pack_steps > 0
            for s_ in steps)):
        fail(f"post-prune stages not the voxel march with packing: {stage}")

    # one 65,536-point chunk of the prune's density, kernel vs plain encode
    centers = trainer.occ.cell_centers_jittered_T(
        torch.Generator(device=dev).manual_seed(7))[:, :65536].contiguous()
    with torch.no_grad():
        d_k = pipe.query_density(centers, trainer.lod_w)
        with mock.patch.object(pe, "fused_encode", pe.encode_plain):
            d_p = pipe.query_density(centers, trainer.lod_w)
    fields.update(prune_density_max_abs_err=(d_k.float() - d_p.float()).abs().max().item(),
                  prune_density_tol=1e-2 * max(1.0, d_p.float().abs().max().item()))
    if not fields["prune_density_max_abs_err"] <= fields["prune_density_tol"]:
        fail("prune density through the kernel vs the plain encode outside 1e-2")

    # one non-anchor microbatch of the panoptic stage
    batch = trainer.dataset.sample_batch(np.random.default_rng(1), cfg.batch_size,
                                         cfg.num_rays_sampled_per_img)
    m = int(np.nonzero(~anchor[batch["cam_idx"]])[0][0])
    sub = {k: v[m:m + 1] if getattr(v, "ndim", 0) >= 1
           and v.shape[0] == batch["imgs"].shape[0] else v for k, v in batch.items()}
    r = cfg.num_rays_sampled_per_img
    budget = stage.pack_steps * r
    jitter = torch.rand((r, stage.num_steps), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    base = Rays(origins=torch.from_numpy(sub["base_rays_origins"]).to(dev),
                dirs=torch.from_numpy(sub["base_rays_dirs"]).to(dev),
                dist_min=0.0, dist_max=6.0)
    cam = torch.from_numpy(sub["cam_idx"]).long().to(dev)
    packed_cfg = dataclasses.replace(pipe.tracer_cfg, raymarch_type="voxel",
                                     num_steps=stage.num_steps, pack_steps=stage.pack_steps)
    dense_cfg = dataclasses.replace(packed_cfg, pack_steps=0)
    with torch.no_grad():
        rays = pipe.transform_rays(base, cam)
        rm = raymarch(rays, trainer.occ, stage.num_steps, "voxel", jitter,
                      packed_cfg.ray_max_travel)
        ps = pack_samples(rm, rays.origins.T, rays.dirs.T, budget)
        counts = rm.mask.sum(-1)
        keep = ps.offsets[1:] - ps.offsets[:-1]
        untruncated = keep == counts
        fields.update(truncated_ray_share=1.0 - untruncated.float().mean().item(),
                      packed_used=int(ps.offsets[-1]), valid_samples=int(counts.sum()),
                      mean_valid_per_ray=counts.float().mean().item())
        chans = ("rgb", "depth", "semantics", "inst_embedding")
        outs = {}
        for name, dec32 in (("float32", True), ("bfloat16", False)):
            with _Float32Decoders(pipe) if dec32 else contextlib.nullcontext():
                rb_p = pipe(base, stage.channels, trainer.occ, trainer.lod_w, stage="train",
                            cam_idx=cam, jitter=jitter, tracer_cfg=packed_cfg)
                rb_d = pipe(base, stage.channels, trainer.occ, trainer.lod_w, stage="train",
                            cam_idx=cam, jitter=jitter, tracer_cfg=dense_cfg)
            outs[name] = {ch: (getattr(rb_p, ch)[untruncated].float()
                               - getattr(rb_d, ch)[untruncated].float()).abs().max().item()
                          for ch in chans}
            if name == "float32":
                depth_max = getattr(rb_d, "depth").abs().max().item()
    tol = {ch: 1e-4 * (max(1.0, depth_max) if ch == "depth" else 1.0) for ch in chans}
    fields.update(packed_vs_dense_err_float32_decoders=outs["float32"],
                  packed_vs_dense_tol=tol, packed_vs_dense_err_bf16_decoders=outs["bfloat16"])
    if not all(outs["float32"][ch] <= tol[ch] for ch in chans):
        fail("packed trace vs dense voxel trace outside 1e-4 on untruncated rays")

    # the packed layout's backward is the same on every run
    g1 = packed_layout_grads(rays, trainer.occ, stage, jitter, packed_cfg.ray_max_travel,
                             budget, 4)
    g2 = packed_layout_grads(rays, trainer.occ, stage, jitter, packed_cfg.ray_max_travel,
                             budget, 4)
    fields["packed_backward_bit_equal_on_rerun"] = all(
        torch.equal(a, b) for a, b in zip(g1, g2))
    del g1, g2
    if not fields["packed_backward_bit_equal_on_rerun"]:
        fail("the packed layout's backward differs between two runs")

    # gradients through the kernels at B against the plain backward, with
    # the algorithms the training path uses; a second run through the
    # kernels reports their spread (the table scatter adds with atomics)
    g_k, l_k = trainer.grad_step(stage, sub, jitter)
    g_p, _, mags = _plain_backward_grads(trainer, stage, sub, jitter)
    g_n, _ = trainer.grad_step(stage, sub, jitter)
    worst, rerun = {}, {}
    for name, mag in mags.items():
        tol_ = (64 * F32_EPS * mag).clamp(min=1e-30)
        worst[name] = ((g_k[name] - g_p[name]).abs() / tol_).max().item()
        rerun[name] = ((g_n[name] - g_k[name]).abs() / tol_).max().item()
    ext_ref = g_p["extrinsics"].abs().max().item()
    ext_err = (g_k["extrinsics"] - g_p["extrinsics"]).abs().max().item()
    fields.update(plain_check_table_worst_err_over_tol=worst,
                  plain_check_extrinsics_err=ext_err, plain_check_extrinsics_max=ext_ref,
                  plain_check_losses_finite=all(np.isfinite(float(v)) for v in l_k.values()),
                  rerun_table_worst_err_over_tol=rerun,
                  rerun_extrinsics_err=(g_n["extrinsics"] - g_k["extrinsics"]).abs().max().item())
    del g_n, g_p, mags
    if not (all(w <= 1.0 for w in worst.values()) and ext_ref > 0
            and ext_err <= 1e-3 * ext_ref and fields["plain_check_losses_finite"]):
        fail("post-prune gradients through the kernels vs the plain backward")

    # the encode's backward on the forward's rank at this B
    x_b = ps.positionsT.contiguous()
    spec = pipe.nef.grid.spec
    l, c, f = spec.num_levels, spec.capacity, spec.feature_dim
    gen = torch.Generator(device=dev).manual_seed(3)
    g_b = torch.randn((l, f, x_b.shape[1]), generator=gen, device=dev)
    rank_check = backward_rank_check(pipe.nef.grid.tables.detach(), x_b, spec.scales, g_b)
    fields["rank_check"] = rank_check
    if not (rank_check["dx_bit_equal"] or rank_check["dx_err_over_max"] <= 1e-6):
        fail(f"encode backward not on the forward's simplex at B: {rank_check}")

    # Adam's reset after a prune keeps the counts
    counts_before = dict(trainer.opt.count)
    trainer.opt.reset_moments()
    if trainer.opt.count != counts_before or any(v.any() for v in trainer.opt.mu.values()):
        fail("reset_moments changed the counts or kept a moment")
    fields["reset_moments_counts"] = counts_before

    step_ms = [s_["seconds"] * 1e3 for s_ in steps]
    steady = statistics.median(step_ms[1:3])
    fields.update(step_ms=step_ms, step_ms_steady_median=steady,
                  rays_per_s=len(steps[2]["cam_idx"]) * r / (steady / 1e3),
                  val_pose_step_ms=step_ms[3], peak_allocated_gib=peak_gb)

    # the kernels at this path's N, on random tables (the trainer's are
    # ~1e-4, under the decoders' biases), through the wrappers as the path
    # calls them: the single encode at the prune's N = 65,536 (no idx/bary)
    # and at N = B (the val-pose step, idx/bary kept), the dual encode at
    # N = B with idx/bary, and on its lattice the dual scatter and dbary
    ta = torch.randn((l, c, f), generator=gen, device=dev)
    tb = torch.randn((l, c, f), generator=gen, device=dev)
    a, b = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    st = pe.level_statics(spec.scales, c, f)
    nb = x_b.shape[1]
    checks = {}
    with torch.no_grad():
        out = pe.fused_encode(ta, centers, spec.scales)
    checks["encode_prune"] = encode_vs_plain(spec, centers, (ta,), (out,))
    out = pe.fused_encode(a, x_b, spec.scales)
    _, idx, bary, _ = out.grad_fn.saved_tensors
    checks["encode_B"] = encode_vs_plain(spec, x_b, (ta,), (out.detach(),), idx, bary)
    oa, ob = pe.fused_encode_dual(a, b, x_b, spec.scales)
    _, idx, bary, _ = oa.grad_fn.saved_tensors
    checks["dual_encode_B"] = encode_vs_plain(spec, x_b, (ta, tb),
                                              (oa.detach(), ob.detach()), idx, bary)
    del out, oa, ob
    g_a = torch.randn((l, f, nb), generator=gen, device=dev)
    plan = dict(rows_used=st.rows_used, modes=st.modes)
    got = tg.dual_multilevel_table_grad(idx, bary, g_a, g_b, c, **plan)
    worst = 0.0
    for d_, g_ in zip(got, (g_a, g_b)):
        diff = (d_ - tg.table_grad_plain(idx, bary, g_, c, st.rows_used)).abs()
        tol_ = 64 * F32_EPS * tg.table_grad_plain(idx, bary.abs(), g_.abs(), c, st.rows_used)
        worst = max(worst, (diff / tol_.clamp(min=1e-30)).max().item())
    del got, diff, tol_
    checks["dual_table_grad_B"] = dict(N=nb, worst_err_over_tol=worst,
                                       tol="64 eps_f32 * sum|bary*g| per entry",
                                       ok=worst <= 1.0)
    got = tg.multilevel_gather_dbary(ta, idx, g_a)
    diff = (got - tg.gather_dbary_plain(ta, idx, g_a)).abs()
    mag = tg.gather_dbary_plain(ta.abs(), idx, g_a.abs())
    worst = (diff / (4 * F32_EPS * mag).clamp(min=1e-30)).max().item()
    checks["dbary_B"] = dict(N=nb, max_abs_err=diff.max().item(), worst_err_over_tol=worst,
                             tol="4 eps_f32 * sum_f |g*T| per entry", ok=worst <= 1.0)
    del got, diff, mag
    fields["kernel_checks"] = checks
    if not all(ch["ok"] for ch in checks.values()):
        fail(f"a kernel at this path's N outside its tolerance: {checks}")

    times = {}
    bound_ms, bound_by, _, _ = encode_bound(l, c, f, centers.shape[1], 1, 4, False,
                                            st.rows_used)
    with torch.no_grad():
        times["encode_prune"] = dict(
            N=centers.shape[1], max_abs_err=checks["encode_prune"]["max_abs_err"],
            ms=cuda_ms(lambda: pe.fused_encode(ta, centers, spec.scales), flush=flush),
            plain_ms=cuda_ms(lambda: pe.encode_plain(ta, centers, spec.scales), flush=flush),
            bound_ms=bound_ms, bound_by=bound_by)
    bound_ms, bound_by, _, _ = encode_bound(l, c, f, nb, 2, 4, True, st.rows_used)
    times["dual_encode_B"] = dict(
        N=nb, max_abs_err=checks["dual_encode_B"]["max_abs_err"],
        ms=cuda_ms(lambda: pe.fused_encode_dual(a, b, x_b, spec.scales), flush=flush),
        plain_ms=cuda_ms(lambda: pe.dual_encode_plain(ta, tb, x_b, spec.scales), flush=flush),
        bound_ms=bound_ms, bound_by=bound_by)
    bound_ms, bound_by, _, _ = scatter_bound(l, c, f, nb, 2)
    times["dual_table_grad_B"] = dict(
        N=nb, worst_err_over_tol=checks["dual_table_grad_B"]["worst_err_over_tol"],
        ms=cuda_ms(lambda: tg.dual_multilevel_table_grad(idx, bary, g_a, g_b, c, **plan),
                   flush=flush),
        plain_ms=cuda_ms(lambda: tg.dual_table_grad_plain(idx, bary, g_a, g_b, c),
                         flush=flush),
        bound_ms=bound_ms, bound_by=bound_by)
    bound_ms, bound_by, _, _ = dbary_bound(l, c, f, nb, st.rows_used)
    times["dbary_B"] = dict(
        N=nb, max_abs_err=checks["dbary_B"]["max_abs_err"],
        ms=cuda_ms(lambda: tg.multilevel_gather_dbary(ta, idx, g_a), flush=flush),
        plain_ms=cuda_ms(lambda: tg.gather_dbary_plain(ta, idx, g_a), flush=flush),
        bound_ms=bound_ms, bound_by=bound_by)
    fields["kernel_times"] = times
    emit("train_post_prune", **fields)
    all_launches = {k: launches[k] + info["prune_launches"][k] for k in launches}
    del trainer, idx, bary, g_a, g_b, x_b, ps, rm, a, b, ta, tb
    torch.cuda.empty_cache()
    return all_launches, times

def _idx_bary_launches() -> dict:
    """The fused encodes' launches that wrote idx/bary for a backward."""
    from pagnerf_tpu_torch.ops import permuto_encoding as pe
    return {"encode": pe.fused_encode.launches_with_idx_bary,
            "dual_encode": pe.fused_encode_dual.launches_with_idx_bary}


def _flips(rb_a, rb_b, stuff_ids):
    """Pixels whose semantic argmax, or gated instance argmax on things
    pixels, differs between two renders."""
    import torch

    sem_a, sem_b = rb_a.semantics.argmax(-1), rb_b.semantics.argmax(-1)
    things = ~torch.isin(sem_b, torch.tensor(stuff_ids, device=sem_b.device))
    inst = things & (rb_a.inst_embedding[:, 1:].argmax(-1)
                     != rb_b.inst_embedding[:, 1:].argmax(-1))
    return int((sem_a != sem_b).sum()), int(inst.sum())


def phase_validate(dev, flush):
    """Main path 5: ``validate_flagship`` at full width (the pre-prune
    validation at mip 2, the schedule past the prune, the final validation
    at mip 0 with the ``_pred`` baselines, the point-cloud map), launch
    counts read after each part. Then the checks: no validation launch
    wrote idx/bary; no packed chunk truncated (each final image packed vs
    dense under float32 decoders within 1e-4 is that gate); the final
    validation through the kernels vs through the plain encodes (channels
    1e-2, PSNR 0.05 dB, flipped argmax pixels counted); and rows 8-9 at the
    N the validations ran, on random tables, against their plain versions;
    their times, and for the dual encode also the two-load layout's
    (``_launch_encode(..., packed=False)``, no ``torch.cat`` of the tables)."""
    import numpy as np
    import torch
    from unittest import mock

    from pagnerf_tpu_torch.entry import validate_flagship
    from pagnerf_tpu_torch.ops import permuto_encoding as pe
    from pagnerf_tpu_torch.train.trainer import PanopticTrainer
    from pagnerf_tpu_torch.train.validation import _rays_from, validate

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches, idx_bary, chunks, coords, renders = {}, {}, {}, {}, {}
    now = {"chunks": [], "coords": {}, "renders": []}
    batch_render = PanopticTrainer.batch_render
    encode_t = pe.PermutoEncodingSpec.encode_T
    encode_dual_t = pe.PermutoEncodingSpec.encode_dual_T

    def render_spy(self, *args, **kwargs):
        rb = batch_render(self, *args, **kwargs)
        now["chunks"] += self.last_render
        now["renders"].append(rb)
        return rb

    def keep(name, coordsT):
        # the largest N the part ran each encode at
        if coordsT.shape[1] > now["coords"].get(name, torch.empty(3, 0)).shape[1]:
            now["coords"][name] = coordsT.detach().float().contiguous().clone()

    def encode_spy(self, tables, coordsT, *args, **kwargs):
        keep("encode", coordsT)
        return encode_t(self, tables, coordsT, *args, **kwargs)

    def encode_dual_spy(self, tables_a, tables_b, coordsT, *args, **kwargs):
        keep("dual_encode", coordsT)
        return encode_dual_t(self, tables_a, tables_b, coordsT, *args, **kwargs)

    def after(part, trainer):
        torch.cuda.synchronize()
        launches[part], idx_bary[part] = _launches(), _idx_bary_launches()
        chunks[part], coords[part] = now["chunks"], now["coords"]
        renders[part] = now["renders"] if part == "final" else None
        now.update(chunks=[], coords={}, renders=[])
        _reset_launches()

    log_dir = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", "validate")
    _reset_launches()
    with mock.patch.object(PanopticTrainer, "batch_render", render_spy), \
         mock.patch.object(pe.PermutoEncodingSpec, "encode_T", encode_spy), \
         mock.patch.object(pe.PermutoEncodingSpec, "encode_dual_T", encode_dual_spy):
        trainer, res = validate_flagship(device=dev, log_dir=log_dir, after=after)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg, pipe = trainer.cfg, trainer.pipeline
    pre, final, pts = res["pre_prune"], res["final"], res["map"]["points"]
    sched = res["schedule"]["log"]
    fields = dict(
        pre_prune_epoch=pre["epoch"], pre_prune_metrics=pre["metrics"],
        pre_prune_validate_s=pre["seconds"], final_metrics=final["metrics"],
        final_validate_s=final["seconds"],
        render_time_per_img_s={"pre_prune": pre["metrics"]["val/render_time_per_img"],
                               "final": final["metrics"]["val/render_time_per_img"]},
        schedule_s=res["schedule"]["seconds"], map_s=res["map"]["seconds"],
        map_points=len(pts["points"]), launches=launches, idx_bary_launches=idx_bary,
        chunks={p: [dict(c) for c in cs] for p, cs in chunks.items() if p != "schedule"},
        peak_allocated_gib=peak_gb)

    def fail(msg):
        emit("validate", ok=False, **fields)
        raise AssertionError(msg)

    # launches: one encode per rendered chunk, single before the panoptic
    # heads render, dual after; never with idx/bary; the schedule as its log says
    steps_expected, prune_expected = schedule_launches(trainer, sched[1:])
    expected = {"pre_prune": {k: (len(chunks["pre_prune"]) if k == "encode" else 0)
                              for k in launches["pre_prune"]},
                "schedule": {k: steps_expected[k] + prune_expected[k]
                             for k in steps_expected}}
    for part in ("final", "map"):
        expected[part] = {k: (len(chunks[part]) if k == "dual_encode" else 0)
                          for k in launches[part]}
    fields["expected_launches"] = expected
    if launches != expected:
        fail(f"validate_flagship launched {launches}, expected {expected}")
    if any(v for part in ("pre_prune", "final", "map") for v in idx_bary[part].values()):
        fail(f"a validation encode wrote idx/bary: {idx_bary}")
    if not (chunks["final"] and all(c["pack_steps"] for c in chunks["final"])
            and all(c["pack_steps"] == 0 for c in chunks["pre_prune"])):
        fail("the final validation did not pack, or the pre-prune one did")
    if not (all(np.isfinite(v) for v in final["metrics"].values())
            and {"val/iou_gain", "val/pq_things_gain", "val/map_pred"} <= set(final["metrics"])
            and np.isfinite(pts["points"]).all() and pts["points"].shape[1:] == (3,)):
        fail("final metrics not finite or incomplete, or the map malformed")

    # the truncation gate: every final image packed vs dense under float32
    # decoders, equal within 1e-4 only when no chunk truncated
    data = trainer.dataset.get_images("val", mip=0)
    stage = trainer.stage_for_epoch(cfg.epochs - 1)
    dense = dataclasses.replace(stage, pack_steps=0)
    chans = ("rgb", "depth", "semantics", "inst_embedding")
    err = {ch: 0.0 for ch in chans}
    depth_max = 0.0
    with _Float32Decoders(pipe):
        for i, cam in enumerate(data["cam_idx"]):
            rays = _rays_from(data, i, True, dev)
            rb_p = trainer.batch_render(rays, set(chans), cam_idx=int(cam), stage_cfg=stage)
            rb_d = trainer.batch_render(rays, set(chans), cam_idx=int(cam), stage_cfg=dense)
            depth_max = max(depth_max, rb_d.depth.abs().max().item())
            for ch in chans:
                err[ch] = max(err[ch], (getattr(rb_p, ch) - getattr(rb_d, ch)).abs().max().item())
    tol = {ch: 1e-4 * (max(1.0, depth_max) if ch == "depth" else 1.0) for ch in chans}
    fields.update(packed_vs_dense_err_float32_decoders=err, packed_vs_dense_tol=tol)
    if not all(err[ch] <= tol[ch] for ch in chans):
        fail("final validation: packed render vs dense render outside 1e-4")

    # the final validation through the plain encodes
    plain_renders = []

    def plain_spy(self, *args, **kwargs):
        rb = batch_render(self, *args, **kwargs)
        plain_renders.append(rb)
        return rb

    with mock.patch.object(pe, "fused_encode", pe.encode_plain), \
         mock.patch.object(pe, "fused_encode_dual", pe.dual_encode_plain), \
         mock.patch.object(PanopticTrainer, "batch_render", plain_spy):
        plain_metrics = validate(trainer, cfg.epochs)
    stuff = trainer.dataset.semantic_info["stuff_ids"]
    errs, flips = {ch: 0.0 for ch in chans}, [0, 0]
    d_max = max(rb.depth.abs().max().item() for rb in plain_renders)
    for rb_k, rb_p in zip(renders["final"], plain_renders):
        for ch in chans:
            errs[ch] = max(errs[ch], (getattr(rb_k, ch).float()
                                      - getattr(rb_p, ch).float()).abs().max().item())
        flips = [a + b for a, b in zip(flips, _flips(rb_k, rb_p, stuff))]
    tols = {ch: 1e-2 * (d_max if ch == "depth" else 1.0) for ch in chans}
    psnr_diff = abs(final["metrics"]["val/psnr"] - plain_metrics["val/psnr"])
    fields.update(vs_plain_max_abs_err=errs, vs_plain_tol=tols, vs_plain_psnr_diff_db=psnr_diff,
                  vs_plain_flipped_pixels={"semantics": flips[0], "instance": flips[1],
                                           "of": sum(c["rays"] for c in chunks["final"])},
                  plain_metrics=plain_metrics)
    if not (all(errs[ch] <= tols[ch] for ch in chans) and psnr_diff <= 0.05):
        fail("final validation through the kernels vs the plain encodes")

    # rows 8-9 at the N the validations ran, random tables, through the
    # wrappers; the kernel's lattice against the plain one (boundary rule)
    spec = pipe.nef.grid.spec
    l, c, f = spec.num_levels, spec.capacity, spec.feature_dim
    st = pe.level_statics(spec.scales, c, f)
    gen = torch.Generator(device=dev).manual_seed(5)
    ta = torch.randn((l, c, f), generator=gen, device=dev)
    tb = torch.randn((l, c, f), generator=gen, device=dev)
    checks, times = {}, {}
    for part, name in (("pre_prune", "encode"), ("final", "dual_encode"),
                       ("map", "dual_encode")):
        x = coords[part][name]
        n = x.shape[1]
        tables = (ta,) if name == "encode" else (ta, tb)
        with torch.no_grad():
            outs = ((pe.fused_encode(ta, x, spec.scales),) if name == "encode"
                    else pe.fused_encode_dual(ta, tb, x, spec.scales))
            _, idx_k, bary_k, _ = pe._launch_encode(x, (ta,), st, True, False)
        checks[part] = encode_vs_plain(spec, x, tables, outs, idx_k, bary_k)
        del outs, idx_k, bary_k
        kern = ((lambda: pe.fused_encode(ta, x, spec.scales)) if name == "encode"
                else (lambda: pe.fused_encode_dual(ta, tb, x, spec.scales)))
        plain = ((lambda: pe.encode_plain(ta, x, spec.scales)) if name == "encode"
                 else (lambda: pe.dual_encode_plain(ta, tb, x, spec.scales)))
        bound_ms, bound_by, nbytes, flops = encode_bound(l, c, f, n, len(tables), 4, False,
                                                         st.rows_used)
        with torch.no_grad():
            times[part] = dict(kernel=name, N=n, max_abs_err=checks[part]["max_abs_err"],
                               ms=cuda_ms(kern, flush=flush),
                               plain_ms=cuda_ms(plain, reps=5, flush=flush),
                               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                               flops=flops)
            if name == "dual_encode":
                times[part]["two_loads_ms"] = cuda_ms(
                    lambda: pe._launch_encode(x, tables, st, False, False), flush=flush)
    fields.update(kernel_checks=checks, kernel_times=times)
    if not all(ch["ok"] for ch in checks.values()):
        fail(f"an encode at the validation's N outside its tolerance: {checks}")
    emit("validate", **fields)
    all_launches = {k: sum(launches[p][k] for p in launches) for k in launches["final"]}
    val_launches = {k: sum(launches[p][k] for p in ("pre_prune", "final", "map"))
                    for k in ("encode", "dual_encode")}
    del trainer, res, renders, plain_renders, coords, ta, tb
    torch.cuda.empty_cache()
    return all_launches, times, val_launches


CLI_CONFIG = "configs/synthetic/schedule_preds_flagship_tuned_60ep.yaml"
# the tuned config's milestones moved into 4 epochs: epoch 0 dense RGB on the
# ray march with the LoD window opening over it; the learning rate's first
# step after epoch 0's 12 steps; epoch 1 the seed prune (packed layout) and,
# at its end, the real prune; epoch 2 the voxel march and the panoptic heads
# (sem_conf / inst_conf from the config); epoch 3 a val-pose epoch; a
# checkpoint after epochs 1 and 3, a validation after epoch 3, then the
# final checkpoint and the final validation
CLI_FLAGS = ["--epochs", "4", "--lod-annel-epochs", "1", "--lr-step-size", "1",
             "--seed-prune-epoch", "1", "--prune-every", "-1", "--prune-at-epoch", "1",
             "--voxel-raymarch-epoch-start", "1", "--sem-epoch-start", "2",
             "--inst-epoch-start", "2", "--val-extrinsics-start", "3",
             "--val-extrinsics-every", "3", "--valid-every", "4", "--save-every", "2"]


def cli_launches(steps, anchor, renders, prunes, prune_chunks):
    """The launches a ``cli.main`` run implies: per training microbatch (one
    image; ``steps`` are the timer's ``train_step`` records) one encode and
    one table-gradient scatter, dual when the stage renders a panoptic
    channel, and dbary when its camera is not an anchor frame; per prune the
    single encode once per chunk of 65,536 cell points per jittered sample
    (``prune_chunks``); per rendered validation chunk one encode, dual when
    the validation renders a panoptic channel."""
    keys = _launches()
    expected = {k: 0 for k in keys}
    for s_ in steps:
        dual = bool(set(s_["channels"]) & {"semantics", "inst_embedding"})
        for cam in s_["cam_idx"]:
            expected["dual_encode" if dual else "encode"] += 1
            expected["dual_table_grad" if dual else "table_grad"] += 1
            expected["dbary"] += int(not anchor[cam])
    expected["encode"] += prunes * prune_chunks
    for channels, chunks in renders:
        dual = bool(set(channels) & {"semantics", "inst_embedding"})
        expected["dual_encode" if dual else "encode"] += chunks
    return expected


def recorded_kernel_checks(spec, calls, dev, flush):
    """Each kernel of the training path at each N it ran at in a ``cli.main``
    run (``calls``: the first call per kernel and N, recorded as the path
    made it), through its wrapper on the card against its plain version:
    the encodes on the recorded coordinates with random tables (outputs and
    the kept idx/bary by ``encode_vs_plain``); the scatters (64 eps_f32 of
    each entry's sum of |bary * g|) and dbary (4 eps_f32 of sum_f |g * T|)
    on the recorded idx, bary, cotangents and tables. Where the path ran
    the single scatter at an N and not the dual one, the dual runs there too
    on the single's events, the second cotangent random. Returns (checks,
    times), keyed by kernel and then N."""
    import torch

    from pagnerf_tpu_torch.ops import permuto_encoding as pe
    from pagnerf_tpu_torch.ops import table_gather as tg

    l, c, f = spec.num_levels, spec.capacity, spec.feature_dim
    st = pe.level_statics(spec.scales, c, f)
    gen = torch.Generator(device=dev).manual_seed(11)
    ta = torch.randn((l, c, f), generator=gen, device=dev)
    tb = torch.randn((l, c, f), generator=gen, device=dev)
    a, b = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    for (kind, n), rec in list(calls.items()):
        if kind == "table_grad" and ("dual_table_grad", n) not in calls:
            calls[("dual_table_grad", n)] = dict(
                rec, g_b=torch.randn(rec["g"].shape, generator=gen, device=dev),
                g_b_random=True)
    checks, times = {}, {}

    def scatter_worst(got, idx, bary, gs, rows_used):
        worst = 0.0
        for d_, g_ in zip(got, gs):
            diff = (d_ - tg.table_grad_plain(idx, bary, g_, c, rows_used)).abs()
            tol_ = 64 * F32_EPS * tg.table_grad_plain(idx, bary.abs(), g_.abs(), c,
                                                      rows_used)
            worst = max(worst, (diff / tol_.clamp(min=1e-30)).max().item())
        return worst

    for (kind, n), rec in sorted(calls.items()):
        key = str(n)
        if kind in ("encode", "dual_encode"):
            x = rec["x"]
            if kind == "encode":
                out = pe.fused_encode(a, x, spec.scales)
                _, idx, bary, _ = out.grad_fn.saved_tensors
                ch = encode_vs_plain(spec, x, (ta,), (out.detach(),), idx, bary)
                kern = lambda: pe.fused_encode(a, x, spec.scales)
                plain = lambda: pe.encode_plain(ta, x, spec.scales)
            else:
                oa, ob = pe.fused_encode_dual(a, b, x, spec.scales)
                _, idx, bary, _ = oa.grad_fn.saved_tensors
                ch = encode_vs_plain(spec, x, (ta, tb), (oa.detach(), ob.detach()), idx,
                                     bary)
                kern = lambda: pe.fused_encode_dual(a, b, x, spec.scales)
                plain = lambda: pe.dual_encode_plain(ta, tb, x, spec.scales)
            out = oa = ob = idx = bary = None
            bound_ms, bound_by, _, _ = encode_bound(l, c, f, n, 1 if kind == "encode" else 2,
                                                    4, True, st.rows_used)
            tm = dict(with_idx_bary=True, max_abs_err=ch["max_abs_err"])
        elif kind == "dbary":
            args = (rec["tables"], rec["idx"], rec["g"])
            got = tg.multilevel_gather_dbary(*args)
            diff = (got - tg.gather_dbary_plain(*args)).abs()
            mag = tg.gather_dbary_plain(rec["tables"].abs(), rec["idx"], rec["g"].abs())
            worst = (diff / (4 * F32_EPS * mag).clamp(min=1e-30)).max().item()
            ch = dict(N=n, max_abs_err=diff.max().item(), worst_err_over_tol=worst,
                      tol="4 eps_f32 * sum_f |g*T| per entry", ok=worst <= 1.0)
            del got, diff, mag
            kern = lambda: tg.multilevel_gather_dbary(*args)
            plain = lambda: tg.gather_dbary_plain(*args)
            bound_ms, bound_by, _, _ = dbary_bound(l, c, f, n, st.rows_used)
            tm = dict(max_abs_err=ch["max_abs_err"])
        else:
            plan = dict(rows_used=rec["rows_used"], modes=rec["modes"])
            idx, bary, c_ = rec["idx"], rec["bary"], rec["c"]
            if kind == "table_grad":
                gs = (rec["g"],)
                kern = lambda: tg.multilevel_table_grad(idx, bary, gs[0], c_, **plan)
                plain = lambda: tg.table_grad_plain(idx, bary, gs[0], c_)
                got = (kern(),)
            else:
                gs = (rec["g"], rec["g_b"])
                kern = lambda: tg.dual_multilevel_table_grad(idx, bary, *gs, c_, **plan)
                plain = lambda: tg.dual_table_grad_plain(idx, bary, *gs, c_)
                got = kern()
            worst = scatter_worst(got, idx, bary, gs, rec["rows_used"])
            del got
            ch = dict(N=n, worst_err_over_tol=worst,
                      tol="64 eps_f32 * sum|bary*g| per entry", ok=worst <= 1.0,
                      **({"g_b": "random"} if rec.get("g_b_random") else {}))
            bound_ms, bound_by, _, _ = scatter_bound(l, c, f, n, len(gs))
            tm = dict(worst_err_over_tol=worst)
        checks.setdefault(kind, {})[key] = ch
        times.setdefault(kind, {})[key] = dict(
            N=n, **tm, ms=cuda_ms(kern, flush=flush), plain_ms=cuda_ms(plain, reps=5, flush=flush),
            bound_ms=bound_ms, bound_by=bound_by)
    del a, b, ta, tb
    return checks, times


class _Spied:
    """A module as one caller sees it, some of its functions replaced: the
    module's own functions still find the originals (and their launch
    counts) by their global names."""

    def __init__(self, module, **replaced):
        self._module = module
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._module, name)


def phase_cli(dev, flush):
    """Main path 6: ``cli.main`` on the tuned 60-epoch config at full width
    for 4 epochs (``CLI_FLAGS``, with ``--perf``: the trainer's timer writes
    each step, prune, epoch and validation to the run's ``perf.jsonl``),
    launch counts set to 0 before and read after; then ``--valid-only
    --pretrained`` the final checkpoint, which must reproduce the final
    validation's metrics exactly. Each epoch's wall and losses, the prunes'
    walls and kept shares, the packed B and the truncated share. While the
    run goes, the first call of each kernel at each N of the training path
    (the dense N = 4096 x 96 = 393,216, the seed prune's B, the voxel
    stage's B) is recorded; after it, each is held against its plain
    version there (``recorded_kernel_checks``), with times and bounds."""
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from pagnerf_tpu_torch import cli
    from pagnerf_tpu_torch.ops import permuto_encoding as pe
    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.quality_run import packing, read_perf, summary
    from pagnerf_tpu_torch.train.trainer import PanopticTrainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log_root = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", "cli")
    shutil.rmtree(log_root, ignore_errors=True)
    argv = ["--config", os.path.join(ROOT, CLI_CONFIG), "--device", "cuda",
            "--log-dir", log_root, "--perf"] + CLI_FLAGS
    trainers, renders, calls, pack_totals = [], [], {}, {}
    get_modules = cli.get_modules_from_config
    batch_render = PanopticTrainer.batch_render
    encode_t, encode_dual_t = pe.PermutoEncodingSpec.encode_T, pe.PermutoEncodingSpec.encode_dual_T
    table_grad, dual_table_grad = tg.multilevel_table_grad, tg.dual_multilevel_table_grad
    dbary = tg.multilevel_gather_dbary

    def keep(kind, n, make):
        # the first call of a kernel at an N, as the path made it
        if (kind, n) not in calls:
            calls[(kind, n)] = make()

    def modules_spy(*args, **kwargs):
        out = get_modules(*args, **kwargs)
        trainers.append(out[2])
        return out

    def render_spy(self, rays, channels, *args, **kwargs):
        rb = batch_render(self, rays, channels, *args, **kwargs)
        renders.append((tuple(sorted(channels)), len(self.last_render)))
        return rb

    def encode_spy(self, tables, coordsT, *args, **kwargs):
        if torch.is_grad_enabled():
            keep("encode", coordsT.shape[1],
                 lambda: {"x": coordsT.detach().float().contiguous().clone()})
        return encode_t(self, tables, coordsT, *args, **kwargs)

    def encode_dual_spy(self, tables_a, tables_b, coordsT, *args, **kwargs):
        if torch.is_grad_enabled():
            keep("dual_encode", coordsT.shape[1],
                 lambda: {"x": coordsT.detach().float().contiguous().clone()})
        return encode_dual_t(self, tables_a, tables_b, coordsT, *args, **kwargs)

    def table_grad_spy(idx, bary, g, capacity, rows_used=None, modes=None):
        keep("table_grad", idx.shape[2], lambda: dict(
            idx=idx.clone(), bary=bary.clone(), g=g.clone(), c=capacity,
            rows_used=rows_used, modes=modes))
        return table_grad(idx, bary, g, capacity, rows_used, modes)

    def dual_table_grad_spy(idx, bary, g_a, g_b, capacity, rows_used=None, modes=None):
        keep("dual_table_grad", idx.shape[2], lambda: dict(
            idx=idx.clone(), bary=bary.clone(), g=g_a.clone(), g_b=g_b.clone(), c=capacity,
            rows_used=rows_used, modes=modes))
        return dual_table_grad(idx, bary, g_a, g_b, capacity, rows_used, modes)

    def dbary_spy(tables, idx, g):
        keep("dbary", idx.shape[2], lambda: dict(tables=tables.clone(), idx=idx.clone(),
                                                 g=g.clone()))
        return dbary(tables, idx, g)

    _reset_launches()
    t0 = time.perf_counter()
    with packing(pack_totals), \
         mock.patch.object(cli, "get_modules_from_config", modules_spy), \
         mock.patch.object(PanopticTrainer, "batch_render", render_spy), \
         mock.patch.object(pe.PermutoEncodingSpec, "encode_T", encode_spy), \
         mock.patch.object(pe.PermutoEncodingSpec, "encode_dual_T", encode_dual_spy), \
         mock.patch.object(pe, "table_gather", _Spied(
             tg, multilevel_table_grad=table_grad_spy,
             dual_multilevel_table_grad=dual_table_grad_spy,
             multilevel_gather_dbary=dbary_spy)):
        final = cli.main(argv + ["--exp-name", "train"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer = trainers[0]
    run_dir, records = read_perf(log_root, "train")
    anchor = trainer.pipeline.anchor_mask.cpu().numpy()
    summ = summary(records, pack_totals)
    steps = [r for r in records if r["name"] == "train_step"]
    prunes = [r for r in records if r["name"] == "prune"]
    expected = cli_launches(steps, anchor, renders, len(prunes),
                            max(1, trainer.cfg.prune_samples_per_cell)
                            * math.ceil(trainer.occ.res ** 3 / 65536))
    epochs = [{"epoch": r["epoch"], "s": r["ms"] / 1e3, "losses": r["losses"],
               "stages": sorted({s_["stage"] for s_ in steps if s_["epoch"] == r["epoch"]})}
              for r in records if r["name"] == "epoch"]
    fields = dict(config=CLI_CONFIG, flags=" ".join(CLI_FLAGS), wall_s=wall, epochs=epochs,
                  prunes=summ["prunes"], stages=summ["stages"], packing=summ["packing"],
                  validations=summ["validations"], launches=launches,
                  expected_launches=expected, peak_allocated_gib=peak_gb,
                  lr_after={g: trainer.opt.lr(g) for g in ("grid", "decoder")},
                  opt_count=trainer.opt.count["grid"], final_metrics=final,
                  recorded_calls=sorted(f"{k}@{n}" for k, n in calls))

    def fail(msg):
        emit("cli", ok=False, **fields)
        raise AssertionError(msg)

    stages = [e["stages"] for e in epochs]
    if stages != [["ray_dense_rgb"], ["ray_packed_rgb"], ["voxel_packed_panoptic"],
                  ["val_pose"]]:
        fail(f"the 4 epochs ran the stages {stages}")
    if [(p["epoch"], p["seed"]) for p in prunes] != [(1, True), (1, False)]:
        fail(f"prunes {prunes}: expected the seed prune and the real prune in epoch 1")
    if launches != expected:
        fail(f"cli.main launched {launches}, expected {expected}")
    if not (launches["encode"] and launches["dual_encode"] and launches["table_grad"]
            and launches["dual_table_grad"] and launches["dbary"]):
        fail("a kernel of the path was not launched")
    if not all(np.isfinite(v) for e in epochs for v in e["losses"].values()):
        fail("a loss is not finite")
    if not (all(np.isfinite(v) for v in final.values())
            and {"val/iou_gain", "val/pq_things_gain", "val/map_pred"} <= set(final)):
        fail("final metrics not finite or incomplete")
    fields["checkpoint_bytes"] = os.path.getsize(os.path.join(run_dir, "model.ckpt"))

    # --valid-only --pretrained the final checkpoint: the same metrics
    _reset_launches()
    again = cli.main(argv + ["--exp-name", "valid_only", "--valid-only", "--pretrained",
                             os.path.join(run_dir, "model.ckpt")])
    torch.cuda.synchronize()
    fields["valid_only_launches"] = _launches()
    differ = {k: (final[k], again.get(k)) for k in final
              if k != "val/render_time_per_img" and final[k] != again.get(k)}
    fields.update(valid_only_metrics=again, valid_only_differs=differ)
    if differ or sorted(again) != sorted(final):
        fail(f"--valid-only --pretrained did not reproduce the final metrics: {differ}")

    # every kernel of the training path at each N it ran at, against plain
    spec = trainer.pipeline.nef.grid.spec
    dense_n = trainer.cfg.num_rays_sampled_per_img * trainer.pipeline.tracer_cfg.num_steps
    packed_b = sorted({b for st_ in summ["stages"].values() for b in st_["B"]})
    want = {"encode": {dense_n, *packed_b}, "dual_encode": set(summ["stages"][
        "voxel_packed_panoptic"]["B"]), "table_grad": {dense_n, *packed_b},
        "dbary": {dense_n, *packed_b}}
    fields.update(dense_N=dense_n, packed_B=packed_b)
    for kind, ns in want.items():
        missing = ns - {n for k, n in calls if k == kind}
        if missing:
            fail(f"no {kind} call was recorded at N = {sorted(missing)}")
    del trainer, trainers
    checks, times = recorded_kernel_checks(spec, calls, dev, flush)
    calls.clear()
    fields.update(kernel_checks=checks, kernel_times=times)
    if not all(ch["ok"] for by_n in checks.values() for ch in by_n.values()):
        fail(f"a kernel at one of this path's N outside its tolerance: {checks}")
    emit("cli", **fields)
    torch.cuda.empty_cache()
    return launches, times


def main() -> None:
    # import the port first: without it (or without a card) nothing is printed
    import torch

    from pagnerf_tpu_torch.entry import entry
    from pagnerf_tpu_torch.profile_scatter import training_coords

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
    x_render = render_coords(pipe, origins, dirs, cam_idx)
    spec, x_train = training_coords(dev)
    enc = phase_encode(dev, spec, {"render": x_render, "train": x_train}, flush)
    torch.cuda.empty_cache()
    fwd = phase_kernels_fwd(dev, pipe, x_render, flush)
    torch.cuda.empty_cache()
    bwd, level0_rows = phase_kernels_bwd(dev, spec, x_train, flush)
    del x_render, x_train
    bwd["scatter_rows"] = phase_scatter_rows(dev, level0_rows, flush)
    del flush_buf, flush, level0_rows
    torch.cuda.empty_cache()
    phase_tiny(dev)
    paths = {"render": phase_render(fn, pipe, origins, dirs, cam_idx)}
    del fn, pipe
    torch.cuda.empty_cache()
    for stage_name in ("rgb", "panoptic"):
        paths[f"train_{stage_name}"] = phase_train(dev, stage_name)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    paths["train_post_prune"], post = phase_train_post_prune(dev, flush_buf.zero_)
    paths["validate"], val_times, val_launches = phase_validate(dev, flush_buf.zero_)
    paths["cli"], cli_times = phase_cli(dev, flush_buf.zero_)
    del flush_buf

    # ---------------------------------------------------------------- report
    sources = {"fwd": "pagnerf_tpu_torch/ops/csrc/permuto_gather.cu",
               "bwd": "pagnerf_tpu_torch/ops/csrc/permuto_scatter.cu",
               "encode": "pagnerf_tpu_torch/ops/csrc/permuto_encode.cu"}
    rows = []
    for name, key, replaces in (("single", "encode", "pagnerf_tpu/ops/pallas_gather.py:101"),
                                ("dual", "dual_encode", "pagnerf_tpu/ops/pallas_gather.py:119")):
        pick = lambda r, keys: {k: r[k] for k in keys}
        times = ("ms", "plain_ms", "bound_ms", "bound_by")
        r32, t32 = enc[("render", torch.float32)], enc[("train", torch.float32)]
        r16, t16 = enc[("render", torch.bfloat16)], enc[("train", torch.bfloat16)]
        row = {
            "name": f"permuto_encode_{name}", "route": "cuda", "source": sources["encode"],
            "replaces": replaces,
            "also_replaces": "pagnerf_tpu/ops/permuto_encoding.py:149 _lattice_levels",
            "launches": sum(p[key] for p in paths.values()),
            "launches_by_path": {p: c[key] for p, c in paths.items()},
            "dtype": "float32", "shapes": "render N=1,572,864, no idx/bary",
            "max_abs_err": max(r32["max_abs_err"], t32["max_abs_err"]), "tol": r32["tol"],
            **pick(r32[name], times), "library_ms": None,
            "train_with_idx_bary": pick(t32[name], times),
            "bf16": {"render": pick(r16[name], times), "train": pick(t16[name], times),
                     "max_abs_err": max(r16["max_abs_err"], t16["max_abs_err"])},
        }
        if name == "dual":
            row["two_loads"] = {"render": pick(r32["dual_two_loads"], ("ms", "bound_ms")),
                                "train": pick(t32["dual_two_loads"], ("ms", "bound_ms"))}
        row["post_prune"] = post["encode_prune" if name == "single" else "dual_encode_B"]
        row["validation"] = {"launches": val_launches[key],
                             **({"pre_prune": val_times["pre_prune"]} if name == "single"
                                else {"final": val_times["final"], "map": val_times["map"]})}
        row["cli"] = cli_times[key]
        rows.append(row)
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
        row = {
            "name": name, "route": "cuda", "source": sources["bwd"],
            "replaces": replaces, "launches": sum(p[key] for p in paths.values()),
            "launches_by_path": {p: c[key] for p, c in paths.items()},
            "dtype": "float32", "shapes": shapes,
            **{k: r[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
        }
        if name in ("table_grad_dual", "gather_dbary"):
            row["post_prune"] = post["dual_table_grad_B" if name == "table_grad_dual"
                                     else "dbary_B"]
        if key in cli_times:
            row["cli"] = cli_times[key]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
