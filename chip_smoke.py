#!/usr/bin/env python3
"""Drive the PyTorch port (``pagnerf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing one JSON line as it ends:

1. device  -- refuse to run without CUDA; name the card and its power limit.
2. build   -- compile ``ops/csrc/permuto_gather.cu`` with nvcc (ctypes route).
3. kernels -- at the flagship shapes (L=24 levels, C=2^18 entries, F=2, V=4,
   N = 3072 rays (camera 0's 64x48 image) x 512 steps = 1,572,864 samples),
   with idx/bary from the port's own lattice at the flagship render's sample
   coordinates, hold the single- and dual-table gather kernels against their
   plain PyTorch versions in float32 (the flagship's gather dtype) and
   bfloat16, and time kernel, plain version and
   ``torch.nn.functional.embedding_bag`` (the library yardstick).
4. tiny    -- the tiny configuration rendered on the card against the same
   render on the CPU (whose plain path the CPU tests hold against the JAX
   package), float32 decoders.
5. render  -- the main path: launch counts set to 0, the flagship render
   ``entry()`` (rgb, depth, semantics, inst_embedding; dual kernel) and the
   same render with rgb and depth only (single kernel), counts read. Outputs
   must be finite, of the right shapes, and match the render routed through
   the plain gathers on the card.

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
# float32 rate outside the tensor cores. The gather's arithmetic is float32.
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


def gather_bound(l, c, f, n, num_tables, itemsize):
    """Least time for the gather at these shapes: bytes (idx read once, bary
    and each table read once, each output written once) over the memory rate,
    against flops (V products and sums per output) over the float32 rate."""
    v = 4
    nbytes = l * v * n * 4 + l * v * n * itemsize \
        + num_tables * (l * c * f * itemsize + l * f * n * itemsize)
    flops = num_tables * l * f * n * v * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def main() -> None:
    # import the port first: without it (or without a card) nothing is printed
    import torch
    import torch.nn.functional as F
    from unittest import mock

    from pagnerf_tpu_torch.core.rays import Rays
    from pagnerf_tpu_torch.entry import entry
    from pagnerf_tpu_torch.ops import _build, permuto_encoding, table_gather
    from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid
    from pagnerf_tpu_torch.ops.raymarch import raymarch

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

    # ----------------------------------------------------------------- build
    t = time.perf_counter()
    lib = _build.build("permuto_gather")
    table_gather._kernel()
    emit("build", seconds=time.perf_counter() - t,
         library=os.path.relpath(lib, ROOT), flags=" ".join(_build.NVCC_FLAGS))

    # --------------------------------------------------------------- kernels
    fn, (pipe, origins, dirs, cam_idx) = entry(device=dev)
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
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
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
    del idx, bary32, bag_idx, flush_buf, flush
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ tiny
    outs = []
    for d in (dev, torch.device("cpu")):
        tfn, targs = entry(device=d, tiny=True, compute_dtype=torch.float32)
        outs.append([o.cpu() for o in tfn(*targs)])
    tiny_err = max((a - b).abs().max().item() for a, b in zip(*outs))
    if not tiny_err <= 1e-4:
        raise AssertionError(f"tiny render, card vs CPU: max abs err {tiny_err} > 1e-4")
    emit("tiny", max_abs_err=tiny_err, tol=1e-4,
         shapes=[list(o.shape) for o in outs[0]])

    # ---------------------------------------------------------------- render
    kernels = {"single": table_gather.multilevel_table_gather,
               "dual": table_gather.dual_multilevel_table_gather}
    rd = frozenset({"rgb", "depth"})
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    out = fn(pipe, origins, dirs, cam_idx)
    out_rd = fn(pipe, origins, dirs, cam_idx, channels=rd)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the main path launched the {name} kernel {count} times")

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
                           table_gather.multilevel_gather_plain), \
         mock.patch.object(table_gather, "dual_multilevel_table_gather",
                           table_gather.dual_gather_plain):
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

    # ---------------------------------------------------------------- report
    source = "pagnerf_tpu_torch/ops/csrc/permuto_gather.cu"
    replaces = {"single": "pagnerf_tpu/ops/pallas_gather.py:101",
                "dual": "pagnerf_tpu/ops/pallas_gather.py:119"}
    rows = []
    for name in ("single", "dual"):
        r32 = results[(name, torch.float32)]
        r16 = results[(name, torch.bfloat16)]
        rows.append({
            "name": f"permuto_gather_{name}", "route": "cuda", "source": source,
            "replaces": replaces[name], "launches": launches[name],
            "dtype": "float32",
            **{k: r32[k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            "bf16": {k: r16[k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                         "bound_ms", "library_ms")},
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
