"""The V = 8 table-gradient scatter of the hash grid, on the card.

    python -m pagnerf_tpu_torch.profile_hash_scatter [--parent OLD.cu] [--out FILE]

One training microbatch of ``configs/bup20/panoptic_nerf.yaml`` (14 levels of
2^19 rows, F = 2, 2048 rays x 512 steps = 1,048,576 samples, ray-major) over
a 320x180 BUP20-format tree of the synthetic scene: the idx, bary and
cotangents its RGB step hands the scatter (random init weights). Parts,
one JSON object each:

- ``stats``: per level the events and non-zero events, the rows over 120
  addends, the distinct rows per 256-, 1024- and 2048-sample block and the
  share of non-zero events a merge across samples and corner slots within
  a 1024-sample block removes, the distinct row pairs (2k, 2k+1) per block,
  the blocks a row is flushed from (largest, rows over 120), the atomics
  the previous per-level plan issues (warp runs of equal rows at one corner
  slot), and the flushes of the window merge (``window_stats``) with
  segments of 4 and 8 samples;
- ``build``: registers and spills of every kernel (``-Xptxas -v``) and the
  SASS opcode counts of the event kernels;
- ``ceilings``: the SM clock, and atomics to random 16-byte rows per SM per
  clock: float32, float2, float4, float64, two float64 and int32 CAS, in
  device memory (4 and 8 MB, which the L2 holds, and 64 MB) and in a 16 KB
  shared-memory table;
- ``check``: the scatter, single and dual, against the plain version on the
  path's cotangents, same-signed ones and a random second one (largest
  error over 64 eps_f32 * sum|bary * g| per entry);
- ``kernels``: device ms of each kernel of one call (``torch.profiler``);
- ``time``: median device ms (CUDA events, L2 evicted, 10 launches) of the
  single and dual scatter under the path's plan, each other version timed
  in turns with it (other, path, path, other): this build under the
  candidate plans (``candidate_plans``); with ``--parent``, another
  ``permuto_scatter.cu`` with the same C interface, built with the same
  flags and called with the previous per-level plan
  (``previous_hash_modes``); with ``--variant NAME=FLAGS``, this source
  built with other nvcc flags (``-DPAGNERF_SCATTER_SEG=16``,
  ``-DPAGNERF_SCATTER_ABLATE=1|2``); their errors in ``check``;
- ``levels`` and ``level_modes``: each level alone under the path's mode
  and under every mode, device ms per kernel;
- ``microbatch``: host ms of a whole RGB and panoptic microbatch
  (``grad_step``) under the path's plan and the previous one, in turns.
"""
from __future__ import annotations

import argparse
import contextlib
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
from .profile_encode import _nvcc
from .profile_scatter import cuda_ms, kernel_breakdown, scatter_worst

CONFIG = "configs/bup20/panoptic_nerf.yaml"
# the slice's flags of the training run (two epochs, the panoptic heads from
# epoch 1); the microbatch is an RGB step of epoch 0
FLAGS = ["--epochs", "2", "--sem-epoch-start", "1", "--valid-every", "2",
         "--inst-epoch-start", "1"]
TREE_SIZE = (320, 180)
MAX_ADDENDS = 120


def hash_trainer(dev, seed: int = 0, size=TREE_SIZE, flags=(), root=None):
    """(trainer, sub) of ``CONFIG``: a tree of ``size`` written under
    ``root`` (default ``_build/profile_hash_scatter``, removed once the
    trainer holds the data), the trainer built by the factory (random
    init), the first camera of a batch drawn with ``seed``."""
    from .cli import split_device
    from .config import factory
    from .config.config import parse_options
    from .data.bup20_tree import write_bup20_tree

    root = root or os.path.join(_build.BUILD_DIR, "profile_hash_scatter")
    shutil.rmtree(root, ignore_errors=True)
    tree = os.path.join(root, "data", "BUP_20")
    write_bup20_tree(tree, *size)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--config", os.path.join(repo, CONFIG), "--dataset-path", tree,
            *FLAGS, *flags]
    _, _, trainer = factory.get_modules_from_config(parse_options(split_device(argv)[1]),
                                                    dev)
    shutil.rmtree(root, ignore_errors=True)
    cfg = trainer.cfg
    batch = trainer.dataset.sample_batch(np.random.default_rng(seed), cfg.batch_size,
                                         cfg.num_rays_sampled_per_img)
    sub = {k: v[:1] if getattr(v, "ndim", 0) >= 1
           and v.shape[0] == batch["imgs"].shape[0] else v for k, v in batch.items()}
    return trainer, sub


def hash_microbatch(trainer, sub) -> dict:
    """The tensors one RGB training microbatch (``grad_step`` at epoch 0)
    gives the V = 8 table-gradient scatter: dict(idx, bary, g, capacity,
    modes, resolutions)."""
    from unittest import mock

    rec = {}
    table_grad = tg.multilevel_table_grad

    def spy(idx, bary, g, capacity, rows_used=None, modes=None):
        if idx.shape[1] == 8 and not rec:
            rec.update(idx=idx.clone(), bary=bary.clone(), g=g.clone(), capacity=capacity,
                       modes=modes)
        return table_grad(idx, bary, g, capacity, rows_used, modes)

    with mock.patch.object(tg, "multilevel_table_grad", spy):
        trainer.grad_step(trainer.stage_for_epoch(0), sub)
    rec["resolutions"] = [int(r) for r in trainer.pipeline.nef.grid.spec.resolutions]
    return rec


def microbatch_ms(trainer, sub, reps: int = 5) -> dict:
    """Host ms (median of ``reps`` after a warm-up, synchronised) of one
    microbatch's ``grad_step`` per stage (RGB at epoch 0, panoptic at
    epoch 1), under the path's per-level plan and under the previous one,
    in turns (previous, path, path, previous)."""
    import time
    from unittest import mock

    from .ops import hash_encoding as he

    def run(stage):
        trainer.grad_step(stage, sub)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer.grad_step(stage, sub)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    out = {}
    for name, epoch in (("rgb", 0), ("panoptic", 1)):
        stage = trainer.stage_for_epoch(epoch)
        runs = {"previous": [], "path": []}
        for which in ("previous", "path", "path", "previous"):
            with contextlib.ExitStack() as stack:
                if which == "previous":
                    stack.enter_context(mock.patch.object(
                        he, "scatter_modes", lambda res, cap: previous_hash_modes(res)))
                runs[which].append(run(stage))
        out[name] = {"ms": {k: statistics.mean(v) for k, v in runs.items()}, "ms_runs": runs}
    return out


def previous_hash_modes(resolutions) -> tuple:
    """The per-level modes the hash encodes used before the merged V = 8
    accumulation: SHARED up to 2^14 lattice corners (r + 1)^3, GLOBAL up to
    2^23, FLOAT beyond."""
    return tuple(tg.SHARED if (r + 1) ** 3 <= 1 << 14 else
                 tg.GLOBAL if (r + 1) ** 3 <= 1 << 23 else tg.FLOAT for r in resolutions)


def _distinct_per_block(keys: torch.Tensor, block: int, span: int) -> int:
    """Sum over blocks of ``block`` consecutive samples of the distinct keys
    (in [0, span)) among keys [V, N] (-1: no event)."""
    n = keys.shape[1]
    s = torch.arange(n, device=keys.device) // block
    flat = (s[None, :] * span + keys.long())[keys >= 0]
    return int(torch.unique(flat).numel())


def hash_level_stats(idx: torch.Tensor, bary: torch.Tensor, g: torch.Tensor,
                     capacity: int, modes, w: int = 2) -> list:
    """Per-level event statistics of idx, bary [L, 8, N] and g [L, F, N]
    (see the module doc). An event is non-zero where its weight and some
    cotangent are; ``w`` is the sums a row takes (NT * F)."""
    out = []
    n = idx.shape[2]
    for lv in range(idx.shape[0]):
        nz = (bary[lv] != 0) & (g[lv] != 0).any(dim=0)[None, :]          # [8, N]
        keys = torch.where(nz, idx[lv], torch.full_like(idx[lv], -1))
        rows = keys[keys >= 0].long()
        counts = torch.bincount(rows, minlength=capacity)
        hot = counts > MAX_ADDENDS
        e = dict(level=lv, mode=int(modes[lv]), events=int(idx[lv].numel()),
                 nonzero_events=int(rows.numel()), touched_rows=int((counts > 0).sum()),
                 addends_per_row_max=int(counts.max()), rows_over_120=int(hot.sum()),
                 events_share_over_120=float(counts[hot].sum()) / max(rows.numel(), 1))
        for block in (256, 1024, 2048):
            e[f"distinct_rows_per_{block}"] = (_distinct_per_block(keys, block, capacity)
                                               / ((n + block - 1) // block))
        flushes = _distinct_per_block(keys, 1024, capacity)
        e["merged_flushes_1024"] = flushes
        e["merge_removes_share_1024"] = 1.0 - flushes / max(rows.numel(), 1)
        pairs = torch.where(keys >= 0, keys >> 1, keys)
        e["distinct_pairs_per_1024"] = (_distinct_per_block(pairs, 1024, capacity // 2)
                                        / ((n + 1023) // 1024))
        # blocks of 1024 samples a row is flushed from
        blk = torch.arange(n, device=idx.device) // 1024
        uniq = torch.unique((blk[None, :] * capacity + keys.long())[keys >= 0])
        per_row = torch.bincount(uniq % capacity, minlength=capacity)
        e["blocks_per_row_max"] = int(per_row.max())
        e["rows_over_120_blocks"] = int((per_row > MAX_ADDENDS).sum())
        # the previous plan: a warp run of equal rows at one corner slot
        # (consecutive lanes of 32) issues once if any of its events is
        # non-zero
        heads = torch.ones_like(idx[lv], dtype=torch.bool)
        heads[:, 1:] = idx[lv][:, 1:] != idx[lv][:, :-1]
        heads[:, ::32] = True
        run_id = torch.cumsum(heads.reshape(-1).long(), 0) - 1
        run_nz = torch.zeros(int(run_id[-1]) + 1, dtype=torch.bool, device=idx.device)
        run_nz[run_id[nz.reshape(-1)]] = True
        runs = int(run_nz.sum())
        e["warp_runs"] = runs
        if modes[lv] == tg.SHARED:
            e["previous_atomics_single"] = flushes * w
            e["previous_atomics_dual"] = flushes * 2 * w
        elif modes[lv] == tg.GLOBAL:
            e["previous_atomics_single"] = runs * w
            e["previous_atomics_dual"] = runs * 2 * w
        else:
            e["previous_atomics_single"] = runs
            e["previous_atomics_dual"] = 2 * runs
        e["window"] = [window_stats(idx[lv], capacity, seg) for seg in (4, 8)]
        out.append(e)
        del nz, keys, rows, counts, pairs, uniq, per_row, heads, run_id, run_nz
    return out


def window_stats(idx_l: torch.Tensor, capacity: int, seg: int, lanes: int = 32) -> dict:
    """The flushes of the window accumulation (``csrc/permuto_scatter.cu``
    "Window levels") of one level's idx [V, N] with segments of ``seg``
    samples a thread: an entry goes out where the next sample of its
    segment has no event at its row, and at the segment's end, where equal
    rows at one slot of consecutive segments (lanes of a warp) merge first.
    Returns the flushes, their share of the events and the flushes per row
    (largest, rows over 120)."""
    v, n = idx_l.shape
    key = idx_l.long()
    s = torch.arange(n, device=key.device)
    last = (s % seg == seg - 1) | (s == n - 1)
    nxt = torch.roll(key, -1, dims=1)                                   # [V, N]
    cont = (key[:, None, :] == nxt[None, :, :]).any(dim=1) & ~last[None, :]
    mid = ~cont & ~last[None, :]
    fin = key[:, last]                                                  # [V, segs]
    segs = fin.shape[1]
    head = torch.ones_like(fin, dtype=torch.bool)
    head[:, 1:] = fin[:, 1:] != fin[:, :-1]
    head[:, torch.arange(segs, device=key.device) % lanes == 0] = True
    out = torch.cat([key[mid], fin[head]])
    per_row = torch.bincount(out, minlength=capacity)
    return dict(seg=seg, flushes=int(out.numel()), flush_share=out.numel() / key.numel(),
                flushes_per_row_max=int(per_row.max()),
                rows_over_120_flushes=int((per_row > MAX_ADDENDS).sum()))


# ---------------------------------------------------------------- builds
def table_grad_entry(lib_path: str):
    """f(idx, bary, gs, capacity, modes) -> float32 gradients through the C
    interface ``pagnerf_table_grad`` / ``pagnerf_table_grad_scratch`` of the
    library at ``lib_path`` (every level live)."""
    lib = ctypes.CDLL(lib_path)
    grad, scratch = lib.pagnerf_table_grad, lib.pagnerf_table_grad_scratch
    grad.argtypes, grad.restype = tg._scatter_kernels()[0].argtypes, ctypes.c_int
    scratch.argtypes, scratch.restype = tg._scatter_kernels()[1].argtypes, ctypes.c_int64

    def call(idx, bary, gs, capacity, modes):
        l, v, n = idx.shape
        f = gs[0].shape[1]
        c_modes = (ctypes.c_int32 * l)(*modes)
        c_rows = (ctypes.c_int32 * l)(*([capacity] * l))
        nbytes = scratch(c_modes, c_rows, l, capacity, n, f, len(gs))
        if nbytes < 0:
            raise ValueError(f"{lib_path} refuses modes {modes}")
        buf = torch.empty(nbytes, dtype=torch.uint8, device=idx.device)
        outs = [torch.empty((l, capacity, f), device=idx.device) for _ in gs]
        err = grad(idx.data_ptr(), bary.data_ptr(), gs[0].data_ptr(), gs[-1].data_ptr(),
                   outs[0].data_ptr(), outs[-1].data_ptr(), buf.data_ptr(), c_modes, c_rows,
                   l, capacity, n, f, len(gs), v, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{lib_path}: cudaError_t {err}")
        return outs
    return call


def sm_clock_hz(lib) -> float:
    clocks = torch.zeros(2, dtype=torch.int64, device="cuda")
    lib.pagnerf_scatter_clock.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    err = lib.pagnerf_scatter_clock(20_000_000, clocks.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"clock kernel: cudaError {err}")
    c, ns = clocks.tolist()
    return c / ns * 1e9


ATOMIC_KINDS = {0: "float32", 1: "float2", 2: "float4", 3: "float64", 4: "two_float64",
                5: "int32_cas"}


def ceilings(lib, sms: int, clock_hz: float, atomics: int = 1 << 24) -> list:
    """``atomics`` atomics of each kind to random 16-byte rows: in device
    memory of 4, 8 and 64 MB (8 a lane) and in 16 KB of shared memory per
    block (64 a lane); device ms (median of 10, warm) and atomics per SM
    per clock."""
    fn = lib.pagnerf_scatter_ceiling
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    out = []
    for where, sizes in ((0, (4 << 20, 8 << 20, 64 << 20)), (1, (16 << 10,))):
        per_lane = 64 if where else 8     # the shared table is zeroed per block
        for size in sizes:
            for kind, name in ATOMIC_KINDS.items():
                if where == 1 and kind in (1, 2):
                    continue
                call = lambda: fn(buf.data_ptr(), size // 16, kind, where, atomics // per_lane,
                                  per_lane, torch.cuda.current_stream().cuda_stream)
                err = call()
                if err:
                    raise RuntimeError(f"ceiling kernel: cudaError {err}")
                ms = cuda_ms(call)
                out.append({"kind": name, "in": "shared" if where else "device",
                            "bytes": size, "atomics": atomics, "ms": ms,
                            "per_sm_per_clock": atomics / (ms * 1e-3) / sms / clock_hz})
    return out


def profile_build(workdir: str) -> tuple:
    """(library with the measurement aids, ptxas report, SASS opcode counts
    of the scatter kernels) of this package's ``permuto_scatter.cu``."""
    from .profile_encode import ptxas_usage, sass_histogram

    source = os.path.join(_build.CSRC, "permuto_scatter.cu")
    lib_path = os.path.join(workdir, "libscatter_profile.so")
    log = _nvcc(source, lib_path, ("-DPAGNERF_SCATTER_PROFILE", "-Xptxas", "-v"))
    sass = {k: v for k, v in sass_histogram(lib_path).items()
            if "grad" in k or "finish" in k or "redo" in k or "fix" in k}
    return ctypes.CDLL(lib_path), ptxas_usage(log), sass


def candidate_plans(res, c) -> dict:
    """Per-level plans timed beside the path's (``hash_encoding.scatter_modes``):
    the previous one, WINDOW from other levels on, and SHARED on the two
    coarsest levels."""
    from .ops import hash_encoding as he

    corners = [(r + 1) ** 3 for r in res]
    plans = {"path": he.scatter_modes(res, c), "previous": previous_hash_modes(res)}
    for name, k in (("window_from_2^19", 1 << 19), ("window_from_2^23", 1 << 23),
                    ("window_all", 0)):
        plans[name] = tuple(tg.GLOBAL if x <= k else tg.WINDOW for x in corners)
    plans["shared_2_path"] = tuple(tg.SHARED if lv < 2 else m
                                   for lv, m in enumerate(plans["path"]))
    return plans


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another permuto_scatter.cu to time beside this one")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=FLAGS",
                    help="also build this package's source with these nvcc flags and time "
                         "it in turns with the plain build (repeatable)")
    ap.add_argument("--out", help="also write every part to this JSON file")
    ap.add_argument("--skip-stats", action="store_true", help="skip the per-level statistics")
    ap.add_argument("--skip-ceilings", action="store_true", help="skip the atomics ceilings")
    ap.add_argument("--skip-plans", action="store_true",
                    help="skip the candidate plans and the per-level modes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_hash_scatter: needs a CUDA card")
    from .ops import hash_encoding as he

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=20).stdout.strip().splitlines()[0]
    results = []

    def emit(part, **fields):
        rec = {"part": part, "card": card, **fields}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    workdir = tempfile.mkdtemp(prefix="hash_scatter_")
    try:
        from concurrent.futures import ThreadPoolExecutor

        source = os.path.join(_build.CSRC, "permuto_scatter.cu")
        jobs = {}      # name -> (source, library, extra flags)
        if args.parent:
            jobs["parent"] = (args.parent, os.path.join(workdir, "libparent.so"), ())
        for spec in args.variant:
            name, flags = spec.split("=", 1)
            jobs[name] = (source, os.path.join(workdir, f"lib{name}.so"), flags.split())
        with ThreadPoolExecutor(len(jobs) + 2) as ex:
            built = [ex.submit(_nvcc, *job) for job in jobs.values()]
            package = ex.submit(tg._scatter_kernels)
            lib, ptxas, sass = profile_build(workdir)
            for b in built:
                b.result()
            package.result()
        emit("build", ptxas=ptxas, sass=sass)
        others = {k: table_grad_entry(lib_path) for k, (_, lib_path, _) in jobs.items()}
        if not args.skip_ceilings:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            clock = sm_clock_hz(lib)
            emit("ceilings", sms=sms, sm_clock_hz=clock, ceilings=ceilings(lib, sms, clock),
                 sm_clock_hz_after=sm_clock_hz(lib))

        trainer, sub = hash_trainer(dev)
        mb = hash_microbatch(trainer, sub)
        idx, bary, g, c = mb["idx"], mb["bary"], mb["g"], mb["capacity"]
        res = mb["resolutions"]
        modes = he.scatter_modes(res, c)
        prev = previous_hash_modes(res)
        l, _, n = idx.shape
        f = g.shape[1]
        if not args.skip_stats:
            emit("stats", L=l, C=c, F=f, N=n, resolutions=res, path_modes=list(mb["modes"]),
                 previous_modes=list(prev), levels=hash_level_stats(idx, bary, g, c, prev))

        gen = torch.Generator(device=dev).manual_seed(1)
        g_b = torch.randn(g.shape, generator=gen, device=dev)
        cases = {"single": (g,), "single_same_signed": (g.abs(),), "dual": (g, g_b),
                 "dual_same_signed": (g.abs(), g_b.abs())}
        plans = {"path": modes} if args.skip_plans else candidate_plans(res, c)
        # the kernels by name: this build under each plan; the parent under the
        # previous plan; each variant under the path's
        fns = {f"this:{p}": (lambda gs, m=m: tg._launch_grad(idx, bary, gs, c, None, m))
               for p, m in plans.items()}
        for name, entry in others.items():
            m = prev if name == "parent" else modes
            fns[name] = lambda gs, e=entry, m=m: e(idx, bary, gs, c, m)
        for name, gs in cases.items():
            worst = {k: scatter_worst(fn(gs), idx, bary, gs, c) for k, fn in fns.items()}
            emit("check", case=name, worst_err_over_tol=worst,
                 ok=all(w <= 1.0 for w in worst.values()))

        flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
        flush = flush_buf.zero_
        for name, gs in (("single", cases["single"]), ("dual", cases["dual"])):
            emit("kernels", kernel=name, modes=list(modes),
                 kernels_ms={k: kernel_breakdown(lambda fn=fn: fn(gs))
                             for k, fn in fns.items() if k == "this:path" or ":" not in k})
            # every other version in turns with this build's path plan
            runs = {k: [] for k in fns}
            for k in fns:
                if k == "this:path":
                    continue
                for k2 in (k, "this:path", "this:path", k):
                    runs[k2].append(cuda_ms(lambda: fns[k2](gs), flush=flush))
            if len(fns) == 1:
                runs["this:path"].append(cuda_ms(lambda: fns["this:path"](gs), flush=flush))
            emit("time", kernel=name, N=n, ms={k: statistics.mean(v) for k, v in runs.items()},
                 ms_runs=runs)
            # each level alone under its path mode and under each mode
            # (profiler: kernels only, no launch gaps)
            one = lambda lv, m: kernel_breakdown(lambda: tg._launch_grad(
                idx[lv:lv + 1], bary[lv:lv + 1], [g_[lv:lv + 1] for g_ in gs], c, None, (m,)))
            emit("levels", kernel=name, modes=list(modes),
                 kernels_ms=[one(lv, modes[lv]) for lv in range(l)])
            if not args.skip_plans:
                emit("level_modes", kernel=name,
                     kernels_ms={m: [one(lv, m) for lv in range(l)] for m in tg.MODES})
        del cases, g_b, flush_buf
        emit("microbatch", N=n, **microbatch_ms(trainer, sub))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh)


if __name__ == "__main__":
    sys.exit(main())
