#!/usr/bin/env python3
"""Drive the PyTorch port (``pagnerf_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card
    python3 chip_smoke.py --data-parallel   # the data-parallel phases alone
                                            # (NCCL on several cards)

Phases, each printing one JSON line as it ends:

1. device  -- refuse to run without CUDA; name the card and its power limit.
2. build   -- compile ``ops/csrc/permuto_encode.cu`` (the fused encode),
   ``ops/csrc/permuto_gather.cu`` (the gathers, V = 4 and 8),
   ``ops/csrc/permuto_scatter.cu`` (backward kernels, V = 4 and 8, and the
   row scatter-add) and ``ops/csrc/lap_assign.cu`` (the exact assignment)
   with nvcc (ctypes route), one nvcc each, all started together.
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
   timed beside ``torch.nn.functional.embedding_bag``; the dual kernel reads
   one packed [L, C, 2F] row a vertex (``ops/table_pack.py``), timed on the
   kept copy and with a fresh pack a call (a table's version bumped first,
   as an update does).
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
   run directories under ``pagnerf_tpu_torch/_build/cli``. The run also
   launches the assignment kernel once per microbatch of the instance
   loss's stage (its count checked apart from the other kernels').
   fused_step -- main path 6d, ``--fused-micro-step``: the assignment
   kernel (``ops/csrc/lap_assign.cu``, one warp per image) against its
   plain version on the card, the same columns exactly, on the cases of
   ``tests/test_torch_assignment.py`` (the 200 x 200 ones at 48 x 48, which
   the plain version solves in about a second), on small-integer ties
   across a warp's 32-column chunks (K, M of 33 to 70) and on the cli run's
   first panoptic microbatch's own costs (saved to
   ``pagnerf_tpu_torch/_build/assign_recorded.pt``); on the uncut 200 x 200
   cases the matched cost against ``scipy``'s optimum; every case's kernel
   time (launches back to back in a CUDA graph), the empty kernel's at the
   same plan (the floor of a launch) and the wrapper's time; on the
   microbatch also the plain version's and the host ``scipy`` solve's
   (copies included); then the graph
   against the host loop at each stage of ``CLI_FLAGS`` at full width (a
   fresh trainer's dense RGB step; from the cli run's checkpoint the packed
   RGB, voxel packed panoptic and val-pose steps): one step from one state
   through the host loop twice (the spread of its float atomics), through
   the fused step's eager first step, its capture and replay, a replay and
   a replay under ``torch.profiler``: parameters, moments and counts
   bit-equal or within the host spread, losses bit-equal, the profiled
   replay's kernels those the step implies; then ``cli.main`` on the cli
   phase's argv with ``--fused-micro-step`` (all 4 epochs): its stages,
   per-epoch losses and final metrics against the cli run's, the median
   step wall per stage of both (``dispatch_ahead`` 4), the captures, their
   ms and replays, the peak memory of both, and the launches: counted by
   the wrappers (each key's eager first step, the prunes, the
   validations) against those expected, plus the kernels the profiler saw
   in the first replay of each capture (each against what its step
   implies); the launches all replays imply are printed apart
   (``implied_on_card``); run directories under
   ``pagnerf_tpu_torch/_build/cli_fused``.

10a-d. the apps, from the cli run's final checkpoint at ``CLI_FLAGS``:
   render_views -- main path 6a: ``cli.main`` with ``--pretrained`` and
   ``--render-views`` at the tuned config's full width: 120 views x 4
   channels, each PNG read back with ``data/image_io.read_png`` equal to
   the returned frame; launch counts set to 0 before and read after: one
   dual encode per rendered chunk, none with idx/bary, nothing else; one
   view through the kernels against the plain encodes (channels 1e-2, depth
   1e-2 of its largest value, as ``validate``); ``render_orbit``'s ms per
   view. optimizers -- the same config restored with one more epoch: one
   full-width training step each with ``--optimizer-type sgd``,
   ``rmsprop`` and ``adam --weight-decay 1e-6`` (a fresh optimizer state
   each), the card's update redone on CPU copies of the parameters and
   state from the card's own gradients (1e-6 relative), a non-finite
   gradient leaving everything bit-equal; a decoder forward at full width
   per activation (``sin``, ``selu``, ``gelu``), card against CPU.
   viewer -- main path 6b: ``app/viewer_server.make_server`` on that
   trainer, served from a thread: the page, ``/api/info``, each channel's
   ``/api/frame`` (first and cached ms), ``/api/free_frame`` and
   ``/api/click``, each PNG read back equal to its array, the launches of
   the view's and the free pose's renders; ``POST /api/train?epochs=1``
   polled to its end: the epoch advanced, the view's channels changed, the
   launches its steps imply (scatters, dbary, encodes); ``/api/stop``.
   hp_sweep -- main path 6c: ``python -m pagnerf_tpu_torch.main_hp_tunning``
   on the tuned config, 2 learning rates, rungs of 1 epoch, 2 rungs, 2
   worker processes on the card at once: 2 + 1 results, all scored, the
   rung-1 trial resumed from its rung-0 checkpoint to epoch 2; each
   worker's wall, peak memory and launches.

11. bup20 -- main path 7: the flagship's own config,
   ``configs/bup20/best.yaml``, through ``cli.main`` over a BUP20-format
   tree of the synthetic scene that the port writes itself
   (``data/bup20_tree.py``; 90 frames at 320x180, a quarter of BUP20's
   1280x720 per side; the real BUP20 is not in the repository) under
   ``pagnerf_tpu_torch/_build/bup20``: ``--validate-dataset`` (and
   ``-deep``) report 0 errors on the tree and at least one on a copy with
   a depth frame deleted; then training at the config's full width (24
   LoDs x 2^18 x F=2, main and delta grid, hidden 64, 512 steps, 4096
   rays x batch 6, max_depth 1.4) with only the epochs and the stage
   starts and the periodic validation moved (``BUP20_FLAGS``): RGB
   steps, panoptic steps, a validation at val_mip 2 (80x45) and the final
   one at mip 0 (320x180, as best.yaml makes it), the sizes read from
   what ``get_images`` returned. Launch counts set to 0 before and read
   after: those the steps' cameras and the validation chunks imply. Each
   kernel at each N the run gave it against its plain version
   (``recorded_kernel_checks``), the validation's dual encodes without
   idx/bary at N = 8000 x 512, 3600 x 512 and 1600 x 512 too, with times
   and bounds. The loader's wall, the step wall and rays/s per stage, each
   validation's wall and the metrics;
   then the port's readers on a 1280x720 tree (every PNG row
   Paeth-filtered): one RGB and one depth decode and the window's files.

12. panoptic_dd -- main path 8: ``configs/bup20/panoptic_dd.yaml``
   (``PanopticDDensityNeF`` under the delta-density tracer: the panoptic
   channels integrate under the NeF's own ``panoptic_density``) through
   ``cli.main`` over the bup20 phase's tree at the same full width with
   ``BUP20_FLAGS``: an RGB epoch (the single encode and scatter: no
   panoptic channel is asked for), two panoptic epochs (the dual encode
   and scatter, dbary), a validation at mip 2 and the final one at mip 0.
   Launch counts set to 0 before and read after: those the steps' cameras
   and the validation chunks imply. One panoptic microbatch's gradients
   through the kernels against the plain backward; max |panoptic_alpha -
   alpha| of a rendered batch must be > 0 (the DD transmittance is used).
   Each kernel at the training N on this path's own idx, bary and
   cotangents, and at any (kernel, N) no earlier phase recorded, against
   its plain version, with times and bounds.

13. mean_shift -- main path 9: ``configs/bup20/mean_shift_contrastive.yaml``
   (``MeanShiftPanopticDeltaNeF`` with raw normalised embeddings and the
   ``sup_contrastive`` instance loss), as ``panoptic_dd``; the launches
   include each validation's clustering renders (20,000 pixels over the
   training images, N = 512 x 512 per image). Besides: the contrastive
   loss of a full batch on the card against the same tensors' loss on the
   CPU (1e-4 relative); each validation fits the mean shift
   (``train_clustering``) and predicts every image through it: the fit's
   and the predictions' walls, the centres and clusters, and the last
   image's chunked predict against the one broadcast of the JAX package
   (walls, its bytes, equal ids); finite PQ and mAP.

14-17. panoptic_nerf, mean_shift_app, semantic_nerf_app,
   panoptic_lifting_app -- main paths 10-13: ``configs/bup20/
   panoptic_nerf.yaml`` (``MeanShiftPanopticNeF`` over the hash grid: 14
   LoDs x 2^19 x F=2, resolutions 16 -> 512, 200-wide embeddings, 2048 rays
   x batch 25, 512 steps, N = 1,048,576 a microbatch, no extrinsics),
   ``mean_shift_contrastive_app.yaml`` (the triplanar grid),
   ``semantic_nerf_app.yaml`` (``SemanticNeF``: no grid, an 8-layer
   256-wide trunk) and ``panoptic_lifting_app.yaml``
   (``PanopticLiftingNeF``: a 128^3 TensoRF grid) through ``cli.main`` over
   the bup20 phase's tree at their own widths with ``SLICE_FLAGS``: an RGB
   epoch, a panoptic epoch, a validation at mip 2 and the final one at mip
   0 (the three plain-PyTorch configs at mip 2, ``--low-res-val``; the
   ``_app`` configs centred on the tree's frame 47). Launch counts
   set to 0 before and read after: on the hash grid one gather and one
   scatter (V = 8) per microbatch and one gather per rendered chunk, on the
   plain-PyTorch grids none. On the hash grid then: one panoptic
   microbatch with the train extrinsics optimised (gather, scatter and
   dbary at V = 8 once each; another microbatch's gradients through the
   kernels against the plain backward), and each V = 8 kernel on the
   path's own idx, bary, cotangents and tables at each N the path gave it
   (the gathers single and dual -- the dual on packed rows, also with a
   fresh pack a call --, also at the validation chunks' N without
   a gradient; the scatters single and dual with the path's per-level
   modes (GLOBAL, then the window merge), timed in turns with the previous
   per-level plan on the same tensors, and each level's scatter under each
   mode; dbary) against its plain version, with times, bounds and
   ``embedding_bag`` / ``index_add_`` beside them.

Between train_post_prune and validate, data_parallel -- ray-axis data
parallelism (``parallel/sharding.py``) on the tuned config at full width:
every stage of ``DP_BLOCKS`` (dense RGB, packed RGB after the seed prune,
voxel packed panoptic, val-pose, and the voxel stage traced in
``ray_chunk`` blocks whose water-fill spans the ranks) on every rank
against one process (``phase_data_parallel``); on several cards (NCCL) the
fused step against the host loop, in the voxel stage bit-equal, in the
``ray_chunk`` block within the host loop's spread over two runs.

18. data_parallel_contrastive -- ``sup_contrastive`` under the group:
   ``configs/bup20/mean_shift_contrastive_app.yaml`` at its width over the
   bup20 phase's tree, one microbatch's losses and gradients and a step's
   losses on every rank against one process, no pack overflow, the audit
   of the embeddings' gathers (B x R x D per microbatch, labels and anchor
   mask, the reduce-scatter), and a control with the reduce-scatter
   dropped, which the gradient bound must fail; on several cards the fused
   step against the host loop's spread over two runs.

19. bf16_read -- ``PAGNERF_BF16_GATHER=1``: the fused encodes, dbary (V = 4
   and 8) and the gathers (V = 4 at the render's N, V = 8) reading bfloat16
   rows against their plain versions at every N the paths gave them, the
   bf16 read's time in turns with the float32 read's (the copies kept, and
   made again a call) and its bound with 2-byte rows; the tuned config in a
   dense RGB and in the voxel packed panoptic stage from one state with the
   switch on, with it off on tables rounded to bfloat16 (the gradients
   within ``BF16_STEP_GRAD_SHARE``) and with it off (the control, which must
   break that bound), the fused step with the switch on against the host
   loop (capture and two replays), and the hash encodes with a coordinate
   gradient, with the launches of each kernel there.

Then the ``{"kernels": [...]}`` line (the V = 4 kernels, then the V = 8
rows ``hash_*``, then ``lap_assign``; the bf16 read's rows carry
``bf16_read``), the ``nvidia-smi`` name/power line, and last ``{"ok":
true, "device": {...}}``. Any failure raises and exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
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


def gather_bound(l, c, f, n, num_tables, itemsize, rows_used, v=4, row_itemsize=None):
    """Least time for the gather at these shapes: bytes (idx read once, bary
    and each table's reachable rows read once, each output written once)
    over the memory rate, against flops (V products and sums per output)
    over the float32 rate. ``row_itemsize``: the rows' element size where
    it is not bary's and the outputs' (the bf16 table read: 2 against 4)."""
    rows = itemsize if row_itemsize is None else row_itemsize
    nbytes = l * v * n * 4 + l * v * n * itemsize \
        + num_tables * (table_bytes(rows_used, c, f, rows) + l * f * n * itemsize)
    return _bound(nbytes, num_tables * l * f * n * v * 2)


# float32 operations of the fused encode's lattice per (level, sample):
# scaling 3, elevation 16, rounding 12, differences and deltas 12, weights 7
# (csrc/permuto_encode.cu ``simplex``; the index math is integer)
LATTICE_FLOPS = 50


def encode_bound(l, c, f, n, num_tables, itemsize, with_lattice, rows_used,
                 row_itemsize=None):
    """Least time for the fused encode: bytes (x read once, each table's
    reachable rows read once, each output written once, and idx/bary when
    written) over the memory rate, against flops (the lattice, and V
    products and sums per output) over the float32 rate. ``row_itemsize``
    as in ``gather_bound``."""
    v = 4
    rows = itemsize if row_itemsize is None else row_itemsize
    nbytes = 3 * n * 4 + num_tables * (table_bytes(rows_used, c, f, rows)
                                       + l * f * n * itemsize)
    if with_lattice:
        nbytes += 2 * l * v * n * 4
    return _bound(nbytes, l * n * (LATTICE_FLOPS + num_tables * f * v * 2))


def scatter_bound(l, c, f, n, num_tables, v=4):
    """Least time for the table-gradient scatter: idx and bary read once,
    each table's cotangent g [L, F, N] read once and gradient [L, C, F]
    written once in full, unreachable rows being zeros of the output too
    (float32); one product and one sum per event and feature."""
    nbytes = 2 * l * v * n * 4 + num_tables * (l * f * n * 4 + l * c * f * 4)
    return _bound(nbytes, num_tables * l * v * n * f * 2)


def dbary_bound(l, c, f, n, rows_used, v=4, row_itemsize=4):
    """Least time for dbary: idx, g and the table's reachable rows read
    once, dbary written once (float32; the rows bfloat16 in the bf16 table
    read, ``row_itemsize`` 2); F products and sums per output."""
    nbytes = l * v * n * 4 + l * f * n * 4 + table_bytes(rows_used, c, f, row_itemsize) \
        + l * v * n * 4
    return _bound(nbytes, l * v * n * f * 2)


def fresh_pack(kern, table):
    """``kern`` (a dual gather) after ``table``'s version is bumped, as an
    update bumps it: the call makes the packed copy of its tables again."""
    import torch

    def call():
        torch.autograd.graph.increment_version(table)
        return kern()
    return call


def _kernel_wrappers():
    """Every kernel wrapper of the port, by name, with its launch count."""
    # importing permuto_encoding registers the fused encodes in KERNELS
    from pagnerf_tpu_torch.ops import permuto_encoding  # noqa: F401
    from pagnerf_tpu_torch.ops import scatter_rows, table_gather
    return {**table_gather.KERNELS, "scatter_rows": scatter_rows.scatter_rows}


def _reset_launches() -> None:
    from pagnerf_tpu_torch.ops import assignment, scatter_rows, table_gather
    _kernel_wrappers()                  # registers the fused encodes first
    table_gather.reset_launches()
    scatter_rows.scatter_rows.launches = 0
    assignment.lap_assign.launches = 0


def _assign_launches() -> int:
    """The assignment kernel's launches (kept out of ``_launches``, whose
    keys the earlier phases' gates compare whole)."""
    from pagnerf_tpu_torch.ops.assignment import lap_assign
    return lap_assign.launches


def _launches() -> dict:
    return {k: fn.launches for k, fn in _kernel_wrappers().items()}


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from pagnerf_tpu_torch.ops import _build, assignment, permuto_encoding, table_gather

    def timed(name):
        t = time.perf_counter()
        path = _build.build(name)
        return os.path.relpath(path, ROOT), time.perf_counter() - t

    t = time.perf_counter()
    sources = ("permuto_encode", "permuto_gather", "permuto_scatter", "lap_assign")
    with ThreadPoolExecutor(len(sources)) as ex:
        futures = {n: ex.submit(timed, n) for n in sources}
        built = {n: f.result() for n, f in futures.items()}
    permuto_encoding._encode_kernel()
    table_gather._kernel()
    table_gather._scatter_kernels()
    assignment._kernels()
    emit("build", wall_seconds=time.perf_counter() - t,
         seconds={n: s for n, (_, s) in built.items()},
         libraries={n: p for n, (p, _) in built.items()},
         flags=" ".join(_build.NVCC_FLAGS))


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
    # the kernel stages no level in shared memory and takes one sample a
    # thread (PERF.md); its levels run in interleaved groups
    group, order = pe.encode_level_order(l)
    plan = dict(shared_memory_levels=[], samples_per_thread=1,
                level_groups=[order[i:i + group] for i in range(0, l, group)])
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
                 F=f, N=n, idx_bary_written=with_lattice, kernel_plan=plan,
                 **results[(where, dtype)])
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
            pack = dict(ms_with_pack=cuda_ms(fresh_pack(kern, ta), flush=flush)) \
                if num_tables == 2 else {}
            results[(name, dtype)] = dict(
                max_abs_err=err, tol=tol, **pack,
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


def kernel_vs_plain_grads(trainer, stage, dev):
    """One microbatch of a camera that is not an anchor frame (a batch drawn
    with seed 1, jitter from seed 2) through the kernels and through the
    plain backward versions: the tables within 64 eps_f32 of each entry's
    sum of |bary * g|, the extrinsics within 1e-3 of their largest
    gradient. Returns (fields, ok)."""
    import numpy as np
    import torch

    cfg = trainer.cfg
    anchor = trainer.pipeline.anchor_mask.cpu().numpy()
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
                 plain_check_channels=sorted(stage.channels),
                 plain_check_table_max_abs_err=table_err,
                 plain_check_table_worst_err_over_tol=worst,
                 plain_check_extrinsics_err=ext_err,
                 plain_check_extrinsics_max=ext_ref, plain_check_loss_err=loss_err)
    ok = (all(w <= 1.0 for w in worst.values()) and ext_ref > 0
          and ext_err <= 1e-3 * ext_ref)
    return check, ok


def phase_train(dev, stage_name):
    import numpy as np
    import torch

    from pagnerf_tpu_torch.entry import train_flagship

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    trainer, log = train_flagship(stage_name, steps=3, device=dev)
    torch.cuda.synchronize()
    launches = _launches()
    assign = _assign_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

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
    # the instance loss solves each microbatch's assignment in one launch
    if assign != (micro if stage_name == "panoptic" else 0):
        raise AssertionError(f"{stage_name} training launched lap_assign {assign} times "
                             f"for {micro} microbatches")
    for s in log:
        if not all(np.isfinite(v) for v in s["losses"].values()):
            raise AssertionError(f"{stage_name} step losses not finite: {s}")

    stage = trainer.stage_for_epoch(log[-1]["epoch"])
    cfg = trainer.cfg
    check, ok = kernel_vs_plain_grads(trainer, stage, dev)
    if not ok:
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
        lap_assign_launches=assign, **check)
    emit(f"train_{stage_name}", **result)
    del trainer
    torch.cuda.empty_cache()
    return launches, assign


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


def encode_vs_plain(spec, x, tables, outs, idx_k=None, bary_k=None, bf16_rows=False):
    """A float32 fused encode's outputs, and the lattice it kept, against the
    plain encode on the same tables at one of the main path's N. Outputs per
    level within (4 ulp_f32(max|el_l|) + 8 eps_f32) max|table_l| (the encode
    phase's bound). cuBLAS picks the plain lattice's rounding order of E @ s
    by N, and at some N rounds el apart from the kernel: a vertex may differ
    from the plain lattice's only where the plain weight is within one ulp
    of el of 0, and where they agree each weight is within that ulp.
    ``bf16_rows``: the bf16 table read's plain encode (rows rounded to
    bfloat16). Returns the check's fields, with ``ok``."""
    import torch

    from pagnerf_tpu_torch.ops import permuto_encoding as pe

    st = pe.level_statics(spec.scales, spec.capacity, spec.feature_dim)
    ulps = el_ulps(x, st)
    with torch.no_grad():
        want = ((pe.encode_plain(tables[0], x, spec.scales, bf16_rows),) if len(tables) == 1
                else pe.dual_encode_plain(*tables, x, spec.scales, bf16_rows))
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
    windowed, windowed_launches = windowed_probe_check(trainer, stage, rays, jitter, anchor)
    fields["windowed_probe"] = windowed
    if not windowed["ok"]:
        fail(f"the windowed probe: {windowed}")
    emit("train_post_prune", **fields)
    all_launches = {k: launches[k] + info["prune_launches"][k] + windowed_launches[k]
                    for k in launches}
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


def windowed_probe_check(trainer, stage, rays, jitter, anchor):
    """The two-stage voxel probe (``PAGNERF_WINDOWED_PROBE=1``) at this
    path's voxel stage: the march's device ms single-stage and windowed
    on one microbatch's rays, how many rays the window refits otherwise and
    how many valid samples each keeps, the gate at the tuned config's
    ray_max_travel of 4.0, then one voxel step with the switch on (its
    losses finite, its kernels launched). Returns (record, launches)."""
    from unittest import mock

    import numpy as np
    import torch

    from pagnerf_tpu_torch.ops import raymarch as rmod

    cfg, travel = trainer.cfg, trainer.pipeline.tracer_cfg.ray_max_travel
    march = lambda: rmod.raymarch(rays, trainer.occ, stage.num_steps, "voxel", jitter, travel)
    with torch.no_grad():
        off = march()
        off_ms = cuda_ms(march)
        with mock.patch.dict(os.environ, {"PAGNERF_WINDOWED_PROBE": "1"}):
            plan = rmod._window_plan(trainer.occ, travel)
            tuned_plan = rmod._window_plan(trainer.occ, 4.0)
            on = march()
            on_ms = cuda_ms(march)
    rec = {"occ_level": trainer.occ.level, "ray_max_travel": travel,
           "num_steps": stage.num_steps, "rays": int(rays.origins.shape[0]),
           "plan": None if plan is None else dict(zip(("coarse_level", "pn1", "pn2", "w_max"),
                                                      plan)),
           "single_stage_probes": int(math.ceil(math.sqrt(3.0) * trainer.occ.res)),
           "tuned_travel_4_windowed": tuned_plan is not None,
           "single_ms": off_ms, "windowed_ms": on_ms,
           "rays_refit_otherwise": int((on.t0 != off.t0).sum()),
           "valid_single": int(off.mask.sum()), "valid_windowed": int(on.mask.sum())}
    batch = trainer.dataset.sample_batch(np.random.default_rng(5), cfg.batch_size,
                                         cfg.num_rays_sampled_per_img)
    _reset_launches()
    with mock.patch.dict(os.environ, {"PAGNERF_WINDOWED_PROBE": "1"}):
        losses = {k: float(v) for k, v in trainer.train_step(stage, batch).items()}
    torch.cuda.synchronize()
    launches = _launches()
    micro = batch["imgs"].shape[0]
    rec.update(step_losses=losses, step_launches=launches,
               ok=(plan is not None and all(math.isfinite(v) for v in losses.values())
                   and launches["dual_encode"] == micro
                   and launches["dual_table_grad"] == micro))
    return rec, launches


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
    on the single's events, the second cotangent random. Encodes
    that the path ran under ``no_grad`` (kind + ``NO_IDX_BARY``: the
    validation's chunks) run so here too, and only their outputs are held.
    Returns (checks, times), keyed by kernel and then N."""
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
        if kind.startswith(("encode", "dual_encode")):
            x, dual, grad = rec["x"], kind.startswith("dual"), not kind.endswith(NO_IDX_BARY)

            def kern():
                with torch.set_grad_enabled(grad):
                    return (pe.fused_encode_dual(a, b, x, spec.scales) if dual
                            else (pe.fused_encode(a, x, spec.scales),))
            plain = lambda: (pe.dual_encode_plain(ta, tb, x, spec.scales) if dual
                             else pe.encode_plain(ta, x, spec.scales))
            outs = kern()
            idx = bary = None
            if grad:
                _, idx, bary, _ = outs[0].grad_fn.saved_tensors
            ch = encode_vs_plain(spec, x, (ta, tb) if dual else (ta,),
                                 tuple(o.detach() for o in outs), idx, bary)
            outs = idx = bary = None
            bound_ms, bound_by, _, _ = encode_bound(l, c, f, n, 2 if dual else 1, 4, grad,
                                                    st.rows_used)
            tm = dict(with_idx_bary=grad, max_abs_err=ch["max_abs_err"])
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


# the kind of an encode the path ran under no_grad (it writes no idx/bary)
NO_IDX_BARY = "_no_idx_bary"


@contextlib.contextmanager
def recorded_run(calls, trainers, renders, pack_totals, no_grad=False, assign=None):
    """While a ``cli.main`` run goes: its trainer into ``trainers``, each
    ``batch_render``'s channels and chunk count into ``renders``, the
    packing totals (``quality_run.packing``) into ``pack_totals``, and the
    first call of each kernel at each N the training path gives it into
    ``calls`` (keyed by kernel and N, as ``recorded_kernel_checks`` takes
    them: spied through a stand-in of ``table_gather`` that
    ``permuto_encoding`` sees, so the wrappers' launch counts are
    untouched). With ``no_grad`` also the first encode at each N that ran
    under ``no_grad`` (the validation's chunks), as kind ``encode`` or
    ``dual_encode`` + ``NO_IDX_BARY``. With ``assign`` (a dict), the first
    assignment's inputs (the instance loss's [B, K, M] costs and [B, K]
    presence) into it."""
    from unittest import mock

    import torch

    from pagnerf_tpu_torch import cli
    from pagnerf_tpu_torch.losses import lin_assignment
    from pagnerf_tpu_torch.ops import permuto_encoding as pe
    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.quality_run import packing
    from pagnerf_tpu_torch.train.trainer import PanopticTrainer

    get_modules = cli.get_modules_from_config
    batch_render = PanopticTrainer.batch_render
    encode_t, encode_dual_t = pe.PermutoEncodingSpec.encode_T, pe.PermutoEncodingSpec.encode_dual_T
    table_grad, dual_table_grad = tg.multilevel_table_grad, tg.dual_multilevel_table_grad
    dbary = tg.multilevel_gather_dbary
    lap_assign = lin_assignment.lap_assign

    def assign_spy(cost, present):
        if assign is not None and not assign:
            assign.update(cost=cost.clone(), present=present.clone())
        return lap_assign(cost, present)

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

    def keep_encode(kind, coordsT):
        if torch.is_grad_enabled() or no_grad:
            keep(kind if torch.is_grad_enabled() else kind + NO_IDX_BARY, coordsT.shape[1],
                 lambda: {"x": coordsT.detach().float().contiguous().clone()})

    def encode_spy(self, tables, coordsT, *args, **kwargs):
        keep_encode("encode", coordsT)
        return encode_t(self, tables, coordsT, *args, **kwargs)

    def encode_dual_spy(self, tables_a, tables_b, coordsT, *args, **kwargs):
        keep_encode("dual_encode", coordsT)
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

    with packing(pack_totals), \
         mock.patch.object(lin_assignment, "lap_assign", assign_spy), \
         mock.patch.object(cli, "get_modules_from_config", modules_spy), \
         mock.patch.object(PanopticTrainer, "batch_render", render_spy), \
         mock.patch.object(pe.PermutoEncodingSpec, "encode_T", encode_spy), \
         mock.patch.object(pe.PermutoEncodingSpec, "encode_dual_T", encode_dual_spy), \
         mock.patch.object(pe, "table_gather", _Spied(
             tg, multilevel_table_grad=table_grad_spy,
             dual_multilevel_table_grad=dual_table_grad_spy,
             multilevel_gather_dbary=dbary_spy)):
        yield


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

    import numpy as np
    import torch

    from pagnerf_tpu_torch import cli
    from pagnerf_tpu_torch.quality_run import read_perf, summary

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log_root = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", "cli")
    shutil.rmtree(log_root, ignore_errors=True)
    argv = ["--config", os.path.join(ROOT, CLI_CONFIG), "--device", "cuda",
            "--log-dir", log_root, "--perf"] + CLI_FLAGS
    trainers, renders, calls, pack_totals, assign = [], [], {}, {}, {}
    _reset_launches()
    t0 = time.perf_counter()
    with recorded_run(calls, trainers, renders, pack_totals, assign=assign):
        final = cli.main(argv + ["--exp-name", "train"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    assign_launches = _assign_launches()
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
                  lap_assign_launches=assign_launches,
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
    # one assignment per microbatch of the instance loss's stage
    inst_micro = sum(len(s_["cam_idx"]) for s_ in steps if "inst_embedding" in s_["channels"])
    fields["expected_lap_assign_launches"] = inst_micro
    if assign_launches != inst_micro or not assign_launches:
        fail(f"cli.main launched lap_assign {assign_launches} times, expected {inst_micro}")
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
    host = dict(epochs=epochs, final=final, stages=summ["stages"], peak_gib=peak_gb,
                assign=assign, assign_launches=assign_launches)
    return launches, times, os.path.join(run_dir, "model.ckpt"), host


# ---------------------------------------------------------------- fused_step
ASSIGN_SOURCE = "pagnerf_tpu_torch/ops/csrc/lap_assign.cu"


def lap_assign_bound(b, k, m, steps):
    """Least time for the assignment: the cost read once, presence read and
    columns written once, against the data's own work: each Dijkstra step
    (``steps``, counted by the plain version) an argmin over M columns and a
    relax of M columns (4 float operations each)."""
    return _bound(4 * b * k * m + b * k + 8 * b * k, steps * m * 5)


ASSIGN_RECORDED = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", "assign_recorded.pt")


def phase_assign(dev, recorded):
    """``lap_assign.cu`` (one warp per image) against its plain version on
    the card, matchings exactly equal, on ``profile_assign``'s cases
    (``tests/test_torch_assignment.py``'s, the 200 x 200 ones at 48 x 48,
    which the plain version solves in about a second), its tie cases
    (small-integer costs, K and M of 33 to 70: ties across a warp's
    32-column chunks) and ``recorded`` (the tuned config's [B, K, M] costs
    and presence from the cli phase's first panoptic microbatch); on the
    uncut 200 x 200 cases, too slow for the plain version, the kernel's
    matched cost against ``scipy``'s optimum. On every case the kernel's
    device time (``profile_assign.graph_ms``: launches back to back in a
    CUDA graph), the empty kernel's at the same plan (the floor of a
    launch), and the wrapper's time with CUDA events around one call (host
    time included); on ``recorded`` also the plain version's and the host
    ``scipy`` solve's with its copies (the port's path before the kernel).
    ``recorded`` is saved to ``ASSIGN_RECORDED`` (``profile_assign
    --recorded``)."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment

    from pagnerf_tpu_torch import profile_assign
    from pagnerf_tpu_torch.ops import assignment

    cases = dict(profile_assign.cases_on_card(dev))
    cost, present = recorded["cost"].contiguous(), recorded["present"].contiguous()
    os.makedirs(os.path.dirname(ASSIGN_RECORDED), exist_ok=True)
    torch.save({"cost": cost.cpu(), "present": present.cpu()}, ASSIGN_RECORDED)
    b, k, m = cost.shape
    got = assignment.lap_assign(cost, present)
    want = assignment.lap_assign_plain(cost, present)
    steps = assignment.lap_assign_plain.steps
    torch.cuda.synchronize()

    def host_scipy():
        c = cost.cpu().numpy()
        pres = present.cpu().numpy()
        out = np.zeros((b, k), np.int64)
        for i in range(b):
            rows = np.nonzero(pres[i])[0][:m]
            if rows.size:
                r_idx, c_idx = linear_sum_assignment(c[i][rows])
                out[i, rows[r_idx]] = c_idx
        return torch.from_numpy(out).to(dev)

    tuned_equal = bool(torch.equal(got, want))
    pick = lambda a: torch.gather(cost, 2, a[..., None])[..., 0][present].sum()
    cost_minus_scipy = float(pick(got) - pick(host_scipy()))
    bound_ms, bound_by, nbytes, flops = lap_assign_bound(b, k, m, steps)
    warps, staged, per_warp = assignment.launch_geometry(b, k, m)
    row = dict(
        shape=[b, k, m], present_rows=int(present.sum()), dijkstra_steps=steps,
        equal=tuned_equal, cost_minus_scipy=cost_minus_scipy,
        plan=dict(warps=warps, staged=staged, smem_per_warp=per_warp),
        ms=profile_assign.graph_ms(lambda: assignment.lap_assign(cost, present)),
        launch_floor_ms=profile_assign.graph_ms(lambda: assignment.empty_launch(cost, present)),
        wrapper_ms=cuda_ms(lambda: assignment.lap_assign(cost, present), reps=20),
        plain_ms=cuda_ms(lambda: assignment.lap_assign_plain(cost, present), reps=3),
        host_scipy_ms=cuda_ms(host_scipy, reps=10),
        bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes, bound_flops=flops,
        max_abs_err=int((got - want).abs().max()) if got.numel() else 0)
    fields = dict(cases=cases, tuned=row)
    ok = tuned_equal and all(c["ok"] for c in cases.values())
    emit("fused_step_assign", ok=ok, **fields)
    if not ok:
        raise AssertionError(f"lap_assign kernel differs from its plain version or "
                             f"scipy's optimum: {fields}")
    row["cases_ms"] = {n: {k_: c[k_] for k_ in ("ms", "floor_ms", "wrapper_ms")}
                       for n, c in cases.items()}
    return row


def _step_state(trainer):
    """Copies of what a step changes, by name: parameters, moments, counts."""
    opt = trainer.opt
    out = {f"param {n}": p.detach().clone() for n, p in trainer.params.items()}
    for key in ("mu", "nu"):
        out.update({f"{key} {n}": m.clone() for n, m in getattr(opt, key).items()})
    out["counts"] = opt.counts.clone()
    return out


def _put_state(trainer, state) -> None:
    """Write ``_step_state``'s copies back in place (a captured graph reads
    the tensors themselves)."""
    import torch
    opt = trainer.opt
    live = {f"param {n}": p for n, p in trainer.params.items()}
    for key in ("mu", "nu"):
        live.update({f"{key} {n}": m for n, m in getattr(opt, key).items()})
    live["counts"] = opt.counts
    with torch.no_grad():
        for name, x in live.items():
            x.copy_(state[name])


# the path's kernels as the profiler names them: (index of the NT template
# argument, which tells the single kernel from the dual, or None; the
# launch counters' names for NT = 1 and NT = 2). A wrapper's call launches
# one of each: the encode kernel, the scatter's finish_kernel, dbary_kernel,
# lap_kernel.
PROFILED_KERNELS = {"permuto_encode_kernel": (3, "encode", "dual_encode"),
                    "finish_kernel": (1, "table_grad", "dual_table_grad"),
                    "dbary_kernel": (None, "dbary", "dbary"),
                    "lap_kernel": (None, "lap_assign", "lap_assign")}


def profiled_launches(fn):
    """Run ``fn`` under ``torch.profiler`` (CUDA activity only) and count the
    path's kernels that ran on the card, by name (``PROFILED_KERNELS``):
    the launches of a CUDA graph's replay, which no wrapper counts. Returns
    (fn's result, {counter name: kernels run})."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = "|".join(PROFILED_KERNELS)
    counts = {}
    for e in prof.key_averages():
        m = re.search(rf"\b({names})\b(?:<([^>(]*)>)?", e.key)
        if e.device_type != DeviceType.CUDA or not m:
            continue
        at, single, dual = PROFILED_KERNELS[m.group(1)]
        nt = 1 if at is None else int(m.group(2).split(",")[at])
        key = single if nt == 1 else dual
        counts[key] = counts.get(key, 0) + e.count
    return out, counts


def graph_vs_host(trainer, stage, batch):
    """One step from one state: through the host loop twice (the spread of
    its float atomics), then through the fused step four times -- its eager
    first step, its capture and replay, a replay, and a replay under the
    profiler (the kernels it ran) -- the state (parameters, moments, counts,
    the generator) put back before each. Returns each run's wall, state and
    losses, and the profiled replay's kernels."""
    import torch
    # rate tables long enough for the runs below: a table that grows is a
    # new tensor, and the fused step would start its key again
    trainer.opt._grow_tables(trainer.opt._count_bound + 16)
    gen = trainer.generator.get_state()
    state0 = _step_state(trainer)
    step0 = trainer.global_step
    runs, profiled = {}, None
    for mode in ("host_a", "host_b", "eager", "capture", "replay", "profiled"):
        _put_state(trainer, state0)
        trainer.generator.set_state(gen)
        trainer.global_step = step0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = trainer.train_step if mode.startswith("host") else trainer.fused_train_step
        if mode == "profiled":
            losses, profiled = profiled_launches(lambda: step(stage, batch))
        else:
            losses = step(stage, batch)
        torch.cuda.synchronize()
        runs[mode] = dict(ms=(time.perf_counter() - t0) * 1e3, state=_step_state(trainer),
                          losses={k_: v.clone() for k_, v in losses.items()},
                          keys=len(trainer.fused_log))
    _put_state(trainer, state0)
    trainer.generator.set_state(gen)
    trainer.global_step = step0
    return runs, profiled


def compare_runs(runs):
    """The fused step's runs against the host loop's first: per tensor bit-equal,
    or within the host loop's own spread (its second run against its
    first: max |difference| of the tensor, or the largest spread of any
    tensor relative to its largest entry, times this one's)."""
    a, b = runs["host_a"]["state"], runs["host_b"]["state"]
    diff = lambda x, y: float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
    scale = {n: max(float(t.double().abs().max()) if t.numel() else 0.0, 1e-30)
             for n, t in a.items()}
    spread = {n: diff(a[n], b[n]) for n in a}
    rel_spread = max(spread[n] / scale[n] for n in a)
    out = {"host_spread_max_rel": rel_spread,
           "host_bit_equal": sum(spread[n] == 0 for n in a), "tensors": len(a)}
    ok = True
    for mode in ("eager", "capture", "replay", "profiled"):
        g = runs[mode]["state"]
        d = {n: diff(g[n], a[n]) for n in a}
        worst = {n: d[n] for n in a if d[n] > max(spread[n], rel_spread * scale[n])}
        losses_equal = all(torch_equal(runs[mode]["losses"][k], runs["host_a"]["losses"][k])
                           for k in runs["host_a"]["losses"])
        out[mode] = {"bit_equal": sum(d[n] == 0 for n in a),
                     "max_rel": max(d[n] / scale[n] for n in a),
                     "outside_spread": worst, "losses_bit_equal": losses_equal,
                     "counts_equal": d["counts"] == 0}
        ok = ok and not worst and losses_equal and d["counts"] == 0
    return out, ok


def torch_equal(x, y):
    import torch
    return bool(torch.equal(x, y))


def fused_stage_checks(dev, ckpt):
    """Graph against host loop at every stage of ``CLI_FLAGS`` at full width:
    dense RGB on a fresh trainer (epoch 0), then from the cli phase's final
    checkpoint (trained, pruned) the packed RGB stage of epoch 1, the voxel
    packed panoptic stage of epoch 2 and the val-pose stage of epoch 3, each
    on one batch of its split (``graph_vs_host``); the profiled replay's
    kernels must be those the step implies (``fused_implied``)."""
    import numpy as np
    import torch

    from pagnerf_tpu_torch.config.config import parse_options
    from pagnerf_tpu_torch.config.factory import get_modules_from_config

    out, ok = {}, True
    fresh = get_modules_from_config(parse_options(APP_ARGV), dev)[2]
    trained = restored_trainer(dev, ckpt)
    for epoch, trainer in ((0, fresh), (1, trained), (2, trained), (3, trained)):
        stage = trainer.stage_for_epoch(epoch)
        split = "val" if stage.training_val_poses else "train"
        batch = trainer.dataset.sample_batch(np.random.default_rng(epoch), trainer.cfg.batch_size,
                                             trainer.cfg.num_rays_sampled_per_img, split)
        runs, profiled = graph_vs_host(trainer, stage, batch)
        cmp, ok_ = compare_runs(runs)
        rec = trainer.fused_log[-1]
        implied = fused_implied([rec])[0]
        ok_ = ok_ and profiled == implied and (rec["steps"], rec["replays"]) == (4, 3)
        out[stage.label] = dict(host_ms=[runs["host_a"]["ms"], runs["host_b"]["ms"]],
                                eager_ms=runs["eager"]["ms"],
                                capture_and_replay_ms=runs["capture"]["ms"],
                                replay_ms=runs["replay"]["ms"], capture_ms=rec["capture_ms"],
                                launches_per_replay_profiled=profiled,
                                launches_per_step_implied=implied,
                                steps_replays=[rec["steps"], rec["replays"]],
                                keys_after={m: r["keys"] for m, r in runs.items()},
                                all_anchor=rec["all_anchor"], ok=ok_, **cmp)
        ok = ok and ok_
        trainer._fused.clear()
        del runs
        torch.cuda.empty_cache()
    del fresh, trained
    torch.cuda.empty_cache()
    return out, ok


def fused_implied(log):
    """The launches the fused run's captures imply: per capture, those its
    stage and microbatches ask for per step (per microbatch an encode and a
    table-gradient scatter, dual when a panoptic channel renders; dbary for
    a microbatch with a camera that is not an anchor frame; an assignment
    where the instance loss is on)."""
    want = []
    for rec in log:
        dual = bool(set(rec["channels"]) & {"semantics", "inst_embedding"})
        per = {"dual_encode" if dual else "encode": rec["micro"],
               "dual_table_grad" if dual else "table_grad": rec["micro"],
               "dbary": sum(not a for a in rec["all_anchor"]),
               "lap_assign": rec["micro"] if rec["use_inst"] else 0}
        want.append({k: v for k, v in per.items() if v})
    return want


def phase_fused_step(dev, cli_ckpt, host):
    """Main path 6d: ``--fused-micro-step``. The assignment kernel against
    its plain version; the graph against the host loop stage by stage at full
    width; then ``cli.main`` on the cli phase's argv with
    ``--fused-micro-step`` (full width, all 4 epochs): per-epoch losses and
    the final metrics against the cli phase's host-loop run, the median
    step wall per stage of both (``dispatch_ahead`` 4), the captures, the
    replays, the peak memory, and the launches: counted by the wrappers
    (each key's eager first step, the prunes, the validations; a capture
    and its replays count none), run in the first replay of each capture as
    ``torch.profiler`` saw them on the card (gated against what the step
    implies), and implied on the card by all the replays (reported apart,
    never as launches)."""
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from pagnerf_tpu_torch import cli
    from pagnerf_tpu_torch.quality_run import read_perf, summary

    t_phase = time.perf_counter()
    assign_row = phase_assign(dev, host["assign"])
    stages, stages_ok = fused_stage_checks(dev, cli_ckpt)
    fields = dict(stages=stages)
    if not stages_ok:
        emit("fused_step", ok=False, **fields)
        raise AssertionError(f"the graph and the host loop differ beyond the host spread: "
                             f"{stages}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log_root = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", "cli_fused")
    shutil.rmtree(log_root, ignore_errors=True)
    argv = ["--config", os.path.join(ROOT, CLI_CONFIG), "--device", "cuda",
            "--log-dir", log_root, "--perf", "--exp-name", "fused",
            "--fused-micro-step"] + CLI_FLAGS
    trainers, renders = [], []
    get_modules = cli.get_modules_from_config

    def modules_spy(*args, **kwargs):
        out = get_modules(*args, **kwargs)
        trainers.append(out[2])
        return out

    from pagnerf_tpu_torch.train import trainer as trainer_mod
    run = trainer_mod._FusedStep.run

    def run_spy(self):
        # the first replay of each graph, right after its capture, under the
        # profiler: the kernels it ran on the card
        if self.graph is not None or self.record["steps"] != 1:
            return run(self)
        graph_replay = torch.cuda.CUDAGraph.replay

        def replay_spy(graph):
            _, self.record["profiled"] = profiled_launches(lambda: graph_replay(graph))
        with mock.patch.object(torch.cuda.CUDAGraph, "replay", replay_spy):
            return run(self)

    _reset_launches()
    t0 = time.perf_counter()
    with render_spy(renders), mock.patch.object(cli, "get_modules_from_config", modules_spy), \
            mock.patch.object(trainer_mod._FusedStep, "run", run_spy):
        final = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, assign_launches = _launches(), _assign_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer = trainers[0]
    _, records = read_perf(log_root, "fused")
    summ = summary(records)
    epochs = [{"epoch": r["epoch"], "losses": r["losses"]}
              for r in records if r["name"] == "epoch"]
    log = [dict(r) for r in trainer.fused_log]
    prunes = [r for r in records if r["name"] == "prune"]
    anchor = trainer.pipeline.anchor_host
    # counted by the wrappers: each key's eager first step, the prunes, the
    # validations; run on the card as the profiler saw them: the first
    # replay of each capture; implied on the card: all the replays besides
    counted = cli_launches([], anchor, renders, len(prunes),
                           max(1, trainer.cfg.prune_samples_per_cell)
                           * math.ceil(trainer.occ.res ** 3 / 65536))
    counted["lap_assign"] = 0
    implied, profiled = dict(counted), {}
    for rec, per in zip(log, fused_implied(log)):
        if rec["capture_ms"] is not None and rec.get("profiled") != per:
            emit("fused_step", ok=False, **fields, captures=log)
            raise AssertionError(f"a replay of {rec['stage']} ran {rec.get('profiled')}, "
                                 f"its step implies {per}")
        for k, v in per.items():
            counted[k] += v                       # the eager first step
            implied[k] += (1 + rec["replays"]) * v
            if rec["capture_ms"] is not None:
                profiled[k] = profiled.get(k, 0) + v
    got = dict(launches, lap_assign=assign_launches)
    on_card = {k: got.get(k, 0) + profiled.get(k, 0) for k in set(got) | set(profiled)}
    steps = [r for r in records if r["name"] == "train_step"]
    replays = sum(rec["replays"] for rec in log)
    captured = [rec for rec in log if rec["capture_ms"] is not None]

    loss_diff = {}
    for e_h, e_f in zip(host["epochs"], epochs):
        for k, v in e_h["losses"].items():
            loss_diff[f"{e_h['epoch']} {k}"] = abs(e_f["losses"][k] - v) / max(abs(v), 1e-12)
    metric_diff = {k: final[k] - v for k, v in host["final"].items()
                   if k != "val/render_time_per_img"}
    fields.update(
        assign=assign_row, config=CLI_CONFIG, flags=" ".join(CLI_FLAGS) + " --fused-micro-step",
        wall_s=wall, epochs=epochs, final_metrics=final,
        loss_rel_diff_vs_host=loss_diff, metric_diff_vs_host=metric_diff,
        step_median_ms={k: {"host": host["stages"].get(k, {}).get("median_ms"),
                            "graph": v["median_ms"]} for k, v in summ["stages"].items()},
        first_step_ms={k: {"host": host["stages"].get(k, {}).get("first_ms_max"),
                           "graph": v["first_ms_max"]} for k, v in summ["stages"].items()},
        keys=len(log), eager_steps=sum(rec["steps"] > 0 for rec in log),
        captures=len(captured), capture_ms=[rec["capture_ms"] for rec in captured],
        capture_stages=[rec["stage"] for rec in captured], replays=replays, steps=len(steps),
        peak_allocated_gib={"graph": peak_gb, "host": host["peak_gib"]},
        launches=on_card, counted=got, counted_expected=counted, profiled_replays=profiled,
        implied_on_card=implied,
        launches_per_profiled_replay=[rec["profiled"] for rec in captured],
        phase_s=time.perf_counter() - t_phase)

    def fail(msg):
        emit("fused_step", ok=False, **fields)
        raise AssertionError(msg)

    if [sorted({s_["stage"] for s_ in steps if s_["epoch"] == e}) for e in range(4)] != \
            [["ray_dense_rgb"], ["ray_packed_rgb"], ["voxel_packed_panoptic"], ["val_pose"]]:
        fail("the fused run's epochs ran other stages than the cli phase's")
    if sum(rec["steps"] for rec in log) != len(steps) or \
            replays + sum(rec["steps"] > 0 for rec in log) != len(steps):
        fail(f"{len(log)} eager steps and {replays} replays for {len(steps)} steps")
    if got != counted:
        fail(f"the fused run counted {got}, expected {counted}")
    if not all(on_card.get(k) for k in ("encode", "dual_encode", "table_grad",
                                        "dual_table_grad", "dbary", "lap_assign")):
        fail("a kernel of the path was not launched by the fused run")
    if not all(np.isfinite(v) for e in epochs for v in e["losses"].values()):
        fail("a loss of the fused run is not finite")
    if sorted(final) != sorted(host["final"]) or not all(np.isfinite(v) for v in final.values()):
        fail("the fused run's final metrics are incomplete or not finite")
    if max(loss_diff.values()) > FUSED_LOSS_RTOL:
        fail(f"per-epoch losses differ from the host loop's by more than {FUSED_LOSS_RTOL}")
    far = {k: d for k, d in metric_diff.items() if abs(d) > FUSED_METRIC_ATOL.get(k, 0.01)}
    if far:
        fail(f"final metrics differ from the host loop's: {far}")
    emit("fused_step", ok=True, **fields)
    del trainer, trainers
    torch.cuda.empty_cache()
    return on_card, assign_row


# the fused run against the cli phase's host run: the table-gradient
# scatter's atomics may add a float sum in another order from run to run and
# 48 steps would carry that forward (the runs PERF.md records were equal to
# the bit); bounds on per-epoch losses (relative) and final metrics (absolute)
FUSED_LOSS_RTOL = 1e-3
FUSED_METRIC_ATOL = {"val/psnr": 0.05}


# the apps restore the cli phase's final checkpoint at its flags; the viewer
# and the optimizers' trainer runs one epoch more (its train button)
APP_ARGV = ["--config", os.path.join(ROOT, CLI_CONFIG)] + CLI_FLAGS


def app_root(name):
    import shutil
    root = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root


def expected_render_launches(renders):
    """One encode per rendered chunk, dual when a panoptic channel is asked
    for (``renders``: (channels, chunks) per ``batch_render``)."""
    expected = {k: 0 for k in _launches()}
    for channels, chunks in renders:
        dual = bool(set(channels) & {"semantics", "inst_embedding"})
        expected["dual_encode" if dual else "encode"] += chunks
    return expected


@contextlib.contextmanager
def render_spy(renders, buffers=None):
    """Each ``batch_render``'s channels and chunk count into ``renders``
    (and its buffer into ``buffers``)."""
    from unittest import mock

    from pagnerf_tpu_torch.train.trainer import PanopticTrainer
    batch_render = PanopticTrainer.batch_render

    def spy(self, rays, channels, *args, **kwargs):
        rb = batch_render(self, rays, channels, *args, **kwargs)
        renders.append((tuple(sorted(channels)), len(self.last_render)))
        if buffers is not None:
            buffers.append(rb)
        return rb

    with mock.patch.object(PanopticTrainer, "batch_render", spy):
        yield


def phase_render_views(dev, ckpt):
    """``cli.main`` with ``--pretrained`` the cli phase's final checkpoint
    and ``--render-views`` at the tuned config's full width: every view's
    rgb, depth, semantics and instance PNG, each read back with
    ``data/image_io.read_png`` equal to the returned frame; launch counts
    set to 0 before and read after: one dual encode per rendered chunk, none
    with idx/bary, nothing else. One view's render through the kernels
    against the same view through the plain encodes, at the ``validate``
    phase's tolerance (channels 1e-2, depth 1e-2 of its largest value).
    The command's wall, ``render_orbit``'s wall per view (render, colours,
    PNGs) and timed single-view renders."""
    from unittest import mock

    import numpy as np
    import torch

    from pagnerf_tpu_torch import cli
    from pagnerf_tpu_torch.app import orbit_renderer
    from pagnerf_tpu_torch.data.image_io import read_png
    from pagnerf_tpu_torch.ops import permuto_encoding as pe

    root = app_root("render_views")
    out_dir = os.path.join(root, "views")
    argv = APP_ARGV + ["--device", dev.type, "--log-dir", os.path.join(root, "logs"),
                       "--pretrained", ckpt, "--render-views", "--render-views-dir", out_dir]
    trainers, renders = [], []
    get_modules = cli.get_modules_from_config

    def modules_spy(*args, **kwargs):
        out = get_modules(*args, **kwargs)
        trainers.append(out[2])
        return out

    render_orbit, orbit_s = orbit_renderer.render_orbit, []

    def orbit_spy(*args, **kwargs):
        t = time.perf_counter()
        out = render_orbit(*args, **kwargs)
        torch.cuda.synchronize()
        orbit_s.append(time.perf_counter() - t)
        return out

    _reset_launches()
    t0 = time.perf_counter()
    with render_spy(renders), mock.patch.object(cli, "get_modules_from_config", modules_spy), \
         mock.patch.object(orbit_renderer, "render_orbit", orbit_spy):
        frames = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, idx_bary = _launches(), _idx_bary_launches()
    trainer = trainers[0]
    ds = trainer.dataset
    views = sorted(set(ds.train_idxs.tolist()) | set(ds.val_idxs.tolist()))
    expected = expected_render_launches(renders)
    fields = dict(config=CLI_CONFIG, views=len(views), image=list(ds.img_shape),
                  channels=sorted(frames), wall_s=wall, render_orbit_s=orbit_s[0],
                  ms_per_view=orbit_s[0] * 1e3 / len(views),
                  launches=launches, expected_launches=expected,
                  launches_with_idx_bary=idx_bary,
                  chunks_per_view=sorted({c for _, c in renders}))

    def fail(msg):
        emit("render_views", ok=False, **fields)
        raise AssertionError(msg)

    if sorted(frames) != ["depth", "instance", "rgb", "semantics"] or any(
            len(fl) != len(views) for fl in frames.values()):
        fail(f"frames {({k: len(v) for k, v in frames.items()})} for {len(views)} views")
    bad = [f"{ch}_{v:04d}" for ch, fl in frames.items() for v, img in zip(views, fl)
           if img.shape[:2] != tuple(ds.img_shape) or not np.array_equal(
               read_png(os.path.join(out_dir, f"{ch}_{v:04d}.png")), img)]
    if bad:
        fail(f"PNGs that do not hold their returned frame: {bad[:8]}")
    if launches != expected or any(idx_bary.values()) or len(renders) != len(views):
        fail(f"--render-views launched {launches} (idx/bary {idx_bary}), expected {expected}")

    # one view through the kernels and through the plain encodes
    view, kernel_rb, plain_rb = views[0], [], []
    with render_spy([], kernel_rb):
        img_k = orbit_renderer.render_channels_for_view(trainer, view)
    with render_spy([], plain_rb), \
         mock.patch.object(pe, "fused_encode", pe.encode_plain), \
         mock.patch.object(pe, "fused_encode_dual", pe.dual_encode_plain):
        img_p = orbit_renderer.render_channels_for_view(trainer, view)
    chans = ("rgb", "depth", "semantics", "inst_embedding")
    d_max = plain_rb[0].depth.abs().max().item()
    errs = {ch: (getattr(kernel_rb[0], ch).float() - getattr(plain_rb[0], ch).float()
                 ).abs().max().item() for ch in chans}
    tols = {ch: 1e-2 * (d_max if ch == "depth" else 1.0) for ch in chans}
    fields.update(vs_plain_view=view, vs_plain_max_abs_err=errs, vs_plain_tol=tols,
                  vs_plain_differing_pixels={k: int((img_k[k] != img_p[k]).any(-1).sum())
                                             for k in ("rgb", "depth", "semantics",
                                                       "instance")})
    if not all(errs[ch] <= tols[ch] for ch in chans):
        fail(f"view {view} through the kernels vs the plain encodes: {errs}")
    per_view = []
    for v in views[:5]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        orbit_renderer.render_channels_for_view(trainer, v)
        torch.cuda.synchronize()
        per_view.append((time.perf_counter() - t) * 1e3)
    fields.update(render_channels_for_view_ms=per_view)
    emit("render_views", **fields)
    torch.cuda.empty_cache()
    return launches


def restored_trainer(dev, ckpt):
    """The tuned config's trainer at ``APP_ARGV`` with one more epoch, the
    cli phase's final checkpoint restored."""
    from pagnerf_tpu_torch.config.config import parse_options
    from pagnerf_tpu_torch.config.factory import get_modules_from_config
    from pagnerf_tpu_torch.train import checkpoint

    _, _, trainer = get_modules_from_config(parse_options(APP_ARGV + ["--epochs", "5"]), dev)
    checkpoint.load_checkpoint(ckpt, trainer, "full")
    return trainer


def phase_viewer(dev, trainer):
    """The viewer (``app/viewer_server.make_server``) on the restored
    trainer, served from a thread on 127.0.0.1: the page, ``/api/info``,
    each channel's ``/api/frame`` (the first request renders the view: cold,
    then cached ms), ``/api/free_frame`` and ``/api/click``, each PNG read
    back equal to the array it came from; then ``POST /api/train?epochs=1``
    polled to its end: the epoch advanced by 1, the frame changed, and the
    launches those steps imply (counts set to 0 before the request and read
    after the epoch); ``/api/stop``. Any failed request fails the phase."""
    import json
    import threading
    import urllib.request

    import numpy as np
    import torch

    from pagnerf_tpu_torch.app.viewer_server import CHANNELS, make_server
    from pagnerf_tpu_torch.data.image_io import read_png

    root = app_root("viewer")
    server, state = make_server(trainer, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    fields = dict(config=CLI_CONFIG, image=list(trainer.dataset.img_shape))

    def fail(msg):
        emit("viewer", ok=False, **fields)
        raise AssertionError(msg)

    def get(path, method="GET"):
        t = time.perf_counter()
        req = urllib.request.Request(base + path, method=method)
        with urllib.request.urlopen(req, timeout=600) as r:
            body, ctype, code = r.read(), r.headers.get("Content-Type"), r.status
        if code != 200:
            fail(f"{method} {path}: {code}")
        return body, ctype, (time.perf_counter() - t) * 1e3

    def png(body, want, what):
        path = os.path.join(root, "frame.png")
        with open(path, "wb") as f:
            f.write(body)
        img = read_png(path)
        if not np.array_equal(img, want):
            fail(f"{what}: the PNG does not hold the rendered array")
        return img

    try:
        page, ctype, _ = get("/")
        if "text/html" not in ctype or b"pagnerf_tpu_torch viewer" not in page:
            fail("the page")
        info = json.loads(get("/api/info")[0])
        if (info["views"] != state.views or info["epoch"] != trainer.epoch
                or info["total_epochs"] != trainer.cfg.epochs or info["training"]):
            fail(f"/api/info {info}")
        view = info["views"][0]
        renders = []
        _reset_launches()
        with render_spy(renders):
            frame_ms = {}
            for ch in CHANNELS:
                body, ctype, cold = get(f"/api/frame?view={view}&channel={ch}")
                png(body, state.frame(view, ch), f"frame {ch}")
                frame_ms[ch] = {"first": cold,
                                "cached": get(f"/api/frame?view={view}&channel={ch}")[2]}
            free = "/api/free_frame?az=30&el=20&r=2.2&channel="
            free_ms = {"first": get(free + "rgb")[2]}
            body, _, free_ms["cached"] = get(free + "rgb")
            png(body, state.free_frame(30.0, 20.0, 2.2, "rgb"), "free frame")
            png(get(free + "depth")[0], state.free_frame(30.0, 20.0, 2.2, "depth"),
                "free depth")
            h, w = trainer.dataset.img_shape
            body, _, click_ms = get(f"/api/click?view={view}&y={h // 2}&x={w // 3}")
            png(body, state.click(view, h // 2, w // 3), "click")
        torch.cuda.synchronize()
        render_launches = _launches()
        fields.update(view=view, renders=renders, render_launches=render_launches,
                      frame_ms=frame_ms, free_frame_ms=free_ms, click_ms=click_ms)
        if len(renders) != 2 or render_launches != expected_render_launches(renders):
            fail(f"the view and the free pose launched {render_launches} for {renders}")

        # train while viewing
        before = {k: v.copy() for k, v in state.channels_for_view(view).items()}
        epoch, steps, prunes = trainer.epoch, [], []
        train_step, prune = trainer.train_step, trainer.prune

        def step_spy(stage, batch, *args, **kwargs):
            steps.append({"channels": sorted(stage.channels),
                          "cam_idx": batch["cam_idx"].tolist()})
            return train_step(stage, batch, *args, **kwargs)

        def prune_spy(*args, **kwargs):
            prunes.append(kwargs)
            return prune(*args, **kwargs)

        trainer.train_step, trainer.prune = step_spy, prune_spy
        _reset_launches()
        t0 = time.perf_counter()
        if not json.loads(get("/api/train?epochs=1", "POST")[0])["started"]:
            fail("POST /api/train did not start")
        while json.loads(get("/api/info")[0])["training"]:
            time.sleep(0.25)
        train_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _launches()
        del trainer.train_step, trainer.prune
        anchor = trainer.pipeline.anchor_mask.cpu().numpy()
        expected = cli_launches(steps, anchor, [], len(prunes),
                                max(1, trainer.cfg.prune_samples_per_cell)
                                * math.ceil(trainer.occ.res ** 3 / 65536))
        info = json.loads(get("/api/info")[0])
        png(get(f"/api/frame?view={view}&channel=rgb")[0], state.frame(view, "rgb"),
            "frame after the epoch")
        after = state.channels_for_view(view)
        changed = {k: float(np.abs(after[k].astype(np.float64) - before[k]).max())
                   for k in before}
        fields.update(train_wall_s=train_wall, steps=len(steps), prunes=len(prunes),
                      train_launches=launches, expected_train_launches=expected,
                      losses=info["losses"], frame_max_change=changed)
        if trainer.epoch != epoch + 1 or info["epoch"] != epoch + 1:
            fail(f"the epoch went from {epoch} to {trainer.epoch}")
        if not info["losses"] or not all(np.isfinite(v) for v in info["losses"].values()):
            fail(f"the epoch's losses {info['losses']}")
        if launches != expected or not (launches["table_grad"] + launches["dual_table_grad"]):
            fail(f"the epoch launched {launches}, expected {expected}")
        if not any(changed.values()):
            fail("the view's channels did not change after the epoch")
        if json.loads(get("/api/stop", "POST")[0]) != {"stopping": True}:
            fail("POST /api/stop")
    finally:
        server.shutdown()
        server.server_close()
    emit("viewer", **fields)
    return {k: render_launches[k] + launches[k] for k in launches}


def rel_err(a, b):
    """max |a - b| / max(1, |b|), on the host."""
    import torch
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float(((a - b).abs() / torch.clamp(b.abs(), min=1.0)).max())


def phase_optimizers(dev, trainer):
    """From the restored state, one full-width training step of the
    restored epoch's stage with each optimizer the flags build
    (``--optimizer-type sgd``, ``rmsprop``, ``adam --weight-decay 1e-6``;
    a fresh state each): the card's update applied again on the CPU to
    copies of the parameters and state, from the card's own gradients
    (1e-6 relative); then a non-finite gradient leaves parameters and
    state bit-equal. Then one decoder forward at full width (the colour
    decoder's widths over a microbatch's N samples) per activation (``sin``,
    ``selu``, ``gelu``), card against CPU: the activation on the same
    pre-activations within 4 float32 ulp of the larger of output and input
    (CUDA's ``sinf`` / ``tanhf`` within 2 ulp, the CPU's within 1; gelu's
    ``1 + tanh`` cancels where tanh saturates), the decoder within 1e-5 of
    its largest output."""
    import torch

    from pagnerf_tpu_torch.config.config import parse_options
    from pagnerf_tpu_torch.config.factory import optimizer_config_from_args
    from pagnerf_tpu_torch.models.decoder import BasicDecoder
    from pagnerf_tpu_torch.train.optimizer import MOMENTS, MaskedOptimizer

    saved = {n: p.detach().clone() for n, p in trainer.params.items()}
    restored_opt = (trainer.opt_cfg, trainer.opt)
    stage = trainer.stage_for_epoch(trainer.epoch)
    fields, ok = dict(config=CLI_CONFIG, stage=stage.label, kinds={}), True
    for name, flags in (("sgd", ["--optimizer-type", "sgd"]),
                        ("rmsprop", ["--optimizer-type", "rmsprop"]),
                        ("adamw", ["--optimizer-type", "adam", "--weight-decay", "1e-6"])):
        with torch.no_grad():
            for n, p in trainer.params.items():
                p.copy_(saved[n])
        trainer.opt_cfg = dataclasses.replace(
            optimizer_config_from_args(parse_options(APP_ARGV + flags)),
            num_epochs=trainer.cfg.epochs, steps_per_epoch=trainer.steps_per_epoch)
        trainer.opt = opt = MaskedOptimizer(trainer.opt_cfg, trainer.params)
        keys = MOMENTS[opt.cfg.optimizer_type]
        host = {n: p.detach().cpu().clone() for n, p in trainer.params.items()}
        host_opt = MaskedOptimizer(opt.cfg, host)
        seen = {}
        update = opt.update

        def spy(grads, frozen_fn=None, clip_norm=0.0):
            seen.update(grads={n: None if g is None else g.detach().clone()
                               for n, g in grads.items()}, frozen=frozen_fn, clip=clip_norm)
            return update(grads, frozen_fn, clip_norm)

        opt.update = spy
        batch = trainer.dataset.sample_batch(
            trainer.rng, trainer.cfg.batch_size, trainer.cfg.num_rays_sampled_per_img,
            "val" if stage.training_val_poses else "train")
        t0 = time.perf_counter()
        losses = trainer.train_step(stage, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        del opt.update
        applied = bool(host_opt.update({n: None if g is None else g.cpu()
                                        for n, g in seen["grads"].items()},
                                       seen["frozen"], seen["clip"]))
        errs = {"params": max(rel_err(p, host[n]) for n, p in trainer.params.items())}
        for key in keys:
            errs[key] = max(rel_err(t, getattr(host_opt, key)[n])
                            for n, t in getattr(opt, key).items())
        # a non-finite gradient: nothing moves
        bad = {n: g for n, g in seen["grads"].items()}
        first = next(n for n, g in bad.items() if g is not None)
        bad[first] = bad[first].clone()
        bad[first].view(-1)[0] = float("nan")
        before = ({n: p.clone() for n, p in trainer.params.items()}, dict(opt.count),
                  {k: {n: t.clone() for n, t in getattr(opt, k).items()} for k in keys})
        skipped = not bool(opt.update(bad, seen["frozen"], seen["clip"]))
        unchanged = (all(torch.equal(p, before[0][n]) for n, p in trainer.params.items())
                     and opt.count == before[1]
                     and all(torch.equal(getattr(opt, k)[n], t) for k in keys
                             for n, t in before[2][k].items()))
        fields["kinds"][name] = dict(
            kind=opt.kind, applied=applied, counts_equal=opt.count == host_opt.count,
            rel_err=errs, step_ms=step_ms, losses={k: float(v) for k, v in losses.items()},
            nonfinite_skipped=skipped, nonfinite_unchanged=unchanged)
        ok &= (applied and opt.count == host_opt.count and skipped and unchanged
               and all(e <= 1e-6 for e in errs.values()))

    dec0 = trainer.pipeline.nef.decoder_color
    n = trainer.cfg.num_rays_sampled_per_img * trainer.pipeline.tracer_cfg.num_steps
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(dec0.hidden_0.kernel.shape[0], n, generator=gen)
    fields["activations"] = {}
    for act in ("sin", "selu", "gelu"):
        dec = BasicDecoder(x.shape[0], dec0.lout.kernel.shape[1], dec0.hidden_0.kernel.shape[1],
                           dec0.num_layers, activation=act, compute_dtype=dec0.compute_dtype)
        dec.reset_parameters(torch.Generator().manual_seed(8))
        pre = (torch.randn(dec0.hidden_0.kernel.shape[1], n, generator=gen) * 3).to(
            dec0.compute_dtype)
        want, got = dec.act(pre).float(), dec.act(pre.to(dev)).float().cpu()
        # ulps of the larger of output and input: gelu's 1 + tanh cancels
        # where tanh saturates, so an ulp of tanh there is one of the input
        scale = torch.maximum(want.abs(), pre.float().abs()).clamp(min=2.0 ** -126)
        ulp = 2.0 ** -23 * torch.exp2(torch.floor(torch.log2(scale)))
        with torch.no_grad():
            out_h = dec(x)
            out_c = dec.to(dev)(x.to(dev)).cpu()
        act_ulps = float(((got - want).abs() / ulp).max())
        dec_err = float((out_c - out_h).abs().max())
        tol = 1e-5 * float(out_h.abs().max())
        fields["activations"][act] = dict(n=n, activation_max_ulps=act_ulps,
                                          decoder_max_abs_err=dec_err, decoder_tol=tol)
        ok &= act_ulps <= 4 and dec_err <= tol
    with torch.no_grad():                   # back to the restored state
        for n, p in trainer.params.items():
            p.copy_(saved[n])
    trainer.opt_cfg, trainer.opt = restored_opt
    if not ok:
        emit("optimizers", ok=False, **fields)
        raise AssertionError(f"an optimizer or activation on the card vs the CPU: {fields}")
    emit("optimizers", **fields)


def phase_hp_sweep(dev):
    """``python -m pagnerf_tpu_torch.main_hp_tunning`` on the tuned config:
    two learning rates, rungs of 1 epoch, 2 rungs, 2 worker processes on
    the card at once (the workers' lifetimes overlap). The results file
    has 2 + 1 entries, all scored; the rung-1 trial resumed from its
    rung-0 checkpoint (epoch 2 reached). Each worker's wall, peak memory
    and launches (``<trial>_epoch<n>.worker.json``)."""
    import subprocess

    import numpy as np

    out = app_root("hp_sweep")
    cmd = [sys.executable, "-m", "pagnerf_tpu_torch.main_hp_tunning", "--config",
           os.path.join(ROOT, CLI_CONFIG), "--out-dir", out, "--space",
           '{"lr": [0.001, 0.005]}', "--rung-epochs", "1", "--num-rungs", "2",
           "--num-workers", "2", "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    fields = dict(config=CLI_CONFIG, command=" ".join(cmd[1:]), rc=proc.returncode,
                  wall_s=wall)

    def fail(msg):
        emit("hp_sweep", ok=False, stderr=proc.stderr[-3000:], **fields)
        raise AssertionError(msg)

    if proc.returncode != 0:
        fail(f"the sweep exited with {proc.returncode}")
    with open(os.path.join(out, "sweep_results.json")) as f:
        results = json.load(f)
    workers = {}
    for path in sorted(glob.glob(os.path.join(out, "*.worker.json"))):
        with open(path) as f:
            workers[os.path.basename(path)[:-len(".worker.json")]] = json.load(f)
    fields.update(results=[{k: r[k] for k in ("trial", "rung", "config", "metric", "wall")}
                           for r in results], workers=workers)
    rung0 = [r["trial"] for r in results if r["rung"] == 0]
    rung1 = [r["trial"] for r in results if r["rung"] == 1]
    if len(rung0) != 2 or len(rung1) != 1 or rung1[0] not in rung0:
        fail(f"results {fields['results']}")
    if not all(r["metric"] is not None and np.isfinite(r["metric"]) for r in results):
        fail("a trial failed or scored a non-finite metric")
    first = [workers.get(f"{t}_epoch1") for t in rung0]
    last = workers.get(f"{rung1[0]}_epoch2")
    if None in first or last is None:
        fail(f"worker records {sorted(workers)}")
    if not max(w["start"] for w in first) < min(w["end"] for w in first):
        fail("the two rung-0 workers did not run at the same time")
    if last["epoch"] != 2 or last["resumed_epoch"] != 1:
        fail(f"the rung-1 trial did not resume from rung 0: {last}")
    on_card = dev.type == "cuda"
    if not all(w["device"] == ("cuda:0" if on_card else "cpu") and (not on_card or (
            w["launches"]["encode"] and w["launches"]["table_grad"]))
            for w in first + [last]):
        fail("a worker did not train on its device through the kernels")
    emit("hp_sweep", **fields)
    return {k: sum(w["launches"].get(k, 0) for w in workers.values()) for k in _launches()}


BUP20_CONFIG = "configs/bup20/best.yaml"
# a quarter of BUP20's 1280x720 per side
BUP20_SIZE = (320, 180)
# only the schedule's milestones move: epoch 0 dense RGB on the ray march,
# epochs 1-2 the panoptic heads (the val poses train every 10th epoch from
# 1, so none here); the periodic validation (valid_every 100) after the
# last epoch, at val_mip 2; then the final checkpoint and the final
# validation, at mip 0 as best.yaml makes it (it sets no low_res_val)
BUP20_FLAGS = ["--epochs", "3", "--sem-epoch-start", "1", "--inst-epoch-start", "1",
               "--valid-every", "3"]


def bup20_loader_at_full_size(root, size=(1280, 720)):
    """A 1280x720 BUP20 tree (every PNG row Paeth-filtered, the slowest
    rows to decode) and the walls of the port's readers on it: one RGB
    and one depth frame, and the window's files of best.yaml's eval frame
    (both subsets: RGB, depth, predictions with the depth filter, the
    centre's COCO masks)."""
    import shutil

    from pagnerf_tpu_torch.data.bup20_tree import SEQUENCE, write_bup20_tree
    from pagnerf_tpu_torch.data.formats.agrobot_base import BUP20SequenceDataset
    from pagnerf_tpu_torch.data.image_io import read_png

    shutil.rmtree(root, ignore_errors=True)
    tree = os.path.join(root, "BUP_20")
    t = time.perf_counter()
    stamps = write_bup20_tree(tree, *size, supersample=1, paeth=True,
                              predictions=("mask2former",))
    out = {"size": list(size), "write_s": time.perf_counter() - t}
    frame = os.path.join(tree, SEQUENCE, f"{stamps[47]}.png")
    t = time.perf_counter()
    read_png(frame, "RGB")
    out["rgb_decode_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    read_png(os.path.join(tree, SEQUENCE, "depth", os.path.basename(frame)))
    out["depth_decode_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    frames = []
    for sub in ("train", "val"):
        ds = BUP20SequenceDataset(os.path.join(tree, "BUP_20.json"), subset=sub,
                                  preds_rel_path="preds_mask2former", max_depth=1.4)
        frames += ds[5]
    out.update(window_files_s=time.perf_counter() - t, window_frames=len(frames))
    del frames
    shutil.rmtree(root, ignore_errors=True)
    return out


def phase_bup20(dev, flush, card):
    """Main path 7: the flagship's own config, ``configs/bup20/best.yaml``,
    through ``cli.main`` over a BUP20-format tree of the synthetic scene
    (``data/bup20_tree.py``: 90 frames at 320x180, a quarter of BUP20's
    1280x720 per side; COCO polygons and RLE, image sets, 8-bit RGB and
    16-bit depth PNGs, params.yaml, odometry, Mask2Former pickles) under
    ``pagnerf_tpu_torch/_build/bup20``. First ``--validate-dataset`` (and
    ``--validate-dataset-deep``) must report 0 errors, and at least one on
    a copy with a depth frame deleted. Then ``cli.main`` trains best.yaml
    at its full width (24 LoDs x 2^18 x F=2, main and delta grid, hidden
    64, 512 ray-march steps, 4096 rays x batch 6, max_depth 1.4, so the
    predictions are depth-filtered), only the epochs and the stage starts
    moved (``BUP20_FLAGS``): RGB and panoptic steps, a validation at
    val_mip 2 (80x45) and the final one at mip 0 (320x180), the sizes
    read from what ``get_images`` returned. Launch counts set to 0 before
    and read after: those the steps' cameras and the validation chunks
    imply. Each kernel at each N the run gave it, the validation's
    encodes (no idx/bary) at each chunk's N too, is held against its plain
    version (``recorded_kernel_checks``). The loader's wall, the step wall
    and rays/s per stage, each validation's wall and the metrics. Last,
    the port's readers at BUP20's full size
    (``bup20_loader_at_full_size``)."""
    import io
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from pagnerf_tpu_torch import cli
    from pagnerf_tpu_torch.config import factory
    from pagnerf_tpu_torch.config.config import parse_options
    from pagnerf_tpu_torch.data.bup20_tree import SEQUENCE, write_bup20_tree
    from pagnerf_tpu_torch.data.multiview import MultiviewDataset
    from pagnerf_tpu_torch.quality_run import read_perf, summary

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    root = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", "bup20")
    shutil.rmtree(root, ignore_errors=True)
    tree = os.path.join(root, "data", "BUP_20")
    t = time.perf_counter()
    write_bup20_tree(tree, *BUP20_SIZE)
    fields = dict(config=BUP20_CONFIG, flags=" ".join(BUP20_FLAGS), card=card,
                  tree=os.path.relpath(tree, ROOT), size=list(BUP20_SIZE),
                  tree_write_s=time.perf_counter() - t)

    def fail(msg):
        emit("bup20", ok=False, **fields)
        raise AssertionError(msg)

    # the validator: 0 errors on the tree, at least one on a broken copy
    base = ["--config", os.path.join(ROOT, BUP20_CONFIG), "--dataset-path", tree]

    def validate_(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            n = cli.main(argv + ["--validate-dataset"])
        return n, buf.getvalue().strip().splitlines()[-1]

    broken = os.path.join(root, "broken", "BUP_20")
    shutil.copytree(tree, broken)
    os.unlink(sorted(glob.glob(os.path.join(broken, SEQUENCE, "depth", "*.png")))[3])
    checks = {"tree": validate_(base), "tree_deep": validate_(base + ["--validate-dataset-deep"]),
              "broken": validate_(["--config", os.path.join(ROOT, BUP20_CONFIG),
                                   "--dataset-path", broken])}
    shutil.rmtree(os.path.dirname(broken))
    fields["validate"] = {k: {"errors": n, "report": line} for k, (n, line) in checks.items()}
    if checks["tree"][0] or checks["tree_deep"][0] or checks["broken"][0] < 1:
        fail(f"--validate-dataset: {checks}")

    # training best.yaml over the tree
    log_root = os.path.join(root, "runs")
    argv = base + ["--device", "cuda", "--log-dir", log_root, "--perf",
                   "--exp-name", "train"] + BUP20_FLAGS
    args = parse_options(cli.split_device(argv)[1])
    trainers, renders, calls, pack_totals, loads, images = [], [], {}, {}, [], []
    load_dataset, get_images = factory.load_dataset, MultiviewDataset.get_images

    def load_spy(args):
        t_ = time.perf_counter()
        ds = load_dataset(args)
        loads.append(time.perf_counter() - t_)
        return ds

    def images_spy(self, split="val", mip=0):
        out = get_images(self, split, mip)
        images.append((split, mip, tuple(out["imgs"].shape[:3])))
        return out

    _reset_launches()
    t0 = time.perf_counter()
    with recorded_run(calls, trainers, renders, pack_totals, no_grad=True), \
            mock.patch.object(factory, "load_dataset", load_spy), \
            mock.patch.object(MultiviewDataset, "get_images", images_spy):
        final = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    trainer = trainers[0]
    run_dir, records = read_perf(log_root, "train")
    anchor = trainer.pipeline.anchor_mask.cpu().numpy()
    summ = summary(records, pack_totals)
    steps = [r for r in records if r["name"] == "train_step"]
    expected = cli_launches(steps, anchor, renders, 0, 0)
    rays_per_step = trainer.cfg.num_rays_sampled_per_img * trainer.cfg.batch_size
    stages = {k: dict(v, rays_per_s=(rays_per_step / (v["median_ms"] / 1e3)
                                     if v["median_ms"] else None))
              for k, v in summ["stages"].items()}
    epochs = [{"epoch": r["epoch"], "s": r["ms"] / 1e3, "losses": r["losses"],
               "stages": sorted({s_["stage"] for s_ in steps if s_["epoch"] == r["epoch"]})}
              for r in records if r["name"] == "epoch"]
    data = trainer.dataset.data
    fields.update(
        loader_s=loads[0], frames=int(data["imgs"].shape[0]),
        train_frames=len(trainer.dataset.train_idxs), val_frames=len(trainer.dataset.val_idxs),
        wall_s=wall, epochs=epochs, stages=stages, validations=summ["validations"],
        val_mip=trainer.cfg.val_mip, validated_images=images, launches=launches,
        expected_launches=expected,
        peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        final_metrics=final, recorded_calls=sorted(f"{k}@{n}" for k, n in calls),
        width={k: getattr(args, k) for k in (
            "num_lods", "capacity_log_2", "delta_capacity_log_2", "feature_dim", "hidden_dim",
            "num_steps", "num_rays_sampled_per_img", "batch_size", "max_depth", "val_mip",
            "nef_type", "multiview_dataset_format")},
        preds_kept_share=float((data["instance_pred"] > 0).mean()))
    if [e["stages"] for e in epochs] != [["ray_dense_rgb"], ["ray_dense_panoptic"],
                                         ["ray_dense_panoptic"]]:
        fail(f"the 3 epochs ran the stages {[e['stages'] for e in epochs]}")
    if launches != expected:
        fail(f"cli.main launched {launches}, expected {expected}")
    if not all(launches[k] for k in ("encode", "dual_encode", "table_grad",
                                     "dual_table_grad", "dbary")):
        fail("a kernel of the path was not launched")
    if not all(np.isfinite(v) for e in epochs for v in e["losses"].values()):
        fail("a loss is not finite")
    if not (all(np.isfinite(v) for v in final.values())
            and {"val/psnr", "val/iou", "val/pq_things", "val/map"} <= set(final)):
        fail("final metrics not finite or incomplete")
    # a validation at val_mip 2 and the final one at mip 0, as rendered
    w, h = BUP20_SIZE
    want_images = [("val", 2, (len(trainer.dataset.val_idxs), h // 4, w // 4)),
                   ("val", 0, (len(trainer.dataset.val_idxs), h, w))]
    if trainer.cfg.val_mip != 2 or images != want_images:
        fail(f"validated {images}, expected {want_images}")
    # each validation image in chunks of render_batch rays, the last one shorter
    rbatch, steps_ = trainer.cfg.render_batch, trainer.pipeline.tracer_cfg.num_steps
    chunk_ns = {rays_ * steps_ for _, _, (_, hh, ww) in images
                for rays_ in ([rbatch] * (hh * ww // rbatch) + [hh * ww % rbatch]) if rays_}
    chunks = [-(-hh * ww // rbatch) for _, _, (nn, hh, ww) in images for _ in range(nn)]
    if [r[1] for r in renders] != chunks:
        fail(f"validation renders {renders}, expected chunks {chunks}")

    # every kernel of the path at each N it ran at, against plain
    spec = trainer.pipeline.nef.grid.spec
    dense_n = trainer.cfg.num_rays_sampled_per_img * steps_
    fields.update(dense_N=dense_n, validation_N=sorted(chunk_ns))
    want = [(kind, dense_n) for kind in ("encode", "dual_encode", "table_grad",
                                         "dual_table_grad", "dbary")]
    want += [("dual_encode" + NO_IDX_BARY, n) for n in chunk_ns]
    if set(want) - set(calls):
        fail(f"no call was recorded at {sorted(set(want) - set(calls))}")
    del trainer, trainers, data
    checks, times = recorded_kernel_checks(spec, calls, dev, flush)
    calls.clear()
    fields.update(kernel_checks=checks, kernel_times=times)
    if not all(ch["ok"] for by_n in checks.values() for ch in by_n.values()):
        fail(f"a kernel at one of this path's N outside its tolerance: {checks}")
    torch.cuda.empty_cache()
    fields["full_size_loader"] = bup20_loader_at_full_size(os.path.join(root, "full"))
    emit("bup20", **fields)
    return launches, times, tree


# the other BUP20 configs, over the bup20 phase's tree: panoptic_dd and
# mean_shift with BUP20_FLAGS (phase_bup20_variant), the rest with
# SLICE_FLAGS (phase_bup20_slice)
BUP20_VARIANTS = {"panoptic_dd": "configs/bup20/panoptic_dd.yaml",
                  "mean_shift": "configs/bup20/mean_shift_contrastive.yaml",
                  "panoptic_nerf": "configs/bup20/panoptic_nerf.yaml",
                  "mean_shift_app": "configs/bup20/mean_shift_contrastive_app.yaml",
                  "semantic_nerf_app": "configs/bup20/semantic_nerf_app.yaml",
                  "panoptic_lifting_app": "configs/bup20/panoptic_lifting_app.yaml"}
TRAIN_KINDS = ("encode", "dual_encode", "table_grad", "dual_table_grad", "dbary")


def dd_alpha_gap(trainer, dev, rays=4096):
    """max |panoptic_alpha - alpha| over a render of the first training
    camera's first ``rays`` pixels with a panoptic channel."""
    import torch

    from pagnerf_tpu_torch.core.rays import Rays

    ds = trainer.dataset
    o = torch.as_tensor(ds.data["base_rays_origins"].reshape(-1, 3)[:rays], device=dev)
    d = torch.as_tensor(ds.data["base_rays_dirs"].reshape(-1, 3)[:rays], device=dev)
    rb = trainer.batch_render(Rays(origins=o, dirs=d, dist_min=0.0, dist_max=6.0),
                              {"rgb", "semantics"}, cam_idx=int(ds.train_idxs[0]))
    return float((rb.panoptic_alpha - rb.alpha).abs().max())


def contrastive_card_vs_cpu(trainer, dev):
    """A full batch (``batch_size`` images x ``num_rays_sampled_per_img``,
    seed 3) rendered microbatch by microbatch without gradients through the
    trainer's losses; the instance head's ``sup_contrastive_loss`` inputs
    of all microbatches are stacked and its loss on the card is held against
    the loss of the same tensors on the CPU (1e-4 relative)."""
    from unittest import mock

    import numpy as np
    import torch

    from pagnerf_tpu_torch.train import trainer as trainer_mod

    cfg = trainer.cfg
    stage = trainer.stage_for_epoch(trainer.epoch - 1)
    batch = trainer.dataset.sample_batch(np.random.default_rng(3), cfg.batch_size,
                                         cfg.num_rays_sampled_per_img)
    seen, loss = [], trainer_mod.sup_contrastive_loss

    def spy(features, labels, anchor_mask=None, **kw):
        if anchor_mask is not None:          # the instance loss, not contrast_sem
            seen.append((features, labels, anchor_mask, kw))
        return loss(features, labels, anchor_mask, **kw)
    with torch.no_grad(), mock.patch.object(trainer_mod, "sup_contrastive_loss", spy):
        for sub in trainer._micro_batches(batch):
            rays = sub["imgs"].shape[0] * sub["imgs"].shape[1]
            trainer.compute_losses(trainer._to_device(sub), stage,
                                   trainer.draw((rays, stage.num_steps)))
    kw = seen[0][3]
    feats, labels, mask = (torch.cat([s[i] for s in seen]) for i in range(3))
    t = time.perf_counter()
    card = float(loss(feats, labels, mask, **kw))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu = float(loss(feats.cpu(), labels.cpu(), mask.cpu(), **kw))
    cpu_s = time.perf_counter() - t
    return dict(images=int(feats.shape[0]), rays=int(feats.shape[1]),
                embedding_dim=int(feats.shape[2]), anchors=int(mask.sum()),
                loss_card=card, loss_cpu=cpu, card_s=card_s, cpu_s=cpu_s,
                rel_err=abs(card - cpu) / max(abs(cpu), 1e-30))


@contextlib.contextmanager
def clustering_walls(out):
    """While a run goes: each validation's ``train_clustering`` wall (the
    renders and the fit), the fit's host wall and its input centres and
    fitted clusters, each image's ``predict_clusters`` wall; the last
    predicted embeddings and model are kept in ``out``."""
    from unittest import mock

    from pagnerf_tpu_torch.train import validation
    from pagnerf_tpu_torch.utils import clustering

    fit_v, fit_m, predict = (validation.train_clustering, clustering.MeanShift.train_clustering,
                             clustering.MeanShift.predict_clusters)

    def fit_v_spy(*args, **kwargs):
        t = time.perf_counter()
        ms = fit_v(*args, **kwargs)
        out.setdefault("train_clustering_s", []).append(time.perf_counter() - t)
        return ms

    def fit_m_spy(self, embeddings, labels):
        t = time.perf_counter()
        fit_m(self, embeddings, labels)
        out.setdefault("fit_s", []).append(time.perf_counter() - t)
        out.setdefault("centres", []).append(
            len(clustering.mean_class_embedding(embeddings, labels)))
        out.setdefault("clusters", []).append(len(self.ms.cluster_centers_))

    def predict_spy(self, embeddings):
        t = time.perf_counter()
        ids = predict(self, embeddings)
        out.setdefault("predict_s", []).append(time.perf_counter() - t)
        out["last"] = (self, embeddings)
        return ids
    with mock.patch.object(validation, "train_clustering", fit_v_spy), \
            mock.patch.object(clustering.MeanShift, "train_clustering", fit_m_spy), \
            mock.patch.object(clustering.MeanShift, "predict_clusters", predict_spy):
        yield


def broadcast_predict(ms, embeddings):
    """The last image's prediction by the JAX package's one broadcast
    ([pixels, clusters, D] float64) against the chunked one: walls, the
    broadcast's bytes, equal ids."""
    import numpy as np

    flat = embeddings.reshape(-1, embeddings.shape[-1])
    centres = ms.ms.cluster_centers_
    t = time.perf_counter()
    chunked = ms.ms.predict(flat)
    chunked_s = time.perf_counter() - t
    t = time.perf_counter()
    full = np.argmin(np.linalg.norm(flat[:, None] - centres[None], axis=-1), axis=-1)
    broadcast_s = time.perf_counter() - t
    return dict(pixels=int(flat.shape[0]), clusters=int(centres.shape[0]),
                dim=int(flat.shape[1]), chunked_s=chunked_s, broadcast_s=broadcast_s,
                broadcast_gib=flat.shape[0] * centres.shape[0] * flat.shape[1] * 8 / 2 ** 30,
                equal=bool(np.array_equal(chunked, full)))


def phase_bup20_variant(dev, flush, card, tree, name, seen):
    """Main paths 8 and 9: ``BUP20_VARIANTS[name]`` through ``cli.main`` over
    the bup20 phase's tree at full width (24 LoDs x 2^18 x F=2, main and
    delta grid, hidden 64, 512 steps, 4096 rays x batch 6) with
    ``BUP20_FLAGS``: an RGB epoch, two panoptic epochs, a validation at mip
    2 and the final one at mip 0. Launch counts set to 0 before and read
    after: those the steps' cameras and the render chunks imply (the
    clustering's renders too). One panoptic microbatch's gradients through
    the kernels against the plain backward. 'panoptic_dd': max
    |panoptic_alpha - alpha| of a rendered batch must be > 0.
    'mean_shift': the contrastive loss of a batch on the card against the
    CPU's (1e-4 relative); each validation fits the mean shift
    (``train_clustering``) and predicts every image through it: walls,
    centres and clusters, the chunked predict against the broadcast one.
    Each kernel at the training N (this path's own idx, bary and
    cotangents) and at every (kernel, N) that no earlier phase recorded
    (``seen``) against its plain version. Finite losses and metrics."""
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from pagnerf_tpu_torch import cli
    from pagnerf_tpu_torch.data.multiview import MultiviewDataset
    from pagnerf_tpu_torch.quality_run import read_perf, summary

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    config = BUP20_VARIANTS[name]
    log_root = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", name)
    shutil.rmtree(log_root, ignore_errors=True)
    argv = ["--config", os.path.join(ROOT, config), "--dataset-path", tree, "--device",
            "cuda", "--log-dir", log_root, "--perf", "--exp-name", "train"] + BUP20_FLAGS
    trainers, renders, calls, pack_totals, images, clus = [], [], {}, {}, [], {}
    get_images = MultiviewDataset.get_images

    def images_spy(self, split="val", mip=0):
        out = get_images(self, split, mip)
        images.append((split, mip, tuple(out["imgs"].shape[:3])))
        return out

    _reset_launches()
    t0 = time.perf_counter()
    with recorded_run(calls, trainers, renders, pack_totals, no_grad=True), \
            mock.patch.object(MultiviewDataset, "get_images", images_spy), \
            clustering_walls(clus):
        final = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    trainer = trainers[0]
    run_dir, records = read_perf(log_root, "train")
    anchor = trainer.pipeline.anchor_mask.cpu().numpy()
    summ = summary(records, pack_totals)
    steps = [r for r in records if r["name"] == "train_step"]
    expected = cli_launches(steps, anchor, renders, 0, 0)
    cfg = trainer.cfg
    rays_per_step = cfg.num_rays_sampled_per_img * cfg.batch_size
    stages = {k: dict(v, rays_per_s=(rays_per_step / (v["median_ms"] / 1e3)
                                     if v["median_ms"] else None))
              for k, v in summ["stages"].items()}
    epochs = [{"epoch": r["epoch"], "s": r["ms"] / 1e3, "losses": r["losses"],
               "stages": sorted({s_["stage"] for s_ in steps if s_["epoch"] == r["epoch"]})}
              for r in records if r["name"] == "epoch"]
    nef = trainer.pipeline.nef
    fields = dict(config=config, flags=" ".join(BUP20_FLAGS), card=card,
                  nef_type=type(nef).__name__, tracer_type=trainer.pipeline.tracer_cfg.tracer_type,
                  inst_loss=cfg.inst_loss, wall_s=wall, epochs=epochs, stages=stages,
                  validations=summ["validations"], validated_images=images,
                  launches=launches, expected_launches=expected,
                  peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  final_metrics=final, recorded_calls=sorted(f"{k}@{n}" for k, n in calls))

    def fail(msg):
        emit(name, ok=False, **fields)
        raise AssertionError(msg)

    want_nef = {"panoptic_dd": "PanopticDDensityNeF", "mean_shift": "MeanShiftPanopticDeltaNeF"}
    if type(nef).__name__ != want_nef[name]:
        fail(f"the config built a {type(nef).__name__}")
    if [e["stages"] for e in epochs] != [["ray_dense_rgb"], ["ray_dense_panoptic"],
                                         ["ray_dense_panoptic"]]:
        fail(f"the 3 epochs ran the stages {[e['stages'] for e in epochs]}")
    if launches != expected:
        fail(f"cli.main launched {launches}, expected {expected}")
    if not all(launches[k] for k in TRAIN_KINDS):
        fail("a kernel of the path was not launched")
    if not all(np.isfinite(v) for e in epochs for v in e["losses"].values()):
        fail("a loss is not finite")
    if not (all(np.isfinite(v) for v in final.values())
            and {"val/psnr", "val/iou", "val/pq_things", "val/map"} <= set(final)):
        fail("final metrics not finite or incomplete")
    w, h = BUP20_SIZE
    n_val = len(trainer.dataset.val_idxs)
    want_images = [("val", 2, (n_val, h // 4, w // 4)), ("val", 0, (n_val, h, w))]
    if images != want_images:
        fail(f"validated {images}, expected {want_images}")
    # each validation: the clustering's renders (num_clustering_samples
    # pixels over the training images, at the dataset's size) first, then
    # each image in chunks of render_batch rays
    rbatch, steps_ = cfg.render_batch, trainer.pipeline.tracer_cfg.num_steps
    n_train = len(trainer.dataset.train_idxs)
    clus_rays = min(max(1, cfg.num_clustering_samples // n_train), w * h)
    clus_chunks = [-(-clus_rays // rbatch)] * n_train if name == "mean_shift" else []
    chunks = [c for _, _, (nn, hh, ww) in images
              for c in clus_chunks + [-(-hh * ww // rbatch)] * nn]
    if [r[1] for r in renders] != chunks:
        fail(f"renders {[r[1] for r in renders]}, expected chunks {chunks}")

    # one panoptic microbatch through the kernels and the plain backward
    check, ok = kernel_vs_plain_grads(trainer, trainer.stage_for_epoch(cfg.epochs - 1), dev)
    fields["grad_check"] = check
    if not ok:
        fail(f"gradients through the kernels vs the plain backward: {check}")
    if name == "panoptic_dd":
        gap = dd_alpha_gap(trainer, dev)
        fields["max_abs_panoptic_alpha_minus_alpha"] = gap
        if not gap > 0:
            fail("the DD tracer's panoptic alpha equals the colour alpha")
    else:
        fields["contrastive_card_vs_cpu"] = con = contrastive_card_vs_cpu(trainer, dev)
        if not con["rel_err"] <= 1e-4:
            fail(f"sup_contrastive on the card vs the CPU: {con}")
        last = clus.pop("last", None)
        fields["clustering"] = dict(clus, predicts=len(clus.get("predict_s", [])),
                                    predict_s_total=sum(clus.get("predict_s", [])))
        if not (len(clus.get("fit_s", [])) == 2 and last is not None
                and fields["clustering"]["predicts"] == n_val * 2
                and all(c >= 1 for c in clus["clusters"])):
            fail(f"the validations did not fit and predict the mean shift: {clus}")
        fields["predict_broadcast_vs_chunked"] = bc = broadcast_predict(*last)
        if not bc["equal"]:
            fail(f"the chunked predict differs from the broadcast one: {bc}")

    # each kernel at this path's training N and at any N no earlier phase gave it
    spec = nef.grid.spec
    dense_n = cfg.num_rays_sampled_per_img * steps_
    fields["dense_N"] = dense_n
    if set((k, dense_n) for k in TRAIN_KINDS) - set(calls):
        fail(f"no call was recorded at {sorted(set((k, dense_n) for k in TRAIN_KINDS) - set(calls))}")
    check_calls = {key: rec for key, rec in calls.items()
                   if key not in seen or (key[0] in TRAIN_KINDS and key[1] == dense_n)}
    fields["checked_calls"] = sorted(f"{k}@{n}" for k, n in check_calls)
    seen |= set(calls)
    del trainer, trainers
    calls.clear()
    checks, times = recorded_kernel_checks(spec, check_calls, dev, flush)
    check_calls.clear()
    fields.update(kernel_checks=checks, kernel_times=times)
    if not all(ch["ok"] for by_n in checks.values() for ch in by_n.values()):
        fail(f"a kernel at one of this path's N outside its tolerance: {checks}")
    torch.cuda.empty_cache()
    emit(name, **fields)
    return launches, times


# the configs of the hash, triplanar and TensoRF grids and the baselines, over
# the bup20 phase's tree: 2 epochs (RGB, then the panoptic heads), a
# validation at val_mip 2 and the final one at mip 0. The `_app` configs'
# window centre (index 10) lies beyond the tree's 6 labelled frames, so
# they are centred on its index 5, best.yaml's (frame 47). The three that
# run no kernel validate at mip 2 at the end too (`--low-res-val`): their
# final validations at mip 0 took 137 s of plain PyTorch, and the app
# phases need that time within the script's run
SLICE_FLAGS = ["--epochs", "2", "--sem-epoch-start", "1", "--valid-every", "2"]
SLICE_VARIANTS = {
    "panoptic_nerf": dict(nef="MeanShiftPanopticNeF", grid="HashGrid", clustering=True,
                          flags=["--inst-epoch-start", "1"]),
    "mean_shift_app": dict(nef="MeanShiftPanopticNeF", grid="TriplanarGrid", clustering=True,
                           flags=["--inst-epoch-start", "1", "--dataset-center-idx", "5",
                                  "--low-res-val"]),
    # its instance stage starts at 900: SemanticNeF has no instance head
    "semantic_nerf_app": dict(nef="SemanticNeF", grid=None,
                              flags=["--dataset-center-idx", "5", "--low-res-val"]),
    "panoptic_lifting_app": dict(nef="PanopticLiftingNeF", grid="TensoRFGrid",
                                 flags=["--inst-epoch-start", "1", "--dataset-center-idx", "5",
                                        "--low-res-val"]),
}
# the kernels the hash path must launch (recorded_gathers keeps a gather
# under no_grad, a validation chunk's, as "gather_val")
HASH_KINDS = ("gather", "table_grad")


def hash_launches(steps, renders, keys):
    """The launches a hash-grid ``cli.main`` run of a non-delta NeF without
    extrinsics implies: per training microbatch (one image) one gather and
    one table-gradient scatter, per rendered chunk (validation and
    clustering) one gather; nothing else."""
    expected = {k: 0 for k in keys}
    for s_ in steps:
        expected["gather"] += len(s_["cam_idx"])
        expected["table_grad"] += len(s_["cam_idx"])
    expected["gather"] += sum(chunks for _, chunks in renders)
    return expected


@contextlib.contextmanager
def recorded_gathers(calls):
    """While a run goes: the first call of the V = 8 gather, its scatter and
    dbary at each N, keyed (kind, N) with the tensors the path gave them
    (the gather's tables, idx and bary; the scatter's cotangents and
    modes). The wrappers are replaced in ``table_gather``'s namespace, where
    the hash encode and the gather's backward find them; they call the
    originals, whose launch counts the run reads."""
    from unittest import mock

    import torch

    from pagnerf_tpu_torch.ops import hash_encoding as he
    from pagnerf_tpu_torch.ops import table_gather as tg

    gather, table_grad, dbary = (tg.multilevel_table_gather, tg.multilevel_table_grad,
                                 tg.multilevel_gather_dbary)

    def keep(kind, n, make):
        if (kind, n) not in calls:
            calls[(kind, n)] = make()

    def gather_spy(tables, idx, bary, rows_used=None, modes=None):
        if idx.shape[1] == 8:
            keep("gather" if torch.is_grad_enabled() else "gather_val", idx.shape[2],
                 lambda: dict(tables=tables.detach().clone(), idx=idx.clone(),
                              bary=bary.detach().clone(), modes=modes))
        return gather(tables, idx, bary, rows_used, modes)

    def table_grad_spy(idx, bary, g, capacity, rows_used=None, modes=None):
        if idx.shape[1] == 8:
            keep("table_grad", idx.shape[2], lambda: dict(
                idx=idx.clone(), bary=bary.clone(), g=g.clone(), c=capacity, modes=modes))
        return table_grad(idx, bary, g, capacity, rows_used, modes)

    def dbary_spy(tables, idx, g):
        if idx.shape[1] == 8:
            keep("dbary", idx.shape[2], lambda: dict(tables=tables.clone(), idx=idx.clone(),
                                                     g=g.clone()))
        return dbary(tables, idx, g)

    def encode_spy(self, tables, coordsT, *args, **kwargs):
        if torch.is_grad_enabled():
            keep("coords", coordsT.shape[1], lambda: coordsT.detach().float().clone())
        return encode_t(self, tables, coordsT, *args, **kwargs)

    encode_t = he.HashEncodingSpec.encode_T
    with mock.patch.object(tg, "multilevel_table_gather", gather_spy), \
         mock.patch.object(tg, "multilevel_table_grad", table_grad_spy), \
         mock.patch.object(tg, "multilevel_gather_dbary", dbary_spy), \
         mock.patch.object(he.HashEncodingSpec, "encode_T", encode_spy):
        yield


def hash_rows(resolutions, c):
    """Rows of a hash level's table the corners can reach: min((r+1)^3, C)."""
    return [min((int(r) + 1) ** 3, c) for r in resolutions]


def hash_kernel_checks(calls, resolutions, dev, flush):
    """The V = 8 kernels on the hash path's own tensors (``recorded_gathers``)
    against their plain versions, with times, bounds and the library call's
    time: the gather single and dual (the second table random; tolerance
    16 eps_f32 of the largest table entry: 8 fused multiply-adds), at each
    recorded N with and without a gradient; the scatter single and dual (the
    path's cotangents and, same-signed, their magnitudes; the dual's second
    cotangent random; 64 eps_f32 of each entry's sum of |bary * g|) with the
    path's modes; dbary (4 eps_f32 of sum_f |g * T|); and each level's
    scatter under each accumulation mode (CUDA events). Beside the scatter's
    times, the previous design's (the per-level SHARED / GLOBAL / FLOAT plan
    whose fine levels the window mode took over; its kernels stay) on the
    same tensors in turns with the path's (previous, path, path, previous).
    ``embedding_bag`` is the gather's library call,
    ``index_add_`` the scatter's. Returns (checks, times) keyed by kernel
    name and then N."""
    import torch
    import torch.nn.functional as F

    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.profile_hash_scatter import previous_hash_modes

    gen = torch.Generator(device=dev).manual_seed(13)
    checks, times = {}, {}

    def put(name, n, ch, tm):
        checks.setdefault(name, {})[str(n)] = ch
        times.setdefault(name, {})[str(n)] = dict(N=n, **tm)

    for (kind, n), rec in sorted(calls.items()):
        if not kind.startswith("gather"):
            continue
        ta, idx, bary = rec["tables"], rec["idx"], rec["bary"]
        tb = torch.randn(ta.shape, generator=gen, device=dev)
        l, c, f = ta.shape
        rows = hash_rows(resolutions, c)
        offs = torch.arange(l, device=dev, dtype=torch.int64)[:, None, None] * c
        bag_idx = (idx.to(torch.int64) + offs).permute(0, 2, 1).reshape(l * n, 8)
        bag_w = bary.permute(0, 2, 1).reshape(l * n, 8)
        tol = 16 * F32_EPS * max(ta.abs().max().item(), tb.abs().max().item())
        for name, num in (("hash_gather_single", 1), ("hash_gather_dual", 2)):
            if num == 1:
                kern = lambda: (tg.multilevel_table_gather(ta, idx, bary),)
                plain = lambda: (tg.multilevel_gather_plain(ta, idx, bary),)
                bag_table = ta.reshape(l * c, f)
            else:
                kern = lambda: tg.dual_multilevel_table_gather(ta, tb, idx, bary)
                plain = lambda: tg.dual_gather_plain(ta, tb, idx, bary)
                bag_table = torch.cat([ta, tb], dim=2).reshape(l * c, 2 * f)
            with torch.no_grad():
                got, ref = kern(), plain()
                err = max((g_ - r_).abs().max().item() for g_, r_ in zip(got, ref))
                same = num == 1 or torch.equal(got[0], tg.multilevel_table_gather(ta, idx, bary))
                del got, ref
                lib = lambda: F.embedding_bag(bag_idx, bag_table, mode="sum",
                                              per_sample_weights=bag_w)
                bound_ms, bound_by, _, _ = gather_bound(l, c, f, n, num, 4, rows, v=8)
                pack = dict(ms_with_pack=cuda_ms(fresh_pack(kern, ta), flush=flush)) \
                    if num == 2 else {}
                tm = dict(with_grad=kind == "gather", max_abs_err=err, **pack,
                          ms=cuda_ms(kern, flush=flush),
                          plain_ms=cuda_ms(plain, reps=5, flush=flush),
                          library_ms=cuda_ms(lib, reps=5, flush=flush),
                          bound_ms=bound_ms, bound_by=bound_by)
            put(name + ("" if kind == "gather" else "_val"), n,
                dict(N=n, max_abs_err=err, tol="16 eps_f32 * max|table|", tol_value=tol,
                     dual_a_equals_single=bool(same), ok=err <= tol and bool(same)), tm)
        del tb, bag_idx, bag_w

    for (kind, n), rec in sorted(calls.items()):
        if kind != "table_grad":
            continue
        idx, bary, g, c, modes = rec["idx"], rec["bary"], rec["g"], rec["c"], rec["modes"]
        l, f = idx.shape[0], g.shape[1]
        g_b = torch.randn(g.shape, generator=gen, device=dev)
        worst, errs = {}, {}
        for label, gs in (("path", (g,)), ("same_signed", (g.abs(),)),
                          ("dual", (g, g_b))):
            got = (tg.multilevel_table_grad(idx, bary, gs[0], c, modes=modes),) \
                if len(gs) == 1 else tg.dual_multilevel_table_grad(idx, bary, *gs, c,
                                                                      modes=modes)
            w_, e_ = 0.0, 0.0
            for d_, g_ in zip(got, gs):
                diff = (d_ - tg.table_grad_plain(idx, bary, g_, c)).abs()
                tol_ = 64 * F32_EPS * tg.table_grad_plain(idx, bary.abs(), g_.abs(), c)
                w_ = max(w_, (diff / tol_.clamp(min=1e-30)).max().item())
                e_ = max(e_, diff.max().item())
                del diff, tol_
            worst[label], errs[label] = w_, e_
            del got
        rows = tg._flat_rows(idx, c)
        prev = previous_hash_modes(resolutions)
        for name, gs in (("hash_table_grad_single", (g,)), ("hash_table_grad_dual", (g, g_b))):
            vals = torch.cat([(bary[..., None] * g_.permute(0, 2, 1)[:, None]).reshape(-1, f)
                              for g_ in gs], dim=1)
            if len(gs) == 1:
                kern = lambda m=modes: tg.multilevel_table_grad(idx, bary, g, c, modes=m)
                plain = lambda: tg.table_grad_plain(idx, bary, g, c)
            else:
                kern = lambda m=modes: tg.dual_multilevel_table_grad(idx, bary, g, g_b, c,
                                                                      modes=m)
                plain = lambda: tg.dual_table_grad_plain(idx, bary, g, g_b, c)
            lib = lambda: torch.zeros((l * c, vals.shape[1]), device=dev).index_add_(0, rows, vals)
            bound_ms, bound_by, _, _ = scatter_bound(l, c, f, n, len(gs), v=8)
            w_ = max(worst["path"], worst["same_signed"]) if len(gs) == 1 else worst["dual"]
            e_ = errs["path"] if len(gs) == 1 else errs["dual"]
            turns = {"previous": [], "path": []}
            for which in ("previous", "path", "path", "previous"):
                turns[which].append(cuda_ms(lambda: kern(prev if which == "previous"
                                                         else modes), flush=flush))
            put(name, n, dict(N=n, worst_err_over_tol=w_, worst_by_cotangent=dict(worst),
                              tol="64 eps_f32 * sum|bary*g| per entry", modes=list(modes),
                              ok=w_ <= 1.0),
                dict(max_abs_err=e_, worst_err_over_tol=w_, ms=statistics.mean(turns["path"]),
                     plain_ms=cuda_ms(plain, reps=5, flush=flush),
                     library_ms=cuda_ms(lib, reps=5, flush=flush),
                     bound_ms=bound_ms, bound_by=bound_by,
                     previous_design=dict(modes=list(prev),
                                          ms=statistics.mean(turns["previous"]),
                                          turns_ms=turns)))
            del vals
        del rows
        # each level alone under each accumulation mode (CUDA events around
        # the call: its memset, event and finishing kernels)
        per_level = {}
        for mode_name, mode in (("shared", tg.SHARED), ("global", tg.GLOBAL),
                                ("float", tg.FLOAT), ("window", tg.WINDOW)):
            per_level[mode_name] = [cuda_ms(lambda lv=lv: tg.multilevel_table_grad(
                idx[lv:lv + 1], bary[lv:lv + 1], g[lv:lv + 1], c, modes=(mode,)))
                for lv in range(l)]
        per_level["path_modes"] = list(modes)
        per_level["corners"] = [(int(r) + 1) ** 3 for r in resolutions]
        times["hash_table_grad_single"][str(n)]["per_level_ms"] = per_level
        del g_b

    for (kind, n), rec in sorted(calls.items()):
        if kind != "dbary":
            continue
        tables, idx, g = rec["tables"], rec["idx"], rec["g"]
        l, c, f = tables.shape
        got = tg.multilevel_gather_dbary(tables, idx, g)
        diff = (got - tg.gather_dbary_plain(tables, idx, g)).abs()
        mag = tg.gather_dbary_plain(tables.abs(), idx, g.abs())
        w_ = (diff / (4 * F32_EPS * mag).clamp(min=1e-30)).max().item()
        err = diff.max().item()
        del got, diff, mag
        bound_ms, bound_by, _, _ = dbary_bound(l, c, f, n, hash_rows(resolutions, c), v=8)
        put("hash_gather_dbary", n,
            dict(N=n, max_abs_err=err, worst_err_over_tol=w_, ok=w_ <= 1.0,
                 tol="4 eps_f32 * sum_f |g*T| per entry"),
            dict(max_abs_err=err, ms=cuda_ms(lambda: tg.multilevel_gather_dbary(tables, idx, g),
                                            flush=flush),
                 plain_ms=cuda_ms(lambda: tg.gather_dbary_plain(tables, idx, g), reps=5,
                                  flush=flush),
                 library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
    return checks, times


def hash_encode_parts(spec, x, dev, flush):
    """Device ms of the hash encode's parts at the path's coordinates ``x``
    [3, N] (random tables): the plain-PyTorch index math (hashes and
    weights) without and with the coordinates' gradient (forward and
    backward of the weights), the gather kernel, and the whole encode
    forward and forward + backward (the table-gradient scatter; dbary and
    the weights' backward when x needs a gradient)."""
    import torch

    from pagnerf_tpu_torch.ops import hash_encoding as he
    from pagnerf_tpu_torch.ops import table_gather as tg

    l, log2 = spec.num_levels, spec.log2_table_size
    gen = torch.Generator(device=dev).manual_seed(17)
    tables = torch.randn((l, spec.capacity, spec.feature_dim), generator=gen, device=dev)
    g = torch.randn((l * spec.feature_dim, x.shape[1]), generator=gen, device=dev)
    with torch.no_grad():
        idx, w = he.hash_indices(x, spec.resolutions, log2)

    def index_grad():
        xx = x.clone().requires_grad_()
        _, ww = he.hash_indices(xx, spec.resolutions, log2)
        ww.sum().backward()

    def encode_bwd(with_x):
        t = tables.clone().requires_grad_()
        xx = x.clone().requires_grad_(with_x)
        (he.hash_encode_T(t, xx, spec.resolutions) * g).sum().backward()
    with torch.no_grad():
        parts = dict(
            N=int(x.shape[1]),
            index_math_ms=cuda_ms(lambda: he.hash_indices(x, spec.resolutions, log2), reps=5,
                                  flush=flush),
            gather_ms=cuda_ms(lambda: tg.multilevel_table_gather(tables, idx, w), flush=flush),
            encode_fwd_ms=cuda_ms(lambda: he.hash_encode_T(tables, x, spec.resolutions),
                                  reps=5, flush=flush))
    parts.update(
        index_math_fwd_bwd_ms=cuda_ms(index_grad, reps=5, flush=flush),
        encode_fwd_bwd_ms=cuda_ms(lambda: encode_bwd(False), reps=5, flush=flush),
        encode_fwd_bwd_with_x_ms=cuda_ms(lambda: encode_bwd(True), reps=5, flush=flush))
    return parts


def extrinsics_microbatch(config, flags, tree, trainer, dev):
    """One panoptic microbatch of ``config`` with the train extrinsics
    optimised (a BAPipeline, so the coordinates need a gradient and dbary
    runs at V = 8), the NeF's trained parameters from ``trainer``: its
    launches and calls (``recorded_gathers``); then another microbatch's
    gradients through the kernels against the plain backward
    (``kernel_vs_plain_grads``)."""
    import torch

    from pagnerf_tpu_torch.cli import split_device
    from pagnerf_tpu_torch.config import factory
    from pagnerf_tpu_torch.config.config import parse_options

    argv = ["--config", os.path.join(ROOT, config), "--dataset-path", tree] + flags + [
        "--optimize-extrinsics"]
    pipe, _, ba = factory.get_modules_from_config(parse_options(split_device(argv)[1]), dev)
    with torch.no_grad():
        own = dict(pipe.nef.named_parameters())
        for name, p in trainer.pipeline.nef.named_parameters():
            own[name].copy_(p)
    import numpy as np

    stage = ba.stage_for_epoch(ba.cfg.epochs - 1)
    cfg, anchor = ba.cfg, ba.pipeline.anchor_mask.cpu().numpy()
    batch = ba.dataset.sample_batch(np.random.default_rng(4), cfg.batch_size,
                                    cfg.num_rays_sampled_per_img)
    m = int(np.nonzero(~anchor[batch["cam_idx"]])[0][0])
    sub = {k: v[m:m + 1] if getattr(v, "ndim", 0) >= 1
           and v.shape[0] == batch["imgs"].shape[0] else v for k, v in batch.items()}
    calls = {}
    _reset_launches()
    with recorded_gathers(calls):
        ba.grad_step(stage, sub)
    torch.cuda.synchronize()
    launches = _launches()
    # one microbatch of a camera that is not an anchor frame: the gather, its
    # scatter and dbary once each
    want = {k: 0 for k in launches}
    want.update(gather=1, table_grad=1, dbary=1)
    check, ok = kernel_vs_plain_grads(ba, stage, dev)
    check.update(launches=launches, expected_launches=want)
    return check, ok and launches == want, calls


def phase_bup20_slice(dev, flush, card, tree, name):
    """Main paths 10-13: ``BUP20_VARIANTS[name]`` (``SLICE_VARIANTS``) through ``cli.main`` over
    the bup20 phase's tree at its config's full width with ``SLICE_FLAGS``:
    an RGB epoch, a panoptic epoch, a validation at mip 2 and the final one
    at mip 0 (at mip 2 where the variant's flags say ``--low-res-val``).
    Launch counts set to 0 before and read after: on the hash
    grid (``panoptic_nerf``) the gathers and scatters the steps' cameras
    and the render chunks imply (``hash_launches``), on the others none.
    ``panoptic_nerf`` then: one panoptic microbatch with the train
    extrinsics optimised (``extrinsics_microbatch``: dbary at V = 8,
    gradients through the kernels vs the plain backward), and each V = 8
    kernel on the path's own tensors at each N it ran at against its plain
    version (``hash_kernel_checks``). Finite losses and metrics; the
    stages, the validated sizes and the render chunks as configured."""
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from pagnerf_tpu_torch import cli
    from pagnerf_tpu_torch.data.multiview import MultiviewDataset
    from pagnerf_tpu_torch.quality_run import read_perf, summary

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spec_ = SLICE_VARIANTS[name]
    config, flags = BUP20_VARIANTS[name], SLICE_FLAGS + spec_["flags"]
    log_root = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", name)
    shutil.rmtree(log_root, ignore_errors=True)
    argv = ["--config", os.path.join(ROOT, config), "--dataset-path", tree, "--device",
            "cuda", "--log-dir", log_root, "--perf", "--exp-name", "train"] + flags
    trainers, renders, pack_totals, images, calls = [], [], {}, [], {}
    get_images = MultiviewDataset.get_images

    def images_spy(self, split="val", mip=0):
        out = get_images(self, split, mip)
        images.append((split, mip, tuple(out["imgs"].shape[:3])))
        return out

    _reset_launches()
    t0 = time.perf_counter()
    with recorded_run({}, trainers, renders, pack_totals), recorded_gathers(calls), \
            mock.patch.object(MultiviewDataset, "get_images", images_spy):
        final = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    trainer = trainers[0]
    _, records = read_perf(log_root, "train")
    summ = summary(records, pack_totals)
    steps = [r for r in records if r["name"] == "train_step"]
    hashed = spec_["grid"] == "HashGrid"
    expected = (hash_launches(steps, renders, launches) if hashed
                else {k: 0 for k in launches})
    cfg = trainer.cfg
    # per stage: the median over its steps (the first apart: it pays for
    # its allocations) of a step's ms per image, i.e. per microbatch; an
    # epoch's last step may hold fewer images than batch_size
    per_image = {}
    for i, s_ in enumerate(steps):
        if i and steps[i - 1]["stage"] == s_["stage"]:
            per_image.setdefault(s_["stage"], []).append(s_["ms"] / len(s_["cam_idx"]))
    stages = {k: dict(v, microbatch_ms=(statistics.median(per_image[k])
                                        if k in per_image else None))
              for k, v in summ["stages"].items()}
    for v in stages.values():
        v["rays_per_s"] = (cfg.num_rays_sampled_per_img / (v["microbatch_ms"] / 1e3)
                           if v["microbatch_ms"] else None)
    epochs = [{"epoch": r["epoch"], "s": r["ms"] / 1e3, "losses": r["losses"],
               "stages": sorted({s_["stage"] for s_ in steps if s_["epoch"] == r["epoch"]})}
              for r in records if r["name"] == "epoch"]
    nef = trainer.pipeline.nef
    grid = getattr(nef, "grid", None)
    fields = dict(config=config, flags=" ".join(flags), card=card,
                  nef_type=type(nef).__name__, grid_type=type(grid).__name__,
                  pipeline=type(trainer.pipeline).__name__,
                  parameters=sum(p.numel() for p in trainer.pipeline.parameters()),
                  tracer_type=trainer.pipeline.tracer_cfg.tracer_type,
                  inst_loss=cfg.inst_loss, wall_s=wall, epochs=epochs, stages=stages,
                  validations=summ["validations"], validated_images=images,
                  launches=launches, expected_launches=expected,
                  peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  final_metrics=final, recorded_calls=sorted(f"{k}@{n}" for k, n in calls))

    def fail(msg):
        emit(name, ok=False, **fields)
        raise AssertionError(msg)

    if fields["nef_type"] != spec_["nef"] or (spec_["grid"] or "NoneType") != fields["grid_type"]:
        fail(f"the config built a {fields['nef_type']} over a {fields['grid_type']}")
    if [e["stages"] for e in epochs] != [["ray_dense_rgb"], ["ray_dense_panoptic"]]:
        fail(f"the 2 epochs ran the stages {[e['stages'] for e in epochs]}")
    if launches != expected:
        fail(f"cli.main launched {launches}, expected {expected}")
    if hashed and not all(launches[k] for k in HASH_KINDS):
        fail("a kernel of the path was not launched")
    if not all(np.isfinite(v) for e in epochs for v in e["losses"].values()):
        fail("a loss is not finite")
    if not (all(np.isfinite(v) for v in final.values())
            and {"val/psnr", "val/iou"} <= set(final)):
        fail("final metrics not finite or incomplete")
    w, h = BUP20_SIZE
    n_val = len(trainer.dataset.val_idxs)
    last_val = (2, h // 4, w // 4) if "--low-res-val" in flags else (0, h, w)
    want_images = [("val", 2, (n_val, h // 4, w // 4)),
                   ("val", last_val[0], (n_val, *last_val[1:]))]
    if images != want_images:
        fail(f"validated {images}, expected {want_images}")
    # each validation: the mean shift's clustering renders first (its
    # samples over the training images, at the dataset's size), then each
    # image in chunks of render_batch rays
    rbatch, n_train = cfg.render_batch, len(trainer.dataset.train_idxs)
    clus_rays = min(max(1, cfg.num_clustering_samples // n_train), w * h)
    clus_chunks = [-(-clus_rays // rbatch)] * n_train if spec_.get("clustering") else []
    chunks = [c for _, _, (nn, hh, ww) in images
              for c in clus_chunks + [-(-hh * ww // rbatch)] * nn]
    if [r[1] for r in renders] != chunks:
        fail(f"renders {[r[1] for r in renders]}, expected chunks {chunks}")
    if not hashed:
        del trainer, trainers
        torch.cuda.empty_cache()
        emit(name, **fields)
        return launches, {}

    # dbary at V = 8 on a microbatch with the train extrinsics optimised
    check, ok, ba_calls = extrinsics_microbatch(config, flags, tree, trainer, dev)
    fields["extrinsics_microbatch"] = check
    if not ok:
        fail(f"the extrinsics microbatch: {check}")
    calls.update({k: v for k, v in ba_calls.items() if k[0] == "dbary"})
    dense_n = cfg.num_rays_sampled_per_img * trainer.pipeline.tracer_cfg.num_steps
    fields["dense_N"] = dense_n
    if {("gather", dense_n), ("table_grad", dense_n), ("dbary", dense_n)} - set(calls):
        fail(f"the path's calls at N = {dense_n} were not all recorded: {sorted(calls)}")
    resolutions = grid.spec.resolutions
    fields["resolutions"] = [int(r) for r in resolutions]
    x = calls.pop(("coords", dense_n))
    calls = {k: v for k, v in calls.items() if k[0] != "coords"}
    spec = grid.spec
    del trainer, trainers, ba_calls
    torch.cuda.empty_cache()
    # the encode's parts at the path's coordinates, beside the step's
    # microbatch (the median step over its images)
    fields["encode_parts"] = hash_encode_parts(spec, x, dev, flush)
    fields["encode_parts"]["microbatch_ms"] = {k: v["microbatch_ms"] for k, v in stages.items()}
    del x
    checks, times = hash_kernel_checks(calls, resolutions, dev, flush)
    calls.clear()
    fields.update(kernel_checks=checks, kernel_times=times)
    fields["launches_extrinsics_microbatch"] = check["launches"]
    if not all(ch["ok"] for by_n in checks.values() for ch in by_n.values()):
        fail(f"a V = 8 kernel outside its tolerance: {checks}")
    torch.cuda.empty_cache()
    emit(name, **fields)
    return dict(launches, extrinsics_microbatch=check["launches"]), times


def hash_kernel_rows(slice_paths, hash_times, sources):
    """The ``kernels`` line's rows of the V = 8 kernels (the hash grid of
    panoptic_nerf.yaml): times on its path's tensors at its microbatch's N
    (the validation chunks' N beside the gathers), launches by path."""
    by_path = {p: {k: v for k, v in c.items() if not isinstance(v, dict)}
               for p, c in slice_paths.items()}
    by_path["panoptic_nerf_extrinsics"] = slice_paths["panoptic_nerf"]["extrinsics_microbatch"]
    train_n = max(int(n) for n in hash_times["hash_table_grad_single"])
    rows = []
    for name, key, replaces in (
            ("hash_gather_single", "gather", "pagnerf_tpu/ops/pallas_gather.py:101"),
            ("hash_gather_dual", "dual_gather", "pagnerf_tpu/ops/pallas_gather.py:119"),
            ("hash_table_grad_single", "table_grad", "pagnerf_tpu/ops/pallas_scatter.py:339"),
            ("hash_table_grad_dual", "dual_table_grad", "pagnerf_tpu/ops/pallas_scatter.py:243"),
            ("hash_gather_dbary", "dbary", "pagnerf_tpu/ops/pallas_gather.py:110")):
        r = hash_times[name][str(train_n)]
        row = {
            "name": name, "route": "cuda",
            "source": sources["fwd" if name.startswith("hash_gather_") and "dbary" not in name
                              else "bwd"],
            "replaces": replaces, "verts": 8,
            "launches": sum(c[key] for c in by_path.values()),
            "launches_by_path": {p: c[key] for p, c in by_path.items()},
            "dtype": "float32",
            "shapes": f"hash grid 14 x 2^19 x F=2, V=8, panoptic_nerf microbatch N={train_n:,}",
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        }
        if name + "_val" in hash_times:
            row["validation"] = hash_times[name + "_val"]
        if "ms_with_pack" in r:
            row["redesigned"] = "one packed [L, C, 2F] row a vertex (ms: the kept copy)"
            row["ms_with_pack"] = r["ms_with_pack"]
        if "per_level_ms" in r:
            row["per_level_ms"] = r["per_level_ms"]
        if "previous_design" in r:
            row["redesigned"] = "window mode on the fine levels"
            row["previous_design"] = r["previous_design"]
        rows.append(row)
    return rows


DP_ARGV = ["--config", CLI_CONFIG] + CLI_FLAGS
# The stages of the data-parallel phase, each from the same start (a
# snapshot of the fresh trainer, restored), so the ranks' first gradients
# and losses of each stage meet the single process's on the same state:
# epoch 0 dense RGB, epoch 1 after the seed prune (ray march, packed RGB),
# epoch 2 after the real prune and the scene fixture (voxel march, packed
# layout, panoptic heads), epoch 3 a val-pose epoch.
# Last, the voxel stage again with the trace in ray_chunk blocks of
# DP_RAY_CHUNK rays: the 4096 rays of a microbatch and 512 padding rays in 3
# blocks, which the ranks' shares straddle (each block water-filled over its
# histogram summed over the ranks, ``models/tracer.py``).
DP_RAY_CHUNK = 1536
DP_BLOCKS = (("dense_rgb", [], 0, 2), ("seed_prune", [{"do": "seed_prune"}], 1, 1),
             ("voxel_packed_panoptic", [{"do": "prune"}, {"do": "fixture"}], 2, 2),
             ("val_pose", [{"do": "prune"}, {"do": "fixture"}], 3, 1),
             ("packed_ray_chunk", [{"do": "prune"}, {"do": "fixture"},
                                   {"do": "tracer", "ray_chunk": DP_RAY_CHUNK}], 2, 1))
# Bounds of the ranks against one process on the card: the losses of each
# stage's first step, from the shared state (rtol, atol), and of the steps
# after an all-reduced update (rtol); one microbatch's summed gradients (a
# share of each tensor's largest entry). Four NCCL ranks on H100s read at
# most 1.8e-7 (first losses), 2.2e-4 (later losses) and 3.4e-4
# (gradients); the control below (the RGB term without its 1/world share)
# read 0.076 (total_loss) and 0.60 (gradients), and must fail the bounds.
# The fused step must give the host loop's bits.
DP_LOSS_RTOL, DP_LOSS_ATOL, DP_STEP_RTOL, DP_GRAD_SHARE = 1e-5, 1e-6, 2e-3, 2e-3
# the kernels each stage's microbatches must launch on every rank: the
# encode and its table-gradient scatter (dual once the panoptic heads
# render), dbary for the cameras that are not anchors, the assignment in a
# panoptic stage; a val-pose step trains the extrinsics only
DP_NEED = {"dense_rgb": ("encode", "table_grad", "dbary"),
           "seed_prune": ("encode", "table_grad", "dbary"),
           "voxel_packed_panoptic": ("dual_encode", "dual_table_grad", "dbary", "lap_assign"),
           "val_pose": ("encode", "dbary"),
           "packed_ray_chunk": ("dual_encode", "dual_table_grad", "dbary", "lap_assign")}


def dp_actions() -> list:
    acts = [{"do": "snapshot"}]
    for name, prelude, epoch, steps in DP_BLOCKS:
        acts += [{"do": "restore", "block": name}] + prelude + [
            {"do": "grads", "epoch": epoch, "block": name},
            {"do": "step", "epoch": epoch, "block": name, "repeat": steps}]
    return acts


def fused_vs_host_actions(block, epoch, steps):
    """From a snapshot: the host loop twice, then the fused step, each
    ``steps`` steps on one batch sampled after the restore (so the three
    runs see the same batch and draws), ``block`` before each, the
    parameters before and after each."""
    run = {"do": "step", "epoch": epoch, "same_batch": True, "repeat": steps}
    acts = [{"do": "snapshot"}]
    for fused in (False, False, True):
        acts += [{"do": "restore"}] + block + [{"do": "params"}, dict(run, fused=fused),
                                               {"do": "params"}]
    return acts


def fused_vs_host(run, stage, steps):
    """A rank's ``fused_vs_host_actions`` run: the fused step's losses at
    every step and its parameters after them against the host loop's first
    run, bit-equal or within the host loop's own spread (its second run
    against its first: per loss or tensor, or the largest relative spread
    times this one's scale; a tensor's scale is the steps' update of it);
    the graph captured once and replayed ``steps - 1`` times. Returns (ok,
    the record)."""
    host_a, host_b, fused = [a for a in run["actions"] if a["do"] == "step"]
    p0, pa, _, pb, _, pf = [a["params"] for a in run["actions"] if a["do"] == "params"]
    diff = lambda x, y: float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
    scale = {n: max(diff(pa[n], p0[n]), 1e-30) for n in pa}
    spread = {n: diff(pb[n], pa[n]) for n in pa}
    rel = max(spread[n] / scale[n] for n in pa)
    d = {n: diff(pf[n], pa[n]) for n in pa}
    params_out = {n: [d[n], spread[n]] for n in pa if d[n] > max(spread[n], rel * scale[n])}
    triples = [(i, k, la[k], lb[k], lf[k]) for i, (la, lb, lf) in enumerate(
        zip(host_a["losses"], host_b["losses"], fused["losses"])) for k in la]
    lrel = max(abs(b - a) / max(abs(a), 1e-30) for _, _, a, b, _ in triples)
    losses_out = [t for t in triples if abs(t[4] - t[2]) > max(abs(t[3] - t[2]), lrel * abs(t[2]))]
    log = [e for e in run["fused_log"] if e["stage"] == stage]
    captured = len(log) == 1 and log[0]["capture_ms"] is not None \
        and log[0]["replays"] == steps - 1
    rec = {"rank": run["rank"], "host_spread_rel": rel, "host_loss_spread_rel": lrel,
           "params_bit_equal": sum(d[n] == 0 for n in pa), "tensors": len(pa),
           "max_rel": max(d[n] / scale[n] for n in pa),
           "losses_bit_equal": all(t[4] == t[2] for t in triples),
           "params_outside_spread": params_out, "losses_outside_spread": losses_out,
           "log": log, "step_ms": fused["ms"], "host_step_ms": [host_a["ms"], host_b["ms"]]}
    ok = captured and not params_out and not losses_out and not run["actions"][-1]["pack_overflows"]
    return ok, rec


def phase_data_parallel(dev, smi_line):
    """The ray-axis data-parallel step (``parallel/sharding.py``) at the
    tuned config's full width (24 LoDs x 2^18 x F=2, hidden 64, 4096 rays x
    5 images): on min(4, cards) cards over NCCL, or two gloo ranks on a
    lone card (the host loop). Every stage of ``DP_BLOCKS`` on every rank
    against one process on the card (``DP_*`` bounds, which a control with
    one term mis-weighted must fail), no rank's packed buffer overflowed,
    each kernel of the path launched on every rank; under NCCL the fused
    step's every step and parameters against the host loop's, its graph
    captured once and replayed; the dryrun's collective audit, the scaling
    sweep, and the host sampler's time."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pagnerf_tpu_torch import entry
    from pagnerf_tpu_torch.data import native
    from pagnerf_tpu_torch.parallel.launch import run_ranks

    cards = torch.cuda.device_count()
    world, rpd = (min(4, cards), 1) if cards >= 2 else (2, 2)
    backend = "nccl" if rpd == 1 else "gloo"
    work = tempfile.mkdtemp(prefix="dp_", dir=os.path.join(ROOT, "pagnerf_tpu_torch", "_build"))
    fields = {"card": smi_line, "world": world, "backend": backend,
              "ranks_per_card": rpd, "argv": DP_ARGV}

    def fail(msg):
        emit("data_parallel", ok=False, error=msg, **fields)
        raise SystemExit(f"data_parallel: {msg}")

    # the host sampler: the C++ draw against numpy's at 5 x 4096 of 96x72
    pool, reps = 96 * 72, 20
    native.sample_ray_indices(5, 4096, pool, 1)
    t = time.perf_counter()
    for i in range(reps):
        native.sample_ray_indices(5, 4096, pool, i)
    sampler_ms = (time.perf_counter() - t) * 1e3 / reps
    t = time.perf_counter()
    for i in range(reps):
        rng = np.random.default_rng(i)
        np.stack([rng.choice(pool, 4096, replace=False) for _ in range(5)])
    numpy_ms = (time.perf_counter() - t) * 1e3 / reps
    fields["sampler"] = {"batch": [5, 4096], "pool": pool, "native_ms": sampler_ms,
                         "numpy_ms": numpy_ms, "clock": "host, mean of 20"}

    spec = {"argv": DP_ARGV, "device": "cuda", "actions": dp_actions()}
    t = time.perf_counter()
    single = entry.data_parallel_run(None, dict(spec, device=str(dev)))
    fields["single_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = run_ranks(world, "pagnerf_tpu_torch.entry:data_parallel_run", spec, "cuda",
                      os.path.join(work, "stages"), rpd, timeout_s=600)
    fields["ranks_s"] = time.perf_counter() - t
    fields["devices"] = [r["device"] for r in ranks]
    fields["backends"] = [r["backend"] for r in ranks]

    def by(run, do):
        return [a for a in run["actions"] if a["do"] == do]

    def held(tag, got_steps, want_steps):
        """The largest relative differences of the first step's losses and
        of the later steps' from the reference's; fails on a missing step or
        key or one out of bounds."""
        if len(got_steps) != len(want_steps):
            fail(f"{tag}: {len(got_steps)} steps against {len(want_steps)}")
        rel = [0.0, 0.0]
        for i, (got, want) in enumerate(zip(got_steps, want_steps)):
            if sorted(got) != sorted(want):
                fail(f"{tag} step {i}: losses {sorted(got)} against {sorted(want)}")
            rtol = DP_LOSS_RTOL if i == 0 else DP_STEP_RTOL
            for k, v in want.items():
                d = abs(got[k] - v)
                if not (math.isfinite(got[k]) and d <= DP_LOSS_ATOL + rtol * abs(v)):
                    fail(f"{tag} step {i}: {k} {got[k]} against {v}")
                rel[min(i, 1)] = max(rel[min(i, 1)], d / max(abs(v), 1e-30))
        return rel

    def share_of(got, want, base=None):
        """max over tensors of max |got - want| over max |want - base|
        (base 0: the tensor's largest entry)."""
        share = 0.0
        for pname, w in want.items():
            scale = float((w if base is None else w - base[pname]).abs().max())
            if scale > 0:
                share = max(share, float((got[pname] - w).abs().max()) / scale)
        return share

    stages, worst = {}, {"loss_rel": 0.0, "later_loss_rel": 0.0, "grad_share": 0.0}
    for i, (name, _, epoch, _) in enumerate(DP_BLOCKS):
        ref_g, ref_s = by(single, "grads")[i], by(single, "step")[i]
        rec = {"stage": ref_s["stage"], "single_losses": ref_s["losses"],
               "single_step_ms": [ref_s["ms"]], "ranks": []}
        for r in ranks:
            g, st = by(r, "grads")[i], by(r, "step")[i]
            if st["stage"] != ref_s["stage"]:
                fail(f"{name}: rank {r['rank']} ran {st['stage']}, one process {ref_s['stage']}")
            # every step: the first from the shared start, the next after
            # the all-reduced masked update
            rel = held(f"{name}: rank {r['rank']} grads", g["losses"], ref_g["losses"])[0]
            rel, later = held(f"{name}: rank {r['rank']}", st["losses"], ref_s["losses"])
            share = share_of(g["grads"], ref_g["grads"])
            if share > DP_GRAD_SHARE:
                fail(f"{name}: rank {r['rank']} gradients off by {share} of their largest entry")
            launches = {k: g["launches"][k] + st["launches"][k] for k in st["launches"]}
            missing = [k for k in DP_NEED[name] if not launches.get(k)]
            if missing:
                fail(f"{name}: rank {r['rank']} launched no {missing}: {launches}")
            worst["loss_rel"] = max(worst["loss_rel"], rel)
            worst["later_loss_rel"] = max(worst["later_loss_rel"], later)
            worst["grad_share"] = max(worst["grad_share"], share)
            rec["ranks"].append({"rank": r["rank"], "losses": st["losses"],
                                 "step_ms": st["ms"], "launches": launches,
                                 "max_loss_rel": rel, "later_loss_rel": later,
                                 "max_grad_share": share,
                                 "pack_overflows": st["pack_overflows"],
                                 "pack_share_max": st["pack_share_max"],
                                 "collectives": len(st["collectives"])})
        stages[name] = rec
    for r in ranks:
        if r["actions"][-1]["pack_overflows"]:
            fail(f"rank {r['rank']}: {r['actions'][-1]['pack_overflows']} packed layout(s) "
                 f"overflowed the rank's buffer and cut rays unlike one process")
    fields["stages"] = stages
    fields["worst"] = worst
    fields["bounds"] = {"loss_rtol": DP_LOSS_RTOL, "loss_atol": DP_LOSS_ATOL,
                        "later_rtol": DP_STEP_RTOL, "grad_share": DP_GRAD_SHARE}
    # the control: one process with the RGB term at world x its weight, the
    # voxel stage's first microbatch against the sound one process's; the
    # bounds must fail it
    ctrl = entry.data_parallel_run(None, {
        "argv": DP_ARGV + ["--rgb-weight", str(float(world))], "device": str(dev),
        "actions": [{"do": "prune"}, {"do": "fixture"}, {"do": "grads", "epoch": 2}]})
    torch.cuda.empty_cache()
    cg, rg = by(ctrl, "grads")[0], by(single, "grads")[2]
    fields["control"] = {
        "term": f"rgb_weight x {world}",
        "loss_rel": max(abs(cg["losses"][0][k] - v) / max(abs(v), 1e-30)
                        for k, v in rg["losses"][0].items()),
        "grad_share": share_of(cg["grads"], rg["grads"])}
    if (fields["control"]["loss_rel"] <= max(DP_LOSS_RTOL, DP_STEP_RTOL)
            or fields["control"]["grad_share"] <= DP_GRAD_SHARE):
        fail(f"the bounds do not see a term without its 1/world share: {fields['control']}")
    # collectives of the voxel panoptic step, per rank's first step
    coll = by(ranks[0], "step")[2]["collectives"]
    fields["step_collectives"] = {"calls": len(coll),
                                  "elements": sum(n for _, n in coll)}
    path = {k: 0 for k in _launches()}
    for r in ranks:
        for a in r["actions"]:
            if a["do"] in ("step", "grads", "seed_prune", "prune"):
                for k, v in a["launches"].items():
                    path[k] = path.get(k, 0) + v
    emit("data_parallel_stages", **fields)
    if backend == "nccl":
        # the host loop, then the fused step, from the same state on one
        # batch (so the key's second step captures and its next two replay
        # the graph with the NCCL collectives in it): every step's losses
        # and the parameters after them equal to the host loop's
        steps = 4
        block = [{"do": "restore"}, {"do": "prune"}, {"do": "fixture"}]
        run = {"do": "step", "epoch": 2, "same_batch": True, "repeat": steps}
        fused = run_ranks(world, "pagnerf_tpu_torch.entry:data_parallel_run",
                          dict(spec, actions=[{"do": "snapshot"}] + block + [
                              {"do": "params"}, run, {"do": "params"}] + block + [
                              dict(run, fused=True), {"do": "params"}]), "cuda",
                          os.path.join(work, "fused"), rpd, timeout_s=300)
        fields["fused"] = {"steps": steps, "ranks": []}
        for r in fused:
            host_s, fused_s = by(r, "step")
            p0, p_host, p_fused = (a["params"] for a in by(r, "params"))
            if fused_s["losses"] != host_s["losses"]:
                fail(f"fused step: rank {r['rank']} losses {fused_s['losses']}, the host "
                     f"loop's {host_s['losses']}")
            upd = share_of(p_fused, p_host, p0)
            if upd != 0.0:
                fail(f"fused step: rank {r['rank']} parameters off by {upd} of the steps' update")
            rec = [e for e in r["fused_log"] if e["stage"] == "voxel_packed_panoptic"]
            if len(rec) != 1 or rec[0]["capture_ms"] is None or rec[0]["replays"] != steps - 1:
                fail(f"fused step: rank {r['rank']} did not capture once and replay: "
                     f"{r['fused_log']}")
            if r["actions"][-1]["pack_overflows"]:
                fail(f"fused step: rank {r['rank']} packed layouts overflowed")
            fields["fused"]["ranks"].append({
                "rank": r["rank"], "losses": fused_s["losses"], "host_losses": host_s["losses"],
                "param_update_share": upd, "log": rec[0],
                "step_ms": fused_s["ms"], "host_step_ms": host_s["ms"]})
        # the ray_chunk block (the blocks' pack_hist collective in the graph)
        # against the host loop run twice, whose spread bounds it
        chunk = run_ranks(world, "pagnerf_tpu_torch.entry:data_parallel_run",
                          dict(spec, actions=fused_vs_host_actions(
                              DP_BLOCKS[-1][1], DP_BLOCKS[-1][2], steps)), "cuda",
                          os.path.join(work, "fused_chunk"), rpd, timeout_s=300)
        fields["fused"]["ray_chunk"] = []
        for r in chunk:
            ok, rec = fused_vs_host(r, "voxel_packed_panoptic", steps)
            fields["fused"]["ray_chunk"].append(rec)
            if not ok:
                fail(f"fused step, ray_chunk block: rank {r['rank']}: {rec}")
        fused = fused + chunk
        emit("data_parallel_fused", world=world, backend=backend, **fields["fused"])
        for r in fused:
            for a in r["actions"]:
                if a["do"] in ("step", "grads", "seed_prune", "prune"):
                    for k, v in a["launches"].items():
                        path[k] = path.get(k, 0) + v
    try:
        dry = entry.dryrun_multichip(world, device=dev, ranks_per_device=rpd,
                                     workdir=os.path.join(work, "dryrun"))
    except AssertionError as e:
        fail(f"dryrun_multichip: {e}")
    fields.pop("stages")
    fields.update(dryrun={k: dry[k] for k in ("n", "backend", "devices", "losses",
                                             "losses_sharded", "audit")},
                  sweep=dry["sweep"], launches=path)
    emit("data_parallel", ok=True, **fields)
    shutil.rmtree(work, ignore_errors=True)
    assign = path.pop("lap_assign", 0)
    return path, assign


# The data-parallel block of the contrastive instance loss: the
# mean-shift triplanar config at its width over the bup20 phase's tree,
# its window centred on the tree's index 5 (as ``SLICE_VARIANTS`` does),
# the panoptic heads from epoch 0
DP_CONTRASTIVE_CONFIG = "configs/bup20/mean_shift_contrastive_app.yaml"
DP_CONTRASTIVE_FLAGS = ["--dataset-center-idx", "5", "--epochs", "2",
                        "--sem-epoch-start", "0", "--inst-epoch-start", "0"]


def dp_without_reduce_scatter(group, spec):
    """``entry.data_parallel_run`` with a fault, the control of the
    contrastive bounds: the ray gathers' backward keeps this rank's columns
    of its own gradient and sums nothing over the ranks (the reduce-scatter
    dropped)."""
    from pagnerf_tpu_torch import entry
    from pagnerf_tpu_torch.parallel import sharding

    def backward(ctx, g):
        rl = g.shape[1] // ctx.group.world
        return g[:, ctx.group.rank * rl:(ctx.group.rank + 1) * rl].contiguous(), None, None

    sharding._AllGatherRays.backward = staticmethod(backward)
    return entry.data_parallel_run(group, spec)


def phase_data_parallel_contrastive(dev, smi_line, tree):
    """The data-parallel step of ``sup_contrastive`` (``DP_CONTRASTIVE_*``)
    on the ranks ``phase_data_parallel`` takes (two gloo ranks on one card,
    NCCL on several), against one process: the first microbatch's losses
    and the step's (``DP_*`` bounds), the microbatch's summed gradients
    within ``DP_GRAD_SHARE`` of each tensor's largest entry or twice that
    entry's own float32 error where larger (its distance from one process's
    gradient with the contrastive loss in float64: the 1 / 0.07 temperature
    scales the similarities' rounding), no pack overflow, and the gathers'
    audit: per microbatch the embeddings (B x R x D), the labels and the
    anchor mask gathered, the embeddings' reduce-scatter. The control, the
    ranks with the reduce-scatter dropped, must break the gradient bound.
    Under NCCL the fused step (the gathers in its graph) against the host
    loop run twice (``fused_vs_host``)."""
    import shutil
    import tempfile

    import torch

    from pagnerf_tpu_torch import entry
    from pagnerf_tpu_torch.parallel.launch import run_ranks

    cards = torch.cuda.device_count()
    world, rpd = (min(4, cards), 1) if cards >= 2 else (2, 2)
    work = tempfile.mkdtemp(prefix="dpc_", dir=os.path.join(ROOT, "pagnerf_tpu_torch", "_build"))
    argv = ["--config", os.path.join(ROOT, DP_CONTRASTIVE_CONFIG), "--dataset-path", tree] \
        + DP_CONTRASTIVE_FLAGS
    fields = {"card": smi_line, "world": world, "backend": "nccl" if rpd == 1 else "gloo",
              "ranks_per_card": rpd, "config": DP_CONTRASTIVE_CONFIG,
              "flags": DP_CONTRASTIVE_FLAGS}

    def fail(msg):
        emit("data_parallel_contrastive", ok=False, error=msg, **fields)
        raise SystemExit(f"data_parallel_contrastive: {msg}")

    spec = {"argv": argv, "device": "cuda", "actions": [
        {"do": "snapshot"}, {"do": "grads", "epoch": 0}, {"do": "restore"},
        {"do": "step", "epoch": 0}]}
    t = time.perf_counter()
    single = entry.data_parallel_run(None, dict(spec, device=str(dev)))
    single64 = entry.contrastive_in_float64(None, dict(spec, device=str(dev)))
    fields["single_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = run_ranks(world, "pagnerf_tpu_torch.entry:data_parallel_run", spec, "cuda",
                      os.path.join(work, "ranks"), rpd, timeout_s=600)
    fields["ranks_s"] = time.perf_counter() - t

    def by(run, do):
        return [a for a in run["actions"] if a["do"] == do]

    ref_g, ref_s = by(single, "grads")[0], by(single, "step")[0]
    ref64 = by(single64, "grads")[0]["grads"]
    fields["stage"] = ref_s["stage"]
    if "inst_loss" not in ref_s["losses"][0]:
        fail(f"the step has no instance loss: {ref_s['losses']}")
    def grads_off(got):
        """The first microbatch's gradients of a rank against one process's:
        (the tensors out of bounds, the largest share of a tensor's largest
        entry, the largest own float32 error's share)."""
        out, share, own_share = [], 0.0, 0.0
        for pname, want in ref_g["grads"].items():
            scale = float(want.abs().max())
            own = float((want - ref64[pname]).abs().max())
            err = float((got[pname] - want).abs().max())
            if err > max(DP_GRAD_SHARE * scale, 2.0 * own):
                out.append((pname, err, scale, own))
            if scale > 0:
                share, own_share = max(share, err / scale), max(own_share, own / scale)
        return out, share, own_share

    out_ranks, worst = [], {"loss_rel": 0.0, "grad_share": 0.0, "own_share": 0.0}
    for r in ranks:
        g, st = by(r, "grads")[0], by(r, "step")[0]
        for tag, got_l, want_l in (("grads", g["losses"], ref_g["losses"]),
                                   ("step", st["losses"], ref_s["losses"])):
            for k, v in want_l[0].items():
                d = abs(got_l[0][k] - v)
                if not (math.isfinite(got_l[0][k]) and d <= DP_LOSS_ATOL + DP_LOSS_RTOL * abs(v)):
                    fail(f"rank {r['rank']} {tag}: {k} {got_l[0][k]} against {v}")
                worst["loss_rel"] = max(worst["loss_rel"], d / max(abs(v), 1e-30))
        bad, share, own_share = grads_off(g["grads"])
        if bad:
            fail(f"rank {r['rank']}: gradients (name, off by, largest entry, one process's "
                 f"own float32 error) {bad}")
        worst["grad_share"] = max(worst["grad_share"], share)
        worst["own_share"] = max(worst["own_share"], own_share)
        if st["pack_overflows"]:
            fail(f"rank {r['rank']}: {st['pack_overflows']} packed layouts overflowed")
        out_ranks.append({"rank": r["rank"], "losses": st["losses"], "step_ms": st["ms"],
                          "grads_ms": g["ms"], "collectives": len(st["collectives"])})
    # the step's gathers, from the config's microbatches
    step, mb = by(ranks[0], "step")[0], ranks[0]["microbatch"]
    want = entry.contrastive_gathers(mb["count"], mb["images"], mb["rays"],
                                     inst_dims=ranks[0]["channels"]["inst_embedding"])
    try:
        audit = entry.audit_collectives(step, ranks[0]["param_elements"], gathers=want)
    except AssertionError as e:
        fail(f"audit: {e}")
    # the control: the ranks with the gathers' reduce-scatter dropped
    # (``dp_without_reduce_scatter``); their gradients must break the bounds
    ctrl = run_ranks(world, "chip_smoke:dp_without_reduce_scatter",
                     dict(spec, actions=[{"do": "grads", "epoch": 0}]), "cuda",
                     os.path.join(work, "control"), rpd, timeout_s=600)
    fields["control"] = {"fault": "the ray gathers' reduce-scatter dropped",
                         "grad_share": max(grads_off(by(r, "grads")[0]["grads"])[1]
                                           for r in ctrl)}
    if not all(grads_off(by(r, "grads")[0]["grads"])[0] for r in ctrl):
        fail(f"the bounds do not see the reduce-scatter dropped: {fields['control']}")
    if rpd == 1:
        # NCCL: the fused step, with the gathers and their reduce-scatters in
        # its graph, against the host loop run twice
        steps = 4
        runs = run_ranks(world, "pagnerf_tpu_torch.entry:data_parallel_run",
                         dict(spec, actions=fused_vs_host_actions([], 0, steps)), "cuda",
                         os.path.join(work, "fused"), rpd, timeout_s=600)
        fields["fused"] = []
        for r in runs:
            ok, rec = fused_vs_host(r, fields["stage"], steps)
            fields["fused"].append(rec)
            if not ok:
                fail(f"fused step: rank {r['rank']}: {rec}")
        ranks = ranks + runs
    fields.update(ranks=out_ranks, worst=worst, single_losses=ref_s["losses"],
                  single_step_ms=ref_s["ms"], audit_gathers=audit["gathers"],
                  microbatch=mb,
                  embedding_dims=ranks[0]["channels"]["inst_embedding"],
                  bounds={"loss_rtol": DP_LOSS_RTOL, "loss_atol": DP_LOSS_ATOL,
                          "grad_share": DP_GRAD_SHARE, "or": "2 x own float32 error"})
    emit("data_parallel_contrastive", ok=True, **fields)
    shutil.rmtree(work, ignore_errors=True)
    path = {k: 0 for k in _launches()}
    for r in ranks:
        for a in r["actions"]:
            if a["do"] in ("step", "grads"):
                for k, v in a["launches"].items():
                    path[k] = path.get(k, 0) + v
    path.pop("lap_assign", None)
    return path


BF16_ENV = "PAGNERF_BF16_GATHER"
# the render's N (the V = 4 gathers' shapes), the hash grid of
# panoptic_nerf.yaml (14 LoDs x 2^19 x F=2, resolutions 16 -> 512) and its
# microbatch's N
RENDER_N = 1572864
HASH_GRID = (14, 2, 19, 16, 512)
HASH_N = 1 << 20


@contextlib.contextmanager
def bf16_read():
    """``PAGNERF_BF16_GATHER=1`` inside the block: float32 tables read as
    bfloat16 rows (``ops/table_gather.py``), the variable put back after."""
    old = os.environ.get(BF16_ENV)
    os.environ[BF16_ENV] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(BF16_ENV, None)
        else:
            os.environ[BF16_ENV] = old


def bf16_path_ns(post, val_times, times_by_path, hash_times):
    """Each bf16-read kernel's N on the main paths, from the phases' times
    (keyed by kernel and then N): the fused encodes' (N, with idx/bary),
    dbary's N, the V = 8 gathers' (N, with a gradient) and dbary's N."""
    ns = {"encode": {(1572864, False), (2097152, True)},
          "dual_encode": {(1572864, False), (2097152, True)},
          "dbary": {2097152}, "hash_gather": set(), "hash_gather_dual": set(),
          "hash_dbary": set()}
    ns["encode"].add((post["encode_prune"]["N"], False))
    ns["dual_encode"].add((post["dual_encode_B"]["N"], True))
    ns["dbary"].add(post["dbary_B"]["N"])
    ns["encode"].add((val_times["pre_prune"]["N"], False))
    for part in ("final", "map"):
        ns["dual_encode"].add((val_times[part]["N"], False))
    for times in times_by_path:
        for kind in ("encode", "dual_encode"):
            ns[kind] |= {(int(n), True) for n in times.get(kind, {})}
            ns[kind] |= {(int(n), False) for n in times.get(kind + NO_IDX_BARY, {})}
        ns["dbary"] |= {int(n) for n in times.get("dbary", {})}
    for name, kind in (("hash_gather_single", "hash_gather"),
                       ("hash_gather_dual", "hash_gather_dual")):
        ns[kind] |= {(int(n), True) for n in hash_times.get(name, {})}
        ns[kind] |= {(int(n), False) for n in hash_times.get(name + "_val", {})}
    ns["hash_dbary"] |= {int(n) for n in hash_times.get("hash_gather_dbary", {})}
    return {k: sorted(v) for k, v in ns.items()}


# The tuned steps' bound with the switch on: the first microbatch's
# gradients within this share of each tensor's largest entry of the same
# step with the switch off on grid tables rounded to bfloat16 beforehand
# (the same function through the float32 read). The float32 step (the
# switch off, the tables as they are) is the control that must break it.
BF16_STEP_GRAD_SHARE = 1e-5


def bf16_tuned_steps(dev):
    """The tuned config at full width in a dense RGB stage (epoch 0) and the
    voxel packed panoptic stage (epoch 2, the entry's scene fixture as the
    occupancy), each from one state and one draw in three modes:
    ``bf16_read`` (the switch on), ``rounded`` (the switch off, the grid
    tables rounded to bfloat16 in place first) and ``float32`` (the switch
    off). Per mode the first microbatch's gradients (``grad_step``), then a
    step's losses and wall; each mode's gradients against ``rounded``'s (the
    largest share of a tensor's largest entry). Then, in the voxel stage
    with the switch on, the graph against the host loop (``graph_vs_host``:
    the eager step, the capture and two replays, within the host loop's
    spread) and one fused step with the switch off, which must capture a
    key of its own. The kernels' launches are counted in the bf16-read
    runs."""
    import torch

    from pagnerf_tpu_torch.config import factory
    from pagnerf_tpu_torch.config.config import parse_options
    from pagnerf_tpu_torch.entry import apply_scene_fixture
    from pagnerf_tpu_torch.train.checkpoint import load_state, trainer_state

    _, ds, trainer = factory.get_modules_from_config(parse_options(list(DP_ARGV)), str(dev))
    cfg = trainer.cfg
    out, launches = {}, {k: 0 for k in _launches()}
    for name, epoch in (("dense_rgb", 0), ("voxel_packed_panoptic", 2)):
        if epoch == 2:
            apply_scene_fixture(trainer)
            trainer._pruned = True
        stage = trainer.stage_for_epoch(epoch)
        batch = ds.sample_batch(trainer.rng, cfg.batch_size, cfg.num_rays_sampled_per_img,
                                "train")
        sub = trainer._micro_batches(batch)[0]
        state, gen = trainer_state(trainer), trainer.generator.get_state()
        rec, grads = {"stage": stage.label}, {}
        for mode in ("bf16_read", "rounded", "float32"):
            for what in ("grads", "step"):
                load_state(trainer, state)
                trainer.generator.set_state(gen)
                if mode == "rounded":
                    with torch.no_grad():
                        for pname, p in trainer.params.items():
                            if pname.endswith(".tables"):
                                p.copy_(p.to(torch.bfloat16))
                with bf16_read() if mode == "bf16_read" else contextlib.nullcontext():
                    _reset_launches()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    if what == "grads":
                        g, _ = trainer.grad_step(stage, sub)
                        grads[mode] = {k: v.detach().float().clone() for k, v in g.items()}
                    else:
                        losses = {k: float(v) for k, v in trainer.train_step(stage, batch).items()}
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t) * 1e3
                if mode == "bf16_read":
                    for k, v in _launches().items():
                        launches[k] += v
            rec[mode] = dict(losses=losses, step_ms=ms)
        for mode in ("bf16_read", "float32"):
            ref = grads["rounded"]
            rec[mode]["grad_share_vs_rounded"] = max(
                float((grads[mode][k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for k, w in ref.items())
            rec[mode]["max_loss_rel_vs_rounded"] = max(
                abs(rec[mode]["losses"][k] - v) / max(abs(v), 1e-30)
                for k, v in rec["rounded"]["losses"].items())
        del grads
        out[name] = rec
    # the graph with the switch on, then a fused step with it off
    load_state(trainer, state)
    trainer.generator.set_state(gen)
    with bf16_read():
        runs, profiled = graph_vs_host(trainer, stage, batch)
    cmp, ok = compare_runs(runs)
    log = trainer.fused_log[-1]
    implied = fused_implied([log])[0]
    trainer.fused_train_step(stage, batch)
    torch.cuda.synchronize()
    off = trainer.fused_log[-1]
    out["fused_bf16_read"] = dict(
        stage=stage.label, ok=ok and profiled == implied and (log["steps"], log["replays"]) == (4, 3)
        and off is not log and off["steps"] == 1,
        host_ms=[runs["host_a"]["ms"], runs["host_b"]["ms"]], eager_ms=runs["eager"]["ms"],
        capture_and_replay_ms=runs["capture"]["ms"], replay_ms=runs["replay"]["ms"],
        capture_ms=log["capture_ms"], steps_replays=[log["steps"], log["replays"]],
        launches_per_replay_profiled=profiled, launches_per_step_implied=implied,
        switch_off_new_key=off is not log, keys=len(trainer.fused_log), **cmp)
    trainer._fused.clear()
    del runs, trainer, ds
    torch.cuda.empty_cache()
    return out, launches


def phase_bf16_read(dev, smi_line, spec, ns, flush):
    """The bf16 table read (``PAGNERF_BF16_GATHER=1``) of PERF.md rows 8, 9,
    3 (the fused encodes and dbary, V = 4), 10, 11 and 14 (the gathers and
    dbary, V = 8) and of rows 1-2 (the V = 4 gathers, which no path runs),
    each against its plain version (the float32 one on the rows rounded to
    bfloat16) at every N the main paths gave it (``bf16_path_ns``), on
    random tables and coordinates: the encodes by ``encode_vs_plain``'s
    bound and boundary rule, the gathers within 8 (V = 4) or 16 (V = 8)
    eps_f32 of the largest table entry, dbary within 4 eps_f32 of sum_f |g
    * T|. Times (CUDA events, median of 5, L2 flushed) of the bf16 read and
    of the float32 read in turns (float32, bf16, bf16, float32), with the
    copies the kernels read kept and with them made again at each call (a
    training step's case), and the bounds with 2-byte rows; then ``bf16_tuned_steps`` and the hash encodes
    (single and dual, N = 2^20, with a coordinate gradient) with the switch
    on: the launches of each kernel there. Returns (results by kernel row,
    the tuned steps' launches, each row's launches with the switch on)."""
    import torch

    from pagnerf_tpu_torch.ops import hash_encoding as he
    from pagnerf_tpu_torch.ops import permuto_encoding as pe
    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.ops import table_pack

    t_phase = time.perf_counter()
    fields = {"card": smi_line, "ns": {k: [list(x) if isinstance(x, tuple) else x for x in v]
                                       for k, v in ns.items()}}

    def fail(msg):
        emit("bf16_read", ok=False, error=msg, **{k: v for k, v in fields.items()
                                                  if k != "results"})
        raise SystemExit(f"bf16_read: {msg}")

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(17)
    results = {}

    def turns(f32, b16, table):
        """Medians of 5 in turns (float32, bf16, bf16, float32), each mode's
        mean of its two: with the copies the kernels read kept (the tables
        unchanged), then with ``table``'s version bumped before each call
        (``fresh_pack``), so the call makes its copy again, as every
        training step pays it after the optimizer wrote the tables."""
        got = {}
        for fresh in (False, True):
            for which in ("f32", "bf16", "bf16", "f32"):
                fn = f32 if which == "f32" else b16
                with bf16_read() if which == "bf16" else contextlib.nullcontext():
                    got.setdefault((which, fresh), []).append(cuda_ms(
                        fresh_pack(fn, table) if fresh else fn, reps=5, flush=flush))
        return {k: statistics.mean(v) for k, v in got.items()}

    def put(row, n, check, t, bound):
        if not check["ok"]:
            fail(f"{row} at N={n}: {check}")
        results.setdefault(row, {})[str(n)] = dict(
            N=n, max_abs_err=check["max_abs_err"], ok=True, ms=t[("bf16", False)],
            float32_ms=t[("f32", False)], fresh_copy_ms=t[("bf16", True)],
            float32_fresh_copy_ms=t[("f32", True)], bound_ms=bound[0], bound_by=bound[1],
            bytes=bound[2])

    # ---- V = 4: the fused encodes (rows 8, 9) and dbary (row 3)
    l, c, f = spec.num_levels, spec.capacity, spec.feature_dim
    st = pe.level_statics(spec.scales, c, f)
    ta = torch.randn((l, c, f), generator=gen, device=dev)
    tb = torch.randn((l, c, f), generator=gen, device=dev)
    a, b = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    for kind, row in (("encode", "permuto_encode_single"),
                      ("dual_encode", "permuto_encode_dual")):
        dual = kind == "dual_encode"
        for n, grad in ns[kind]:
            x = torch.rand((3, n), generator=gen, device=dev) * 2 - 1

            def kern(x=x, grad=grad, dual=dual):
                with torch.set_grad_enabled(grad):
                    return (pe.fused_encode_dual(a, b, x, spec.scales) if dual
                            else (pe.fused_encode(a, x, spec.scales),))
            with bf16_read():
                outs = kern()
            idx = bary = None
            if grad:
                _, idx, bary, _ = outs[0].grad_fn.saved_tensors
            check = encode_vs_plain(spec, x, (ta, tb) if dual else (ta,),
                                    tuple(o.detach() for o in outs), idx, bary, bf16_rows=True)
            if any(o.dtype != torch.float32 for o in outs):
                fail(f"{row}: the bf16 read wrote {outs[0].dtype}")
            del outs, idx, bary
            put(row, n, check, turns(kern, kern, a),
                encode_bound(l, c, f, n, 2 if dual else 1, 4, grad, st.rows_used,
                             row_itemsize=2))
            del x
    del a, b
    for n in ns["dbary"]:
        x = torch.rand((3, n), generator=gen, device=dev) * 2 - 1
        idx, _ = pe.lattice(ta, x, spec.scales)
        del x
        g = torch.randn((l, f, n), generator=gen, device=dev)
        rows16 = table_pack.rows_as(ta, bf16)
        got = tg.multilevel_gather_dbary(rows16, idx, g)
        diff = (got - tg.gather_dbary_plain(ta, idx, g, bf16_rows=True)).abs()
        mag = tg.gather_dbary_plain(rows16.float().abs(), idx, g.abs())
        worst = (diff / (4 * F32_EPS * mag).clamp(min=1e-30)).max().item()
        check = dict(max_abs_err=diff.max().item(), worst_err_over_tol=worst, ok=worst <= 1.0)
        del got, diff, mag, rows16
        # dbary's rows on the path: ``table_gather.dbary_rows``
        t = turns(lambda: tg.multilevel_gather_dbary(tg.dbary_rows(ta, False), idx, g),
                  lambda: tg.multilevel_gather_dbary(tg.dbary_rows(ta, True), idx, g), ta)
        put("gather_dbary", n, check, t, dbary_bound(l, c, f, n, st.rows_used, row_itemsize=2))
        del idx, g
    # the V = 4 gathers (rows 1, 2) at the render's N
    n = RENDER_N
    x = torch.rand((3, n), generator=gen, device=dev) * 2 - 1
    with torch.no_grad():
        idx, bary = pe.lattice(ta, x, spec.scales)
    del x
    tol = 8 * F32_EPS * max(ta.abs().max().item(), tb.abs().max().item())
    for row, num in (("permuto_gather_single", 1), ("permuto_gather_dual", 2)):
        kern = ((lambda: (tg.multilevel_table_gather(ta, idx, bary),)) if num == 1
                else (lambda: tg.dual_multilevel_table_gather(ta, tb, idx, bary)))
        with bf16_read(), torch.no_grad():
            got = kern()
        want = tg.dual_gather_plain(ta, tb, idx, bary, bf16_rows=True)
        err = max((g_ - w_).abs().max().item() for g_, w_ in zip(got, want))
        del got, want
        put(row, n, dict(max_abs_err=err, ok=err <= tol), turns(kern, kern, ta),
            gather_bound(l, c, f, n, num, 4, st.rows_used, row_itemsize=2))
    del idx, bary, ta, tb
    torch.cuda.empty_cache()

    # ---- V = 8: the hash grid's gathers (rows 10, 11) and dbary (row 14)
    hspec = he.HashEncodingSpec(*HASH_GRID)
    l, c, f = hspec.num_levels, hspec.capacity, hspec.feature_dim
    rows = hash_rows(hspec.resolutions, c)
    ta = torch.randn((l, c, f), generator=gen, device=dev)
    tb = torch.randn((l, c, f), generator=gen, device=dev)
    tol = 16 * F32_EPS * max(ta.abs().max().item(), tb.abs().max().item())
    for kind, row, num in (("hash_gather", "hash_gather_single", 1),
                           ("hash_gather_dual", "hash_gather_dual", 2)):
        for n, _grad in ns[kind]:
            x = torch.rand((3, n), generator=gen, device=dev) * 2 - 1
            idx, w = he.hash_indices(x, hspec.resolutions, hspec.log2_table_size)
            del x
            kern = ((lambda: (tg.multilevel_table_gather(ta, idx, w),)) if num == 1
                    else (lambda: tg.dual_multilevel_table_gather(ta, tb, idx, w)))
            with bf16_read(), torch.no_grad():
                got = kern()
            want = tg.dual_gather_plain(ta, tb, idx, w, bf16_rows=True)
            err = max((g_ - w_).abs().max().item() for g_, w_ in zip(got, want))
            del got, want
            put(row, n, dict(max_abs_err=err, ok=err <= tol), turns(kern, kern, ta),
                gather_bound(l, c, f, n, num, 4, rows, v=8, row_itemsize=2))
            del idx, w
    for n in ns["hash_dbary"]:
        x = torch.rand((3, n), generator=gen, device=dev) * 2 - 1
        idx, _ = he.hash_indices(x, hspec.resolutions, hspec.log2_table_size)
        del x
        g = torch.randn((l, f, n), generator=gen, device=dev)
        rows16 = table_pack.rows_as(ta, bf16)
        got = tg.multilevel_gather_dbary(rows16, idx, g)
        diff = (got - tg.gather_dbary_plain(ta, idx, g, bf16_rows=True)).abs()
        mag = tg.gather_dbary_plain(rows16.float().abs(), idx, g.abs())
        worst = (diff / (4 * F32_EPS * mag).clamp(min=1e-30)).max().item()
        check = dict(max_abs_err=diff.max().item(), worst_err_over_tol=worst, ok=worst <= 1.0)
        del got, diff, mag, rows16
        t = turns(lambda: tg.multilevel_gather_dbary(tg.dbary_rows(ta, False), idx, g),
                  lambda: tg.multilevel_gather_dbary(tg.dbary_rows(ta, True), idx, g), ta)
        put("hash_gather_dbary", n, check, t, dbary_bound(l, c, f, n, rows, v=8,
                                                          row_itemsize=2))
        del idx, g
    fields["checks_s"] = time.perf_counter() - t_phase

    # ---- the paths with the switch on
    _reset_launches()
    with bf16_read():
        x = (torch.rand((3, HASH_N), generator=gen, device=dev) * 2 - 1).requires_grad_()
        a, b = ta.clone().requires_grad_(), tb.clone().requires_grad_()
        out = he.hash_encode_T(a, x, hspec.resolutions)
        (out * out).sum().backward()
        oa, ob = he.hash_encode_dual_T(a, b, x, hspec.resolutions)
        (oa.sum() + (ob * ob).sum()).backward()
        torch.cuda.synchronize()
        if not (torch.isfinite(x.grad).all() and a.grad.dtype == torch.float32):
            fail("the hash encodes' gradients are not finite float32")
    hash_launches_ = _launches()
    del x, a, b, out, oa, ob, ta, tb
    torch.cuda.empty_cache()
    steps, step_launches = bf16_tuned_steps(dev)
    fused = steps.pop("fused_bf16_read")
    fields["fused_bf16_read"] = fused
    if not fused["ok"]:
        fail(f"the fused step with the switch on: {fused}")
    for name, rec in steps.items():
        if not all(math.isfinite(v) for v in rec["bf16_read"]["losses"].values()):
            fail(f"{name}: non-finite losses {rec['bf16_read']['losses']}")
        if rec["bf16_read"]["grad_share_vs_rounded"] > BF16_STEP_GRAD_SHARE:
            fail(f"{name}: the bf16 read's gradients are off those on rounded tables by "
                 f"{rec['bf16_read']['grad_share_vs_rounded']} of their largest entry")
        if rec["float32"]["grad_share_vs_rounded"] <= BF16_STEP_GRAD_SHARE:
            fail(f"{name}: the bound does not see the float32 read (the control): "
                 f"{rec['float32']['grad_share_vs_rounded']}")
    need = {"encode": step_launches["encode"], "dual_encode": step_launches["dual_encode"],
            "dbary": step_launches["dbary"], "gather": hash_launches_["gather"],
            "dual_gather": hash_launches_["dual_gather"],
            "hash_dbary": hash_launches_["dbary"]}
    missing = [k for k, v in need.items() if not v]
    if missing:
        fail(f"no launch of {missing} with the switch on: {need}")
    fields.update(tuned_steps=steps, step_launches=step_launches,
                  hash_encode_launches=hash_launches_, results=results,
                  phase_s=time.perf_counter() - t_phase)
    emit("bf16_read", ok=True, **fields)
    # the V = 4 rows count the tuned steps' launches; the V = 8 rows' hash
    # encode launches (the same wrappers' counts) stay in ``need``
    return results, step_launches, need


def data_parallel_only(dev, smi_line) -> None:
    """``--data-parallel``: the data-parallel phases alone, on min(4, cards)
    cards over NCCL where the machine has several (the branch a one-card
    run does not take), over the bup20 phase's tree; their launches, then a
    last line that says which phases ran."""
    import shutil

    import torch

    from pagnerf_tpu_torch.data.bup20_tree import write_bup20_tree

    launches, _ = phase_data_parallel(dev, smi_line)
    root = os.path.join(ROOT, "pagnerf_tpu_torch", "_build", "bup20")
    shutil.rmtree(root, ignore_errors=True)
    tree = os.path.join(root, "data", "BUP_20")
    write_bup20_tree(tree, *BUP20_SIZE)
    contrastive = phase_data_parallel_contrastive(dev, smi_line, tree)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"launches": {"data_parallel": launches,
                                   "data_parallel_contrastive": contrastive}}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "phases": ["data_parallel", "data_parallel_contrastive"],
                      "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    # import the port first: without it (or without a card) nothing is printed
    import shutil

    import torch

    from pagnerf_tpu_torch.entry import entry
    from pagnerf_tpu_torch.profile_encode import render_coords
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
    if sys.argv[1:] == ["--data-parallel"]:
        data_parallel_only(dev, smi_line)
        return

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
    assign_paths = {}
    for stage_name in ("rgb", "panoptic"):
        paths[f"train_{stage_name}"], assign_paths[f"train_{stage_name}"] = phase_train(
            dev, stage_name)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    paths["train_post_prune"], post = phase_train_post_prune(dev, flush_buf.zero_)
    paths["data_parallel"], assign_paths["data_parallel"] = phase_data_parallel(dev, smi_line)
    paths["validate"], val_times, val_launches = phase_validate(dev, flush_buf.zero_)
    paths["cli"], cli_times, cli_ckpt, cli_host = phase_cli(dev, flush_buf.zero_)
    assign_paths["cli"] = cli_host["assign_launches"]
    # the fused run's launches: counted by the wrappers, and those the
    # profiler saw in the first replay of each capture
    fused_launches, assign_row = phase_fused_step(dev, cli_ckpt, cli_host)
    assign_paths["fused_step"] = fused_launches.pop("lap_assign")
    paths["fused_step"] = fused_launches
    del cli_host
    paths["render_views"] = phase_render_views(dev, cli_ckpt)
    trainer = restored_trainer(dev, cli_ckpt)
    phase_optimizers(dev, trainer)
    paths["viewer"] = phase_viewer(dev, trainer)
    del trainer
    torch.cuda.empty_cache()
    paths["hp_sweep"] = phase_hp_sweep(dev)
    paths["bup20"], bup20_times, tree = phase_bup20(dev, flush_buf.zero_, smi_line)
    seen = {(k, int(n)) for k, by_n in bup20_times.items() for n in by_n}
    variant_times = {}
    slice_paths, slice_times = {}, {}
    for name in BUP20_VARIANTS:
        if name in SLICE_VARIANTS:
            slice_paths[name], slice_times[name] = phase_bup20_slice(
                dev, flush_buf.zero_, smi_line, tree, name)
        else:
            paths[name], variant_times[name] = phase_bup20_variant(
                dev, flush_buf.zero_, smi_line, tree, name, seen)
    paths["data_parallel_contrastive"] = phase_data_parallel_contrastive(dev, smi_line, tree)
    shutil.rmtree(os.path.dirname(os.path.dirname(tree)))
    torch.cuda.empty_cache()
    ns = bf16_path_ns(post, val_times, [cli_times, bup20_times, *variant_times.values()],
                      slice_times["panoptic_nerf"])
    bf16_rows_, paths["bf16_read"], bf16_need = phase_bf16_read(dev, smi_line, spec, ns,
                                                                 flush_buf.zero_)
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
        row["bup20"] = bup20_times[key]
        if key + NO_IDX_BARY in bup20_times:
            row["bup20_validation"] = bup20_times[key + NO_IDX_BARY]
        for name, times_ in variant_times.items():
            for k in (key, key + NO_IDX_BARY):
                if k in times_:
                    row[name + ("_validation" if k != key else "")] = times_[k]
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
            **({"redesigned": "one packed [L, C, 2F] row a vertex (ms: the kept copy)",
                "ms_with_pack": r32["ms_with_pack"],
                "bf16_ms_with_pack": r16["ms_with_pack"]} if name == "dual" else {}),
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
        if key in bup20_times:
            row["bup20"] = bup20_times[key]
        for name_, times_ in variant_times.items():
            if key in times_:
                row[name_] = times_[key]
        rows.append(row)
    rows += hash_kernel_rows(slice_paths, slice_times["panoptic_nerf"], sources)
    bf16_launch_key = {"permuto_encode_single": "encode", "permuto_encode_dual": "dual_encode",
                       "gather_dbary": "dbary", "hash_gather_single": "gather",
                       "hash_gather_dual": "dual_gather", "hash_gather_dbary": "hash_dbary"}
    for row in rows:
        if row["name"] in bf16_rows_:
            row["bf16_read"] = {
                "switch": "PAGNERF_BF16_GATHER=1: bfloat16 rows, float32 bary and outputs",
                "launches": bf16_need.get(bf16_launch_key.get(row["name"]), 0),
                "by_N": bf16_rows_[row["name"]]}
    rows.append({
        "name": "lap_assign", "route": "cuda", "source": ASSIGN_SOURCE,
        "replaces": "pagnerf_tpu/ops/assignment.py:41 lap_assign (XLA, not a Pallas kernel)",
        "launches": sum(assign_paths.values()), "launches_by_path": assign_paths,
        "dtype": "float32 costs, int64 columns",
        "shapes": "the tuned config's first panoptic microbatch [B, K, M] = "
                  f"{assign_row['shape']}",
        "max_abs_err": assign_row["max_abs_err"], "tol": 0,
        **{k: assign_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "host_scipy_ms": assign_row["host_scipy_ms"],
        "redesigned": "one warp per image, the present rows' costs staged in shared memory",
        "plan": assign_row["plan"], "launch_floor_ms": assign_row["launch_floor_ms"],
        "wrapper_ms": assign_row["wrapper_ms"], "cases_ms": assign_row["cases_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
