"""The training driver: ``PanopticTrainer.run_epoch`` of one epoch's stage,
epoch after epoch, for the window.

Set-up builds the trainer once through the program's factory, loads the
weights drawn from the seed, sets the scene fixture's occupancy where the
mix trains past the prune, and captures every graph key of a fused step
(a batch with the anchor camera at each microbatch, then the weights, the
moments and the counts are put back). Then the same trainer runs its first
epochs through ``run_epoch``, with the batches and the jitter recorded for
the first ``check_steps`` steps, the first step's Adam state and the state
after the check steps kept: the reference follows those steps once the
window has closed. The window runs whole epochs until ``--seconds`` have
passed and closes with a synchronise; its rate counts every ray of every
step queued in it.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from . import check, harness, probes as probes_mod, tracing
from .reference.build import build_nef, scene_density


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def apply_fixture(trainer, data, dev) -> None:
    """The occupancy a trained field of the scene leaves after the prune,
    set through the program's ``update_from_density`` as its prune sets it."""
    density = scene_density(data["scene"], trainer.occ.res, dev)
    trainer.occ = trainer.occ.update_from_density(density, decay=0.0, dilate=1)
    trainer._occ_frac = float(trainer.occ.mask.float().mean())
    trainer._pruned = trainer._real_pruned = True


class Recorder:
    """The benchmark's wrappers around the program's draws, batches and
    steps: records the first ``steps`` steps' inputs and keeps the state
    the comparison reads."""

    def __init__(self, trainer, steps: int, gen: torch.Generator, dev):
        self.trainer, self.steps, self.gen, self.dev = trainer, steps, gen, dev
        self.on = False
        self.batches, self.jitters, self.losses = [], [], []
        self.mu1 = self.after = None
        self.count = 0
        self._sample = trainer.dataset.sample_batch
        self._step = trainer.train_step
        trainer.draw = self.draw
        trainer.dataset.sample_batch = self.sample_batch
        trainer.train_step = self.train_step

    def draw(self, shape):
        x = torch.rand(tuple(shape), generator=self.gen, device=self.dev)
        if self.on and self.count < self.steps:
            self.jitters[-1].append(x.clone())
        return x

    def sample_batch(self, *a, **k):
        with torch.profiler.record_function("bench.sample_batch"):
            batch = self._sample(*a, **k)
        if self.on and self.count < self.steps:
            self.batches.append({key: np.array(v, copy=True) for key, v in batch.items()})
            self.jitters.append([])
        return batch

    def train_step(self, *a, **k):
        with torch.profiler.record_function("bench.train_step"):
            out = self._step(*a, **k)
        if self.on and self.count < self.steps:
            self.losses.append({k: v.detach().clone() for k, v in out.items()})
            opt = self.trainer.opt
            if self.count == 0:
                self.mu1 = {n: m.detach().clone() for n, m in opt.mu.items()}
            if self.count == self.steps - 1:
                self.after = {n: p.detach().clone() for n, p in self.trainer.params.items()}
        self.count += 1
        return out


def warm_fused_keys(trainer, stage, batch) -> None:
    """Run the fused step of every key the mix's batches can have: no
    anchor camera, or the anchor in each microbatch; each key's first step
    runs eagerly and its second captures the graph. The pixels stay those of
    ``batch`` (the state is put back afterwards)."""
    cfg = trainer.cfg
    anchor = int(np.nonzero(trainer.pipeline.anchor_host)[0][0])
    others = [int(i) for i in trainer.dataset.train_idxs if int(i) != anchor]
    b = cfg.batch_size
    mb = max(1, min(cfg.micro_batch_imgs or b, b))
    while b % mb:
        mb -= 1
    layouts = [None] + list(range(0, b, mb))
    for pos in layouts:
        cams = others[:b]
        if pos is not None:
            cams[pos] = anchor
        for _ in range(2):
            trainer.train_step(stage, {**batch, "cam_idx": np.asarray(cams, np.int32)})


def run(cell: Dict, seed: int, seconds: float, trace: bool, t_start: float, dev,
        control: bool = False) -> Dict:
    cfg_file, traffic = cell["config"], cell["traffic"]
    settings = harness.settings_of(cfg_file, traffic)
    epoch, pruned = int(traffic["epoch"]), bool(traffic["pruned"])
    from .scene import crop_row_frames
    data = crop_row_frames(cfg_file["frames"], cfg_file["frames"]["predictions"], dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63) ^ 0x5EED)
    pipe, ds, trainer = harness.build_program(settings, data, dev, seed,
                                              lambda s: torch.rand(tuple(s), device=dev))
    shapes = {n: tuple(p.shape) for n, p in pipe.named_parameters()}
    weights = harness.make_weights(shapes, cfg_file["weights"], seed, dev)
    harness.load_weights(pipe, weights)
    start = {n: p.detach().clone() for n, p in trainer.params.items()}
    if pruned:
        apply_fixture(trainer, data, dev)
    stage = trainer.stage_for_epoch(epoch)
    if trainer.should_prune(epoch) or stage.training_val_poses:
        raise ValueError(f"epoch {epoch} prunes or trains the val poses")
    rec = Recorder(trainer, int(traffic["check_steps"]), gen, dev)
    probes = None
    if trace:
        ref_nef = build_nef(settings, data["semantic_info"]).to("cpu")
        probes = probes_mod.Probes(settings, ref_nef, dev)
        trainer.timer.activate = True
    with probes_mod.installed(probes):
        if trainer._fused_step_enabled():
            sample = trainer.dataset.sample_batch(trainer.rng, trainer.cfg.batch_size,
                                                  trainer.cfg.num_rays_sampled_per_img)
            warm_fused_keys(trainer, stage, sample)
            with torch.no_grad():
                for n, p in trainer.params.items():
                    p.copy_(start[n])
                trainer.opt.reset_moments()
                trainer.opt.counts.zero_()
        rec.on, rec.count = True, 0
        while rec.count < rec.steps:
            trainer.run_epoch(epoch)
        rec.on = False
        _sync(dev)
        setup_s = time.perf_counter() - t_start
        steps0 = rec.count
        before = probes.read() if probes else None
        timer0 = dict(trainer.timer.records)
        limit = seconds if not trace else None
        epochs = 0
        with tracing.profiled(trace) as prof:
            t0 = time.perf_counter()
            while True:
                trainer.run_epoch(epoch)
                epochs += 1
                if limit is not None and time.perf_counter() - t0 >= limit:
                    break
                if limit is None and epochs >= int(traffic["trace_epochs"]):
                    break
            _sync(dev)
            window = time.perf_counter() - t0
        counters = probes_mod.difference(probes.read(), before) if probes else None
        steps = rec.count - steps0
        sample_s = trainer.timer.records.get("data_sample", 0.0) - timer0.get("data_sample", 0.0)
        labels = None
        if trace:
            # one more epoch with the host recorded, for the idle gaps' labels
            with tracing.profiled(True, labelled=True) as lab:
                trainer.run_epoch(epoch)
                _sync(dev)
            labels = tracing.summarize(lab.events)["idle_gaps"]
    rays = steps * trainer.cfg.batch_size * trainer.cfg.num_rays_sampled_per_img
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog = {"losses": [float(x["total_loss"]) for x in rec.losses],
            "terms": [{k: float(v) for k, v in x.items()} for x in rec.losses],
            "grad": {n: check.leaf_norm(m / (1 - 0.9)) for n, m in rec.mu1.items()},
            "change": {n: check.leaf_norm(rec.after[n] - start[n]) for n in rec.after}}
    record = {"window_s": window, "steps": steps, "rays": rays,
              "counters": counters, "setup_s": setup_s,
              "data_sample_s": sample_s,
              "trace": tracing.summarize(prof.events, window) if trace and prof.events
              else None,
              "labels": labels, "rays_per_s": rays / window, "peak": peak}
    batches, jitters = rec.batches, [[j.cpu() for j in js] for js in rec.jitters]
    del trainer, pipe, ds, rec, start
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        ref = check.reference_train(settings, data, weights, epoch, pruned, batches, jitters,
                                    dev)
        if control:
            prog = check.reference_train(settings, data, weights, epoch, pruned, batches,
                                         jitters, dev, tf32=True)
        numbers = check.train_numbers(prog, ref)
        record["details"] = check.train_details(prog, ref)
    except ValueError as e:
        # the program's steps drew other inputs than its batches ask for
        numbers = {k: check.UNFOLLOWED for k in check.TRAIN_NUMBERS}
        record["details"] = [f"the reference cannot follow the program's steps: {e}"]
    numbers["batch_rows_mismatch"] = sum(check.batch_rows_mismatch(b, data) for b in batches)
    record["numbers"] = numbers
    record["attempted"] = steps
    return record
