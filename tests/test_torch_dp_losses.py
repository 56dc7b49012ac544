"""The data-parallel losses that couple every ray pair of an image, and the
packed layout traced in ``ray_chunk`` blocks, on the CPU: ranks over gloo
(``parallel/launch.py::run_ranks``, a ``file://`` rendezvous in
``tmp_path``) at world sizes 2 and 4, the tiny flagship with float32
decoders on the 32^3 occupancy grid, 2 images of 32 rays.

- ``contrastive``: the ray march, ``sup_contrastive`` as the instance loss
  and ``contrast_sem_weight`` 0.1, one image a microbatch;
- ``packed_chunk``: the same losses after a prune and the scene fixture
  (the voxel march and the packed layout, a budget sized from a 20%
  occupied share: 16 samples a ray, so the water-fill cuts rays and each
  block's cap lies among its rays' counts), both images in one
  microbatch traced in ``ray_chunk`` blocks of 24 rays: 64 rays and 8
  padding rays in 3 blocks, which the ranks' shares straddle.

Against one process on the same global batch and jitter
(``entry.data_parallel_run`` with ``group=None``), at
``tests/test_torch_sharding.py``'s bounds: losses within rtol 1e-6 (atol
1e-7), the replicas' parameters equal, no rank's packed buffer
overflowed, and one microbatch's summed gradients within 1e-6 of each
tensor's largest entry -- the instance decoder's within that or twice the
one-process gradient's own float32 error, where that is larger: its
distance from the same process's gradient with the contrastive losses
computed in float64 (``entry.contrastive_in_float64``). The 1 / 0.07 temperature
scales the similarities' float32 rounding 14-fold, and any other order of
the sums (a rank's rows against every column, then the reduce-scatter)
rounds to other values of that size: up to 1.9e-6 of the largest entry
there. Both grids' tables are drawn uniform in [-0.5, 0.5]
(``_spread_params``): at the init's 1e-4 spread the instance embeddings
are near parallel, the similarities differ below float32's resolution at
1 / 0.07, and the float32 loss's gradient on the instance decoder is
rounding in one process too (its output bias 1.1e-5 against 7.7e-8 with
the loss in float64, as in the JAX package's float32 loss).
In ``packed_chunk`` the kept samples of each block (the
offsets' end of each ``pack_samples`` call of the microbatch's forward,
summed over the ranks' runs of that block, ``tracer.shared_blocks``) equal
one process's, and the cap cuts a block. The contrastive gathers' audit:
features, labels and the instance loss's anchor mask per microbatch, the
features' reduce-scatter, as ``entry.contrastive_gathers`` counts them.
Then, in both cases, the port's 2- and 4-rank steps against the JAX
package's sharded step on the conftest's 8-device mesh (losses: atol 1e-5,
total_loss rtol 1e-6): in ``packed_chunk`` with the jitter the JAX step
draws a block (the padding rays' rows too, which the last rank takes), each
block's kept samples against those of the JAX step's ``pack_samples``
calls; and ``PAGNERF_PACKED`` against the JAX trainer's stage budget.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pagnerf_tpu.models import tracer as tracer_j
from pagnerf_tpu.parallel.sharding import make_mesh, replicate_tree, shard_ray_batch as shard_j
from pagnerf_tpu.train.optimizer import OptimizerConfig as OptJ
from pagnerf_tpu.train.trainer import PanopticTrainer as TrainerJ
from pagnerf_tpu.train.trainer import TrainerConfig as CfgJ
from pagnerf_tpu_torch import entry
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.models import tracer
from pagnerf_tpu_torch.parallel.launch import run_ranks
from pagnerf_tpu_torch.train.trainer import PanopticTrainer, TrainerConfig

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
WORKER = "test_torch_dp_losses:record_packs"
RAYS = 32
BLOCK = 24
# the occupied share that sizes the packed budget: 16 samples a ray, more
# than some rays hold, so each block's cap comes from its histogram
OCC_FRAC = 0.2
BASE = dict(batch_size=2, num_rays_sampled_per_img=RAYS, micro_batch_imgs=1,
            sem_epoch_start=0, inst_epoch_start=0, prune_every=-1,
            optimize_val_extrinsics=False, voxel_raymarch_epoch_start=1000,
            inst_loss="sup_contrastive", contrast_sem_weight=0.1)
CASES = {
    "contrastive": (BASE, [], 0),
    "packed_chunk": (dict(BASE, voxel_raymarch_epoch_start=0, micro_batch_imgs=2),
                     [{"do": "prune"}, {"do": "fixture", "occ_frac": OCC_FRAC},
                      {"do": "tracer", "ray_chunk": BLOCK}], 2),
}


def record_packs(group, spec):
    """``entry.data_parallel_run`` with every ``pack_samples`` call of the
    tracer recorded: (rays, kept samples, buffer, valid samples of the
    march) in call order."""
    calls = []
    orig = tracer.pack_samples

    def spy(rm, *args, **kw):
        ps = orig(rm, *args, **kw)
        calls.append((rm.mask.shape[0], int(ps.offsets[-1]), ps.valid.shape[0],
                      int(rm.mask.sum())))
        return ps

    tracer.pack_samples = spy
    try:
        out = entry.data_parallel_run(group, spec)
    finally:
        tracer.pack_samples = orig
    out["packs"] = calls
    return out


def _spec(case, batches, jitters):
    cfg, prelude, epoch = CASES[case]
    acts = list(prelude) + [
        {"do": "grads", "epoch": epoch, "batch": batches[0], "jitter": jitters[0][0]},
        {"do": "step", "epoch": epoch, "batch": batches[0], "jitters": jitters[0]},
        {"do": "step", "epoch": epoch, "batch": batches[1], "jitters": jitters[1]},
        {"do": "params"}]
    return {"tiny": True, "device": "cpu", "compute_dtype": "float32", "occ_level": 5,
            "cfg": cfg, "actions": acts, "params": _spread_params()}


def _spread_tables():
    """Both grids' tables drawn uniform in [-0.5, 0.5] (a trained field's
    spread, not the init's 1e-4), by state-dict name."""
    pipe, _ = entry.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    sd = pipe.state_dict()
    gen = torch.Generator().manual_seed(5)
    return {k: torch.rand(sd[k].shape, generator=gen) - 0.5
            for k in ("nef.grid.tables", "nef.delta_grid.tables")}


def _spread_params():
    """The tiny flagship's parameters with ``_spread_tables``."""
    pipe, _ = entry.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    sd = {k: v.clone() for k, v in pipe.state_dict().items()}
    sd.update(_spread_tables())
    return sd


def _batches_and_jitters(case):
    cfg, prelude, epoch = CASES[case]
    pipe, ds = entry.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    t = PanopticTrainer(pipe.requires_grad_(True), ds, TrainerConfig(**cfg), occ_level=5)
    t._pruned = any(a["do"] == "prune" for a in prelude)
    steps = t.stage_for_epoch(epoch).num_steps
    rng = np.random.default_rng(11)
    batches = [ds.sample_batch(rng, cfg["batch_size"], RAYS) for _ in range(2)]
    jit = np.random.default_rng(12)
    micro = cfg["batch_size"] // cfg["micro_batch_imgs"]
    rays = RAYS * cfg["micro_batch_imgs"]
    jitters = [[jit.uniform(size=(rays, steps)).astype(np.float32) for _ in range(micro)]
               for _ in range(2)]
    return batches, jitters


@pytest.fixture(scope="module", params=[(n, c) for n in (2, 4) for c in CASES],
                ids=lambda p: f"world{p[0]}-{p[1]}")
def dp_run(request, tmp_path_factory):
    n, case = request.param
    batches, jitters = _batches_and_jitters(case)
    spec = _spec(case, batches, jitters)
    single = record_packs(None, spec)
    single64 = entry.contrastive_in_float64(None, spec, record_packs)
    mp = pytest.MonkeyPatch()
    # the ranks import this module for ``record_packs``
    mp.setenv("PYTHONPATH", os.pathsep.join(
        [TESTS] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    try:
        ranks = run_ranks(n, WORKER, spec, "cpu", str(tmp_path_factory.mktemp(f"dpl{n}{case}")))
    finally:
        mp.undo()
    return dict(n=n, case=case, single=single, single64=single64, ranks=ranks, spec=spec)


def _acts(run, do):
    return [a for a in run["actions"] if a["do"] == do]


def test_contrastive_dp_losses_match_single_process(dp_run):
    for r in dp_run["ranks"]:
        for a_dp, a_1 in zip(_acts(r, "step") + _acts(r, "grads"),
                             _acts(dp_run["single"], "step") + _acts(dp_run["single"], "grads")):
            for got, ref in zip(a_dp["losses"], a_1["losses"]):
                assert sorted(got) == sorted(ref)
                assert {"inst_loss", "contrast_sem_loss"} <= set(ref)
                for k in ref:
                    np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7,
                                               err_msg=f"{dp_run['case']} rank {r['rank']} {k}")


def test_contrastive_dp_gradients_match_single_process(dp_run):
    ref = _acts(dp_run["single"], "grads")[0]["grads"]
    ref64 = _acts(dp_run["single64"], "grads")[0]["grads"]
    for r in dp_run["ranks"]:
        got = _acts(r, "grads")[0]["grads"]
        assert sorted(got) == sorted(ref)
        for name, g in ref.items():
            scale = float(g.abs().max())
            bound = 1e-6 * max(scale, 1e-30)
            if name.startswith("nef.decoder_inst"):
                own = float((g - ref64[name]).abs().max())
                bound = max(bound, 2.0 * own)
            assert float((got[name] - g).abs().max()) <= bound, (name, scale)
        inst = [g for name, g in got.items() if name.startswith("nef.decoder_inst")]
        assert inst and any(float(g.abs().max()) > 0 for g in inst)


def test_contrastive_dp_replicas_stay_equal(dp_run):
    first = _acts(dp_run["ranks"][0], "params")[0]["params"]
    for r in dp_run["ranks"][1:]:
        got = _acts(r, "params")[0]["params"]
        for name in first:
            assert torch.equal(got[name], first[name]), name
    for r in dp_run["ranks"]:
        assert _acts(r, "step")[-1]["pack_overflows"] == 0


def test_block_kept_samples_match_single_process(dp_run):
    """Each global block's kept samples, summed over the ranks' runs of it,
    are one process's; the cap cut rays (fewer kept than valid samples)."""
    if dp_run["case"] != "packed_chunk":
        assert not dp_run["single"]["packs"]
        return
    n, images = dp_run["n"], CASES["packed_chunk"][0]["micro_batch_imgs"]
    single = dp_run["single"]["packs"]
    blocks = -(-images * RAYS // BLOCK)
    assert [c[0] for c in single[:blocks]] == [BLOCK] * blocks
    want = [c[1] for c in single[:blocks]]
    assert sum(want) < sum(c[3] for c in single[:blocks])    # the cap cut rays
    assert len(set(want)) > 1                 # each block's cap from its histogram
    assert _block_kept(dp_run["ranks"], n, images) == want
    # the shares straddle blocks: some block is held by two ranks
    local = images * RAYS // n
    held = [sum(1 for r in range(n) if any(
        b > a and k == i for i, (a, b) in enumerate(tracer.shared_blocks(
            local, images, n, r, BLOCK)[1]))) for k in range(blocks)]
    assert max(held) >= 2


def _block_kept(ranks, n, images):
    """Each global block's kept samples in the first forward of ``ranks``'
    ``record_packs`` runs, summed over the ranks' runs of that block; checks
    each run's ray count and the padding's rank on the way."""
    blocks = -(-images * RAYS // BLOCK)
    got = [0] * blocks
    local = images * RAYS // n
    for r in ranks:
        pad, runs = tracer.shared_blocks(local, images, n, r["rank"], BLOCK)
        live = [k for k, (a, b) in enumerate(runs) if b > a]
        calls = r["packs"][:len(live)]
        assert [c[0] for c in calls] == [runs[k][1] - runs[k][0] for k in live]
        for k, c in zip(live, calls):
            got[k] += c[1]
        assert pad == (((-images * RAYS) % BLOCK) if r["rank"] == n - 1 else 0)
    return got


def test_contrastive_gathers_audit(dp_run):
    """The step's gathers, by tag: features (B x R x D) and labels (B x R)
    of both terms, the instance loss's anchor mask, the features'
    reduce-scatter, once per microbatch; the other collectives stay small."""
    cfg = CASES[dp_run["case"]][0]
    pipe, ds = entry.flagship(tiny=True, device="cpu")
    si = ds.semantic_info
    step = _acts(dp_run["ranks"][0], "step")[0]
    want = entry.contrastive_gathers(cfg["batch_size"] // cfg["micro_batch_imgs"],
                                     cfg["micro_batch_imgs"], RAYS,
                                     inst_dims=si["num_instances"], classes=si["num_classes"])
    audit = entry.audit_collectives(step, dp_run["ranks"][0]["param_elements"], gathers=want)
    assert audit["gathers"]["gather/supcon_feats"]["elements"] == \
        cfg["batch_size"] * RAYS * si["num_instances"]
    assert audit["largest_small"] < 4096
    with pytest.raises(AssertionError, match="ray gathers"):
        entry.audit_collectives(step, dp_run["ranks"][0]["param_elements"], gathers={})


def test_shared_blocks_layout():
    """Every global ray (and padding ray) in exactly one rank's run of its
    block, in global order."""
    for n, images, world, blk in ((64, 2, 2, 24), (16, 2, 4, 24), (40, 5, 2, 7)):
        per = n // images
        seen = []
        for rank in range(world):
            pad, runs = tracer.shared_blocks(n, images, world, rank, blk)
            g = [b * per * world + rank * per + j for b in range(images) for j in range(per)]
            g += [n * world + i for i in range(pad)]
            for k, (a, b) in enumerate(runs):
                assert all(k * blk <= x < (k + 1) * blk for x in g[a:b])
                seen += g[a:b]
            assert runs[-1][1] == len(g)
        assert sorted(seen) == list(range(-(-n * world // blk) * blk))


# ------------------------------------------------- the padding rays' rows
# ``packed_chunk`` with a budget the padding rays' valid samples stay under
# (56 a ray of the 64 steps), so each ray keeps every valid sample and the
# 8 padding rays' kept counts (58-63 of their 64 samples along +z from the
# origin cross the scene's occupied cells) move with their jitter rows
PAD_OCC_FRAC = 0.75
PAD_CASE = (dict(BASE, voxel_raymarch_epoch_start=0, micro_batch_imgs=2),
            [{"do": "prune"}, {"do": "fixture", "occ_frac": PAD_OCC_FRAC},
             {"do": "tracer", "ray_chunk": BLOCK}], 2)


def _padded_spec(pad_rows):
    """PAD_CASE's grads and a step on global jitters with rows for the
    padding rays (``pad_rows``: drawn, or 0.5 where a process that is not
    given them puts midpoints)."""
    cfg, prelude, epoch = PAD_CASE
    pipe, ds = entry.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    t = PanopticTrainer(pipe.requires_grad_(True), ds, TrainerConfig(**cfg), occ_level=5)
    t._pruned = True
    steps = t.stage_for_epoch(epoch).num_steps
    rays = RAYS * cfg["micro_batch_imgs"]
    pad = (-rays) % BLOCK
    batch = ds.sample_batch(np.random.default_rng(13), cfg["batch_size"], RAYS)
    jitter = np.random.default_rng(14).uniform(size=(rays + pad, steps)).astype(np.float32)
    if pad_rows == "midpoints":
        jitter[rays:] = 0.5
    acts = list(prelude) + [
        {"do": "grads", "epoch": epoch, "batch": batch, "jitter": jitter},
        {"do": "step", "epoch": epoch, "batch": batch, "jitters": [jitter]}]
    return {"tiny": True, "device": "cpu", "compute_dtype": "float32", "occ_level": 5,
            "cfg": cfg, "actions": acts, "params": _spread_params()}, pad


def test_padding_rays_rows_reach_the_last_rank(tmp_path):
    """The jitter rows past the global rays go to the last rank, which holds
    the padding rays of the last ``ray_chunk`` block (``trainer._draws``):
    with them each block's kept samples, summed over the ranks' runs, equal
    one process's, which traces the padding rays on those rows; the losses
    within the bounds above. The padding block's kept count moves when those
    rows are midpoints instead, so the test sees rows that do not arrive."""
    spec, pad = _padded_spec("drawn")
    assert pad == 8
    images = PAD_CASE[0]["micro_batch_imgs"]
    blocks = -(-images * RAYS // BLOCK)
    single = record_packs(None, spec)
    want = [c[1] for c in single["packs"][:blocks]]
    valid = [c[3] for c in single["packs"][:blocks]]
    assert [c[0] for c in single["packs"][:blocks]] == [BLOCK] * blocks
    assert want == valid                      # no cap: every valid sample kept
    mid = record_packs(None, _padded_spec("midpoints")[0])
    got_mid = [c[1] for c in mid["packs"][:blocks]]
    assert got_mid[:-1] == want[:-1] and got_mid[-1] != want[-1]
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", os.pathsep.join(
        [TESTS] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    try:
        ranks = run_ranks(2, WORKER, spec, "cpu", str(tmp_path))
    finally:
        mp.undo()
    assert _block_kept(ranks, 2, images) == want
    for r in ranks:
        for a_dp, a_1 in zip(_acts(r, "step") + _acts(r, "grads"),
                             _acts(single, "step") + _acts(single, "grads")):
            for got, ref in zip(a_dp["losses"], a_1["losses"]):
                for k in ref:
                    np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7,
                                               err_msg=f"rank {r['rank']} {k}")
        assert _acts(r, "step")[-1]["pack_overflows"] == 0


# ----------------------------------------------------------- against JAX
def _jax_trainer(case):
    """The JAX trainer of ``case`` (float32 decoders) and its state as the
    port's ranks start from it: ``contrastive`` on its init parameters at
    occupancy level 4; ``packed_chunk`` with ``_spread_tables``, ``ray_chunk``
    blocks of ``BLOCK`` and the scene fixture's occupancy (level 5) past a
    prune, its packed budget sized from ``OCC_FRAC``."""
    cfg, prelude, epoch = CASES[case]
    packed = case == "packed_chunk"
    pipe_j, ds_j = graft._flagship(tiny=True)
    pipe_j.nef = pipe_j.nef.clone(compute_dtype_name="float32")
    if packed:
        pipe_j.tracer_cfg = dataclasses.replace(pipe_j.tracer_cfg, ray_chunk=BLOCK)
    tj = TrainerJ(pipe_j, ds_j, CfgJ(**cfg), OptJ(), occ_level=5 if packed else 4)
    if not packed:
        return tj, []
    spread = {k.split(".")[1]: v.numpy() for k, v in _spread_tables().items()}
    tj.params = dict(tj.params, nef=dict(tj.params["nef"], **{
        name: dict(tj.params["nef"][name], tables=jax.numpy.asarray(t))
        for name, t in spread.items()}))
    pipe, ds = entry.flagship(tiny=True, device="cpu")
    tt = PanopticTrainer(pipe, ds, TrainerConfig(**cfg), occ_level=5)
    entry.apply_scene_fixture(tt)
    tj.occ = tj.occ.__class__(occupancy=jax.numpy.asarray(tt.occ.occupancy.numpy()),
                              mask=jax.numpy.asarray(tt.occ.mask.numpy()), level=tj.occ.level)
    tj._pruned, tj._occ_frac = True, OCC_FRAC
    return tj, [a for a in prelude if a["do"] != "prune"]


@pytest.mark.parametrize("case", list(CASES))
def test_contrastive_dp_step_matches_jax_sharded_step(case, tmp_path, monkeypatch):
    """The JAX package's sharded step (8-device CPU mesh) with the
    contrastive losses against the port's 2- and 4-rank steps from the
    converted weights, the same batch and the jitter the JAX step drew (per
    block of ``BLOCK`` rays under ``ray_chunk``). In ``packed_chunk`` each
    block's kept samples, read from the JAX step's ``pack_samples`` calls,
    equal the port's summed over the ranks, and fit the stage's budget."""
    cfg, _, epoch = CASES[case]
    tj, prelude = _jax_trainer(case)
    stage = tj.stage_for_epoch(epoch)
    images = cfg["micro_batch_imgs"]
    kept_j = []
    if case == "packed_chunk":
        assert stage.pack_steps > 0
        orig = tracer_j.pack_samples

        def spy(rm, *args, **kw):
            ps = orig(rm, *args, **kw)
            jax.debug.callback(lambda v: kept_j.append(int(v)), ps.offsets[-1])
            return ps

        monkeypatch.setattr(tracer_j, "pack_samples", spy)
    batch = tj.dataset.sample_batch(np.random.default_rng(3), cfg["batch_size"], RAYS)
    params0, key = tj.params, tj._step_key
    jitters = []
    for _ in range(batch["imgs"].shape[0] // images):
        key, k = jax.random.split(key)
        if case == "packed_chunk":
            nb = -(-images * RAYS // BLOCK)
            jitters.append(np.concatenate([
                np.asarray(jax.random.uniform(kb, (BLOCK, stage.num_steps)))
                for kb in jax.random.split(k, nb)]))
        else:
            jitters.append(np.array(jax.random.uniform(k, (RAYS, stage.num_steps))))
    mesh = make_mesh(8)
    with mesh:
        tj.params = replicate_tree(tj.params, mesh)
        tj.opt_state = replicate_tree(tj.opt_state, mesh)
        tj.occ = replicate_tree(tj.occ, mesh)
        tj.lod_w = replicate_tree(tj.lod_w, mesh)
        losses_j = {k: float(v) for k, v in tj.train_step(stage, shard_j(batch, mesh)).items()}
        jax.effects_barrier()
    assert {"inst_loss", "contrast_sem_loss"} <= set(losses_j)
    spec = {"tiny": True, "device": "cpu", "compute_dtype": "float32",
            "occ_level": tj.occ.level, "cfg": cfg,
            "params": params_from_flax(jax.tree_util.tree_map(np.asarray, params0)),
            "actions": prelude + [{"do": "step", "epoch": epoch, "batch": batch,
                                   "jitters": jitters}]}
    # the ranks import this module for ``record_packs``
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [TESTS] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    for n in (2, 4):
        ranks = run_ranks(n, WORKER, spec, "cpu", str(tmp_path / f"jax{n}"))
        for r in ranks:
            got = _acts(r, "step")[0]["losses"][0]
            assert sorted(got) == sorted(losses_j)
            for k, v in losses_j.items():
                if k == "total_loss":
                    np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
                else:
                    np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
        if case == "packed_chunk":
            nb = -(-images * RAYS // BLOCK)
            got = _block_kept(ranks, n, images)
            assert kept_j[:nb] == got, (kept_j, got)
            assert max(got) <= stage.pack_steps * BLOCK and len(set(got)) > 1


# ----------------------------------------------------------- PAGNERF_PACKED
@pytest.fixture(scope="module")
def trainer_pair():
    pipe_j, ds_j = graft._flagship(tiny=True)
    tj = TrainerJ(pipe_j, ds_j, CfgJ(**BASE), OptJ(), occ_level=5)
    pipe, ds = entry.flagship(tiny=True, device="cpu")
    tt = PanopticTrainer(pipe.requires_grad_(True), ds, TrainerConfig(**BASE), occ_level=5)
    return tj, tt


@pytest.mark.parametrize("env", [None, "0", "1", "yes"])
@pytest.mark.parametrize("packed", [True, False])
def test_pagnerf_packed_matches_jax_stage(trainer_pair, monkeypatch, env, packed):
    """``PAGNERF_PACKED`` ("1" on, anything else off) overrides
    ``packed_compaction`` where set, in the port as in the JAX trainer:
    the packed and compacted budgets of every stage past a prune."""
    tj, tt = trainer_pair
    if env is None:
        monkeypatch.delenv("PAGNERF_PACKED", raising=False)
    else:
        monkeypatch.setenv("PAGNERF_PACKED", env)
    tj.cfg = dataclasses.replace(tj.cfg, packed_compaction=packed)
    tt.cfg = dataclasses.replace(tt.cfg, packed_compaction=packed)
    on = packed if env is None else env == "1"
    for t in (tj, tt):
        t._pruned, t._occ_frac = True, 0.1
    for epoch in (0, 2):
        sj, st = tj.stage_for_epoch(epoch), tt.stage_for_epoch(epoch)
        assert (st.pack_steps, st.compact_steps, st.num_steps) == \
            (sj.pack_steps, sj.compact_steps, sj.num_steps), (env, packed, epoch)
        assert (st.pack_steps > 0) == on
