"""Ray-axis data parallelism (``pagnerf_tpu_torch/parallel/sharding.py``)
on the CPU: ranks over gloo, each a process of
``pagnerf_tpu_torch.parallel.launch`` joined through a ``file://``
rendezvous in ``tmp_path`` (no TCP port), at world sizes 2 and 4.

The port's DP step against the port's single-process step on the same
global batch and the same global jitter (``entry.data_parallel_run``, one
process with ``group=None``), at the tiny flagship with float32 decoders on the 32^3 occupancy grid:

- ``dense_rgb``: the ray march, RGB only;
- ``voxel_packed_panoptic``: the voxel march and the packed layout after a
  prune and the scene fixture, ``linear_assignment_things`` with outlier
  rejection and the segment regulariser (epoch 2), the semantic loss;
- ``packed_truncating``: the same with a packed budget sized from a 2%
  occupied share, so the water-fill cuts rays (the global cap is checked
  to be below the largest count).

Losses within rtol 1e-6 (atol 1e-7); the all-reduced gradients of one
microbatch (``grad_step``) within 1e-6 of each tensor's largest entry; a
second step from the updated state likewise; the replicas' parameters
equal bit for bit after both updates. A rank's packed buffer is
``RayGroup.share_buffer`` at the default ``PACK_SHARE_MARGIN`` of 1.25:
every run checks that no share overflowed it (at 8 to 16 rays a rank the
largest share seen is about 1.24); ``test_pack_overflow_is_counted`` runs
the ranks through ``run_with_margin`` at a margin of 0.5 and shows the
overflow counted and logged.

Then: the DP fused step (on the CPU the eager body) against the DP host
loop, bit for bit; a host-local batch; ``run_epoch`` under the group, a
checkpoint written by rank 0 and resumed by every rank, a validation on
rank 0; the DP step against the JAX package's sharded step
on the conftest's 8-device mesh with weights from ``convert.py`` (losses
within the tolerance ``test_torch_train.py`` holds the port's
single-process step to); the fused step's refusal of gloo on the card; the
dispatch by key; the collective
audit's element counts; ``entry.dryrun_multichip`` on the CPU.
"""
import dataclasses
import logging
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pagnerf_tpu.parallel.sharding import make_mesh, replicate_tree, shard_ray_batch as shard_j
from pagnerf_tpu.train.optimizer import OptimizerConfig as OptJ
from pagnerf_tpu.train.trainer import PanopticTrainer as TrainerJ
from pagnerf_tpu.train.trainer import TrainerConfig as CfgJ
from pagnerf_tpu_torch import entry
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.parallel import sharding
from pagnerf_tpu_torch.parallel.launch import run_ranks
from pagnerf_tpu_torch.train.trainer import PanopticTrainer, TrainerConfig

WORKER = "pagnerf_tpu_torch.entry:data_parallel_run"
TESTS = os.path.dirname(os.path.abspath(__file__))
RAYS = 32
BASE = dict(batch_size=2, num_rays_sampled_per_img=RAYS, micro_batch_imgs=1,
            sem_epoch_start=0, inst_epoch_start=0, prune_every=-1,
            optimize_val_extrinsics=False, inst_outlier_rejection=True,
            voxel_raymarch_epoch_start=1000)
VOXEL = dict(BASE, voxel_raymarch_epoch_start=0)
CASES = {
    "dense_rgb": (dict(BASE, sem_epoch_start=100, inst_epoch_start=100), [], 0),
    "voxel_packed_panoptic": (VOXEL, [{"do": "prune"}, {"do": "fixture"}], 2),
    "packed_truncating": (VOXEL, [{"do": "prune"}, {"do": "fixture", "occ_frac": 0.02}], 2),
}


def _spec(cfg, prelude, epoch, batches, jitters):
    acts = list(prelude) + [
        {"do": "grads", "epoch": epoch, "batch": batches[0], "jitter": jitters[0][0]},
        {"do": "step", "epoch": epoch, "batch": batches[0], "jitters": jitters[0]},
        {"do": "step", "epoch": epoch, "batch": batches[1], "jitters": jitters[1]},
        {"do": "params"}]
    return {"tiny": True, "device": "cpu", "compute_dtype": "float32", "occ_level": 5,
            "cfg": cfg, "actions": acts}


def _batches_and_jitters(cfg, epoch, prelude):
    """Two global batches and their global jitter, from a single-process
    trainer's stage (its num_steps)."""
    pipe, ds = entry.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    t = PanopticTrainer(pipe.requires_grad_(True), ds, TrainerConfig(**cfg), occ_level=5)
    if prelude:
        t._pruned = True
    steps = t.stage_for_epoch(epoch).num_steps
    rng = np.random.default_rng(7)
    batches = [ds.sample_batch(rng, cfg["batch_size"], RAYS) for _ in range(2)]
    jit = np.random.default_rng(8)
    jitters = [[jit.uniform(size=(RAYS, steps)).astype(np.float32) for _ in range(2)]
               for _ in range(2)]
    return batches, jitters


@pytest.fixture(scope="module", params=[(n, c) for n in (2, 4) for c in CASES],
                ids=lambda p: f"world{p[0]}-{p[1]}")
def dp_run(request, tmp_path_factory):
    n, case = request.param
    cfg, prelude, epoch = CASES[case]
    batches, jitters = _batches_and_jitters(cfg, epoch, prelude)
    spec = _spec(cfg, prelude, epoch, batches, jitters)
    single = entry.data_parallel_run(None, spec)
    ranks = run_ranks(n, WORKER, spec, "cpu", str(tmp_path_factory.mktemp(f"dp{n}{case}")))
    return dict(n=n, case=case, single=single, ranks=ranks, spec=spec)


def _acts(run, do):
    return [a for a in run["actions"] if a["do"] == do]


def test_dp_losses_match_single_process(dp_run):
    for r in dp_run["ranks"]:
        for a_dp, a_1 in zip(_acts(r, "step") + _acts(r, "grads"),
                             _acts(dp_run["single"], "step") + _acts(dp_run["single"], "grads")):
            for got, ref in zip(a_dp["losses"], a_1["losses"]):
                assert sorted(got) == sorted(ref)
                for k in ref:
                    np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7,
                                               err_msg=f"{dp_run['case']} rank {r['rank']} {k}")


def test_dp_gradients_match_single_process(dp_run):
    ref = _acts(dp_run["single"], "grads")[0]["grads"]
    for r in dp_run["ranks"]:
        got = _acts(r, "grads")[0]["grads"]
        assert sorted(got) == sorted(ref)
        for name, g in ref.items():
            scale = float(g.abs().max())
            assert float((got[name] - g).abs().max()) <= 1e-6 * max(scale, 1e-30), name
        assert any(float(g.abs().max()) > 0 for g in got.values())


def test_dp_replicas_stay_equal(dp_run):
    """Two masked updates later every rank holds the same parameters bit
    for bit. (Against the single process the second step's losses are held
    above; the parameters themselves are not: Adam's first steps move an
    entry by a full rate whatever its gradient's size, so an entry whose
    gradient is a rounding-level sum moves either way.)"""
    first = _acts(dp_run["ranks"][0], "params")[0]["params"]
    for r in dp_run["ranks"][1:]:
        got = _acts(r, "params")[0]["params"]
        for name in first:
            assert torch.equal(got[name], first[name]), name


def test_dp_stage_and_budget(dp_run):
    """The stage each case claims ran, no rank share overflowed its stated
    buffer, and the truncating case really truncated (the global cap is
    below a ray's count: fewer kept samples than valid ones)."""
    step = _acts(dp_run["ranks"][0], "step")[0]
    label = {"dense_rgb": "ray_dense_rgb", "voxel_packed_panoptic": "voxel_packed_panoptic",
             "packed_truncating": "voxel_packed_panoptic"}[dp_run["case"]]
    assert step["stage"] == label
    for r in dp_run["ranks"]:
        assert _acts(r, "step")[-1]["pack_overflows"] == 0
    if dp_run["case"] == "packed_truncating":
        assert _truncates(dp_run["spec"])


def _truncates(spec) -> bool:
    """Single process: the first microbatch of the first step has more valid
    samples than its packed budget."""
    from pagnerf_tpu_torch.ops import packed
    seen = []
    orig = packed._water_fill_cap

    def spy(counts, num_steps, budget):
        seen.append((int(counts.sum()), budget))
        return orig(counts, num_steps, budget)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(packed, "_water_fill_cap", spy)
        entry.data_parallel_run(None, dict(spec, actions=spec["actions"][:3]))
    return bool(seen) and all(valid > budget for valid, budget in seen)


def test_collective_audit_counts(dp_run):
    """One gradient bucket carrying every parameter's elements once; the
    other collectives: the losses (one per key), and per microbatch the
    semantic count (1), the assignment's sums (K x (M - 1) + K + 3K + K),
    the segment votes (K x M + K) and, packed, the count histogram (S)."""
    r = dp_run["ranks"][0]
    step = _acts(r, "step")[0]
    audit = entry.audit_collectives(step, r["param_elements"])
    assert audit["grad_calls"] == 1
    assert audit["param_elements"] == sum(r["param_elements"].values())
    small = audit["small"]
    assert small["losses"] == {"calls": 1, "elements": len(step["losses"][0])}
    micro = 2
    if dp_run["case"] == "dense_rgb":
        # the panoptic parts have no gradient in an RGB stage
        panoptic = ("nef.delta_grid", "nef.decoder_semantics", "nef.decoder_inst")
        assert audit["grad_elements"] == sum(n for name, n in r["param_elements"].items()
                                             if not name.startswith(panoptic))
        assert set(small) == {"losses"}
        return
    assert audit["grad_elements"] == audit["param_elements"]
    pipe, ds = entry.flagship(tiny=True, device="cpu")
    k, m = ds.semantic_info["num_instances"], ds.semantic_info["num_instances"]
    assert small["sem_count"] == {"calls": micro, "elements": micro}
    assert small["assign_sums"] == {"calls": micro,
                                    "elements": micro * (k * (m - 1) + k + 3 * k + k)}
    assert small["segment_votes"] == {"calls": micro, "elements": micro * (k * m + k)}
    assert small["any_wrong"] == {"calls": micro, "elements": micro}
    steps = _stage_steps(dp_run["spec"])
    assert small["pack_hist"] == {"calls": micro, "elements": micro * steps}
    assert audit["largest_small"] < 4096


def _stage_steps(spec) -> int:
    pipe, ds = entry.flagship(tiny=True, device="cpu")
    t = PanopticTrainer(pipe.requires_grad_(True), ds, TrainerConfig(**spec["cfg"]),
                        occ_level=5)
    return t.stage_for_epoch(2).num_steps


# ------------------------------------------------------ fused, host-local
@pytest.fixture(scope="module")
def small_case():
    cfg, prelude, epoch = CASES["voxel_packed_panoptic"]
    batches, jitters = _batches_and_jitters(cfg, epoch, prelude)
    return cfg, prelude, epoch, batches, jitters


def test_dp_fused_step_matches_dp_host_loop(small_case, tmp_path):
    cfg, prelude, epoch, batches, jitters = small_case
    steps = [{"do": "step", "epoch": epoch, "batch": b, "jitters": j}
             for b, j in zip(batches, jitters)]
    spec = _spec(cfg, prelude, epoch, batches, jitters)
    host = dict(spec, actions=list(prelude) + steps + [{"do": "params"}])
    fused = dict(spec, actions=list(prelude) + [dict(s, fused=True) for s in steps]
                 + [{"do": "params"}])
    a = run_ranks(2, WORKER, host, "cpu", str(tmp_path / "host"))
    b = run_ranks(2, WORKER, fused, "cpu", str(tmp_path / "fused"))
    for ra, rb in zip(a, b):
        assert [s["losses"] for s in _acts(ra, "step")] == [s["losses"] for s in _acts(rb, "step")]
        pa, pb = _acts(ra, "params")[0]["params"], _acts(rb, "params")[0]["params"]
        for name in pa:
            assert torch.equal(pa[name], pb[name]), name
        assert [e["stage"] for e in rb["fused_log"]] == ["voxel_packed_panoptic"]


def test_host_local_batches_match_global_batch(small_case, tmp_path):
    """Each rank gives ``shard_ray_batch_host_local`` only its own rays; the
    step equals the single process's on the union (the ranks' rays in rank
    order)."""
    cfg, prelude, epoch, batches, jitters = small_case
    n = 2
    local = [{k: (v[:, r * RAYS // n:(r + 1) * RAYS // n]
                  if k in sharding.RAY_SHARDED_KEYS and np.ndim(v) >= 2 else v)
              for k, v in batches[0].items()} for r in range(n)]
    spec = _spec(cfg, prelude, epoch, batches, jitters)
    dp = dict(spec, actions=list(prelude) + [
        {"do": "step", "epoch": epoch, "local_batches": local, "jitters": jitters[0]}])
    one = dict(spec, actions=list(prelude) + [
        {"do": "step", "epoch": epoch, "batch": batches[0], "jitters": jitters[0]}])
    ref = _acts(entry.data_parallel_run(None, one), "step")[0]["losses"][0]
    for r in run_ranks(n, WORKER, dp, "cpu", str(tmp_path / "hl")):
        got = _acts(r, "step")[0]["losses"][0]
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_epoch_checkpoint_and_validation_as_single_process(small_case, tmp_path):
    """``run_epoch`` under the group (global batches from the shared
    generator), a checkpoint written by rank 0 and loaded by every rank,
    a step after it, then a validation on rank 0 only: the losses equal the
    single process's, rank 0's metrics too."""
    cfg, prelude, epoch, batches, jitters = small_case
    spec = _spec(cfg, prelude, epoch, batches, jitters)

    def acts(path):
        return list(prelude) + [
            {"do": "epoch", "epoch": epoch},
            {"do": "save", "path": path, "epoch": epoch + 1},
            {"do": "load", "path": path},
            {"do": "step", "epoch": epoch, "batch": batches[1], "jitters": jitters[1]},
            {"do": "validate", "epoch": epoch}]
    ref = entry.data_parallel_run(None, dict(spec, actions=acts(str(tmp_path / "one.ckpt"))))
    dp_path = str(tmp_path / "dp.ckpt")
    ranks = run_ranks(2, WORKER, dict(spec, actions=acts(dp_path)), "cpu", str(tmp_path / "ck"))
    assert os.path.exists(dp_path) and not os.path.exists(dp_path + ".tmp")
    saved = torch.load(dp_path, weights_only=True)
    assert saved["epoch"] == epoch + 1
    for r in ranks:
        for do in ("epoch", "step"):
            got, want = _acts(r, do)[0]["losses"][0], _acts(ref, do)[0]["losses"][0]
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                           err_msg=f"{do} {k}")
        assert _acts(r, "epoch")[0]["pack_overflows"] == 0
    metrics = _acts(ranks[0], "validate")[0]["metrics"]
    assert "metrics" not in _acts(ranks[1], "validate")[0]
    want = _acts(ref, "validate")[0]["metrics"]
    assert sorted(metrics) == sorted(want)
    for k in want:
        if "time" not in k:                     # a wall clock, not a result
            np.testing.assert_allclose(metrics[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def run_with_margin(group, spec):
    """A rank's ``entry.data_parallel_run`` with ``PACK_SHARE_MARGIN`` set
    to ``spec["margin"]`` in the rank's process; returns its result and the
    trainer's log records (``spec["margin"]`` is this wrapper's alone)."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger("pagnerf_tpu_torch.train.trainer").addHandler(handler)
    sharding.PACK_SHARE_MARGIN = spec["margin"]
    out = entry.data_parallel_run(group, spec)
    out["log"] = records
    return out


def test_pack_overflow_is_counted(small_case, tmp_path, monkeypatch):
    """With a buffer of half a rank's B / n the ranks' shares overflow:
    each is cut by its local water-fill and counted, the step still runs
    (its losses differ from the single process's, as said), and the
    epoch's readback logs the count."""
    cfg, prelude, epoch, batches, jitters = small_case
    spec = dict(_spec(cfg, prelude, epoch, batches, jitters), margin=0.5)
    spec["actions"] = list(prelude) + [
        {"do": "step", "epoch": epoch, "batch": batches[0], "jitters": jitters[0]},
        {"do": "epoch", "epoch": epoch}]
    # the ranks import this module for ``run_with_margin``
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [TESTS] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    ranks = run_ranks(2, "test_torch_sharding:run_with_margin", spec, "cpu",
                      str(tmp_path / "ov"))
    for r in ranks:
        step, ep = _acts(r, "step")[0], _acts(r, "epoch")[0]
        assert step["pack_overflows"] > 0
        assert np.isfinite(step["losses"][0]["total_loss"])
        assert ep["pack_overflows"] > step["pack_overflows"]
        assert len(r["log"]) == 1 and "overflowed the rank's buffer" in r["log"][0]
        assert f"({ep['pack_overflows']} so far)" in r["log"][0]


# ----------------------------------------------------------- against JAX
def test_dp_step_matches_jax_sharded_step(tmp_path):
    """The JAX package's sharded step (8-device CPU mesh, ray axis split,
    its dryrun's config) against the port's 2- and 4-rank steps from the
    converted weights, the same batch and the jitter the JAX step drew."""
    cfg = dict(BASE, num_rays_sampled_per_img=RAYS)
    pipe_j, ds_j = graft._flagship(tiny=True)
    pipe_j.nef = pipe_j.nef.clone(compute_dtype_name="float32")
    tj = TrainerJ(pipe_j, ds_j, CfgJ(**cfg), OptJ(), occ_level=4)
    stage = tj.stage_for_epoch(0)
    batch = ds_j.sample_batch(np.random.default_rng(0), cfg["batch_size"], RAYS)
    params0, key = tj.params, tj._step_key
    jitters = []
    for _ in range(batch["imgs"].shape[0]):
        key, k = jax.random.split(key)
        jitters.append(np.array(jax.random.uniform(k, (RAYS, stage.num_steps))))
    mesh = make_mesh(8)
    with mesh:
        tj.params = replicate_tree(tj.params, mesh)
        tj.opt_state = replicate_tree(tj.opt_state, mesh)
        tj.occ = replicate_tree(tj.occ, mesh)
        tj.lod_w = replicate_tree(tj.lod_w, mesh)
        losses_j = {k: float(v) for k, v in tj.train_step(stage, shard_j(batch, mesh)).items()}
    spec = {"tiny": True, "device": "cpu", "compute_dtype": "float32", "occ_level": 4,
            "cfg": cfg, "params": params_from_flax(jax.tree_util.tree_map(np.asarray, params0)),
            "actions": [{"do": "step", "epoch": 0, "batch": batch, "jitters": jitters}]}
    for n in (2, 4):
        for r in run_ranks(n, WORKER, spec, "cpu", str(tmp_path / f"jax{n}")):
            got = _acts(r, "step")[0]["losses"][0]
            assert sorted(got) == sorted(losses_j)
            for k, v in losses_j.items():
                # test_torch_train.py's float32 tolerance: atol 1e-5, and
                # rtol 1e-6 for total_loss (the instance loss weighs 1000)
                if k == "total_loss":
                    np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
                else:
                    np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)


# ------------------------------------------------------------- host side
def _fake_group(world=8, rank=0):
    return sharding.RayGroup(rank=rank, world=world, device=torch.device("cpu"),
                             backend="gloo")


def test_make_group_refuses_too_many_devices(tmp_path):
    with pytest.raises(ValueError, match="requested a 100000-rank group"):
        sharding.make_group(100000, 0, "file://" + str(tmp_path / "r"), "cpu")
    with pytest.raises(ValueError, match="needs device='cuda'"):
        sharding.make_group(2, 0, "file://" + str(tmp_path / "r"), "cpu", ranks_per_device=2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 device"):
            sharding.make_group(2, 0, "file://" + str(tmp_path / "r"), "cuda")


def test_shard_ray_batch_refuses_indivisible_and_mis_sized():
    g = _fake_group(8)
    with pytest.raises(ValueError, match="not divisible by the 8-rank group"):
        sharding.shard_ray_batch({"imgs": np.zeros((2, 31, 3), np.float32)}, g)
    with pytest.raises(ValueError, match="expected the ray count 32"):
        sharding.shard_ray_batch({"imgs": np.zeros((2, 32, 3), np.float32),
                                  "depths": np.zeros((2, 16), np.float32)}, g)
    with pytest.raises(ValueError, match="no recognised ray-mode array"):
        sharding.shard_ray_batch({"cam_idx": np.zeros(2, np.int32)}, g)
    with pytest.raises(ValueError, match="expected the local ray count 4"):
        sharding.shard_ray_batch_host_local({"imgs": np.zeros((2, 4, 3), np.float32),
                                             "depths": np.zeros((2, 5), np.float32)}, g)


def test_shard_ray_batch_dispatches_by_key():
    """Ray-sharded keys are split; a per-image [B, R, 4, 4] array whose axis
    1 equals the ray count stays whole, as do cam_idx and unknown keys."""
    r = 8
    batch = {"imgs": np.arange(2 * r * 3).reshape(2, r, 3).astype(np.float32),
             "base_rays_dirs": np.random.default_rng(0).normal(size=(2, r, 3)),
             "view_mats": np.zeros((2, r, 4, 4)), "cam_idx": np.array([3, 1], np.int32)}
    for rank in range(4):
        g = _fake_group(4, rank)
        sb = sharding.shard_ray_batch(batch, g)
        sl = slice(rank * 2, rank * 2 + 2)
        assert np.array_equal(sb["imgs"], batch["imgs"][:, sl])
        assert np.array_equal(sb["base_rays_dirs"], batch["base_rays_dirs"][:, sl])
        assert sb["view_mats"].shape == (2, r, 4, 4) and np.array_equal(sb["cam_idx"], [3, 1])
        assert sb.ray_len_global == r and sb.ray_slice == sl
        hl = sharding.shard_ray_batch_host_local(dict(sb), g)
        assert hl.ray_len_global == r and hl.ray_slice == sl
        jit = torch.arange(2 * r * 5, dtype=torch.float32).reshape(2 * r, 5)
        rows = sharding.local_rows(jit, sb)
        assert torch.equal(rows, jit.reshape(2, r, 5)[:, sl].reshape(-1, 5))


def test_share_buffer_and_buckets(monkeypatch):
    g = _fake_group(4)
    assert g.share_buffer(100) == 128 and g.share_buffer(8) == 16
    monkeypatch.setattr(sharding, "PACK_SHARE_MARGIN", 10.0)
    assert g.share_buffer(100) == 400            # at most the global budget
    ts = [torch.zeros(5), torch.zeros(3), torch.zeros(2, dtype=torch.int64), torch.zeros(20),
          torch.zeros(1)]
    assert list(sharding._buckets(ts, 10)) == [[0, 1], [2], [3], [4]]


def test_trainer_refusals():
    pipe, ds = entry.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    pipe.requires_grad_(True)
    t = PanopticTrainer(pipe, ds, TrainerConfig(**BASE), occ_level=4)
    t.group = dataclasses.replace(_fake_group(2), device=torch.device("cuda"))
    t.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="gloo collectives cannot be captured"):
        t.fused_train_step(t.stage_for_epoch(0), {})


def test_dryrun_multichip_on_cpu(tmp_path):
    res = entry.dryrun_multichip(2, device="cpu", tiny=True, workdir=str(tmp_path),
                                 sweep_steps=1)
    assert res["backend"] == "gloo" and res["devices"] == ["cpu", "cpu"]
    assert res["audit"]["grad_elements"] == res["audit"]["param_elements"]
    assert res["audit"]["largest_small"] < 4096
    assert [s["n"] for s in res["sweep"]] == [1, 2, 4][:len(res["sweep"])]
    assert len(res["sweep"]) >= 2 and all(s["step_ms"] > 0 for s in res["sweep"])
