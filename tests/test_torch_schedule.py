"""The flagship's stage schedule and epoch loop at tiny shapes, against the
JAX ``PanopticTrainer`` of ``__graft_entry__._flagship(tiny=True)``, on the
CPU.

- ``stage_for_epoch`` equals the JAX package's ``StageConfig`` field for
  field: at every epoch of a tiny schedule, at the packed and compacted
  budgets of several occupied shares, and over all 800 epochs of the default
  ``TrainerConfig`` walked with the prune flags set as the prune sets them
  (the port refuses none of them).
- A 12-epoch run through ``run_epoch`` on both sides: RGB with the ray march
  (epochs 0-4), a seed prune at the start of epoch 2, the voxel march from
  epoch 5, the panoptic heads from epoch 6, a real prune after epoch 8 (the
  packed layout in every stage built after it), and a val-pose epoch at 10.
  The port draws the JAX trainer's keys (each microbatch's jitter, each
  prune sample's cell jitter) and samples the same numpy batches. Both
  datasets draw their distinct rays from the numpy stream ``numpy_rays``
  (the JAX package's fallback), not from the C++ sampler both use by
  default: this fixture's field is stiff (tables x 1000), and on the C++
  stream the first Adam step after the real prune's moment reset (epoch
  9) moves a coarse table entry whose gradient is a cancelling sum
  (-1.4e-3 in JAX, +1.9e-4 in the port, whose tables differ by up to 4e-4
  after epoch 8) by a
  full step of opposite sign, which a trajectory of 12 epochs cannot hold
  to 1e-4. Checked per epoch: the
  stage, each mean loss within 1e-4 relative, the occupied share, and the
  occupancy mask, exactly where the two accumulators are bit-equal; a cell
  whose accumulated density differs may flip only where it crosses the
  threshold, and the mask may differ only within the prune's dilation reach
  of such a cell.

The JAX trainer runs jitted, except its march (``raymarch``), whose values
are computed op by op, as the package's functions define them, and whose
gradient is the march's own, traced into the step (``op_by_op_march``).
Inside one jitted program XLA fuses ``a * b + c`` into one fused
multiply-add and turns a division by a constant into a product with its
reciprocal, so a voxel probe or a sample within an ulp of a cell face can
land on the other side of it than the package's ops put it (the synthetic
camera ring has whole rows of rays near cell faces: a quarter of a voxel
epoch's rays have a probe or a sample within 4 ulp of one). The port
repeats the ops, as eager JAX computes them.

Fixture: the random init is made a field the prune can split. The tables
are scaled by 1000 (features of ~0.1), the density head's output bias is
2.9 and its weights x10, so the untrained density straddles the prune
threshold (2.956).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.data import native as native_j
from pagnerf_tpu.models import tracer as tracer_j
from pagnerf_tpu.ops.occupancy import OccupancyGrid as OccJ
from pagnerf_tpu.ops.raymarch import RaymarchResult as RaymarchResultJ
from pagnerf_tpu.train.optimizer import OptimizerConfig as OptJ
from pagnerf_tpu.train.trainer import PanopticTrainer as TrainerJ
from pagnerf_tpu.train.trainer import TrainerConfig as CfgJ
from pagnerf_tpu_torch import entry as entry_t
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.data import native as native_t
from pagnerf_tpu_torch.ops.occupancy import MIN_DENSITY
from pagnerf_tpu_torch.train.optimizer import OptimizerConfig
from pagnerf_tpu_torch.train.trainer import PanopticTrainer, TrainerConfig

OCC_LEVEL = 4
CFG = TrainerConfig(epochs=12, batch_size=6, num_rays_sampled_per_img=32,
                    micro_batch_imgs=1, seed_prune_epoch=2, prune_every=8,
                    prune_dilate=0, voxel_raymarch_epoch_start=4,
                    sem_epoch_start=6, inst_epoch_start=6)


class JaxDraws:
    """The JAX trainer's draws: split its step key, then uniforms of the
    asked shape from the new key (a microbatch's jitter, a prune sample's
    cell jitter)."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed + 1)

    def __call__(self, shape):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(k, tuple(shape))))


def fixture_params(params):
    """The test's field (module docstring): numpy copy of a flax tree."""
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    for g in ("grid", "delta_grid"):
        p["nef"][g]["tables"] *= 1000.0
    lout = p["nef"]["decoder_density"]["lout"]
    lout["bias"][0] = 2.9
    lout["kernel"][:, 0] *= 10.0
    return p


def op_by_op_march(raymarch_j):
    """The JAX package's ``raymarch`` with its values computed op by op,
    outside the caller's jit (a host callback), and its gradient in the ray
    origins and directions from the same function traced into the caller."""
    def march(rays, occ, num_steps, raymarch_type="ray",
              ray_max_travel=float("inf"), key=None):
        def run(o, d, dmin, dmax, mask, k=None):
            rm = raymarch_j(RaysJ(origins=o, dirs=d, dist_min=dmin, dist_max=dmax),
                            OccJ(occupancy=jnp.zeros((1,), jnp.float32), mask=mask,
                                 level=occ.level),
                            num_steps, raymarch_type, ray_max_travel, key=k)
            return rm.positionsT, rm.depths, rm.deltas, rm.t0, rm.span, rm.mask

        n, s = rays.origins.shape[0], num_steps
        sds = jax.ShapeDtypeStruct
        shapes = (sds((3, n, s), jnp.float32), sds((n, s), jnp.float32),
                  sds((n, s), jnp.float32), sds((n,), jnp.float32),
                  sds((n,), jnp.float32), sds((n, s), jnp.bool_))
        extra = (rays.dist_min, rays.dist_max, occ.mask) + (() if key is None else (key,))

        def eager(*args):
            with jax.disable_jit():
                return tuple(np.asarray(x) for x in run(*args))

        @jax.custom_vjp
        def values(o, d):
            return jax.pure_callback(eager, shapes, o, d, *extra)

        def fwd(o, d):
            return values(o, d), (o, d)

        def bwd(res, g):
            _, vjp = jax.vjp(lambda o, d: run(o, d, *extra)[:5], *res)
            return vjp(g[:5])

        values.defvjp(fwd, bwd)
        positionsT, depths, deltas, t0, span, mask = values(rays.origins, rays.dirs)
        return RaymarchResultJ(positionsT=positionsT, depths=depths, deltas=deltas,
                               mask=mask, t0=t0, span=span)
    return march


def _trainers(cfg: TrainerConfig):
    pipe_j, ds_j = graft._flagship(tiny=True)
    pipe_j.nef = pipe_j.nef.clone(compute_dtype_name="float32")
    tj = TrainerJ(pipe_j, ds_j, CfgJ(**dataclasses.asdict(cfg)), OptJ(),
                  occ_level=OCC_LEVEL)
    p = fixture_params(tj.params)
    tj.params = jax.tree_util.tree_map(jnp.asarray, p)
    tj.opt_state = tj.tx.init(tj.params)
    pipe_t, ds_t = entry_t.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    pipe_t.load_state_dict(params_from_flax(p))
    pipe_t.requires_grad_(True)
    tt = PanopticTrainer(pipe_t, ds_t, cfg, OptimizerConfig(), occ_level=OCC_LEVEL,
                         draw=JaxDraws(cfg.seed))
    return tj, tt


def numpy_rays(batch, num_rays, num_pixels, seed):
    """The JAX package's numpy sampler (its fallback when the C++ library
    is absent)."""
    rng = np.random.default_rng(seed)
    if num_rays > num_pixels:
        return rng.integers(0, num_pixels, (batch, num_rays)).astype(np.int64)
    return np.stack([rng.choice(num_pixels, num_rays, replace=False)
                     for _ in range(batch)]).astype(np.int64)


@pytest.fixture(scope="module")
def run():
    """Both trainers through CFG.epochs epochs; one record per epoch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_j, "sample_ray_indices", numpy_rays)
        mp.setattr(native_t, "sample_ray_indices", numpy_rays)
        mp.setattr(tracer_j, "raymarch", op_by_op_march(tracer_j.raymarch))
        tj, tt = _trainers(CFG)
        records = []
        for epoch in range(CFG.epochs):
            losses_j = tj.run_epoch(epoch)
            losses_t = tt.run_epoch(epoch)
            records.append(dict(
                epoch=epoch, stage_j=tj.stage_for_epoch(epoch),
                stage_t=tt.stage_for_epoch(epoch), losses_j=losses_j, losses_t=losses_t,
                pruned=tj.should_prune(epoch) or epoch == CFG.seed_prune_epoch,
                occ_j=np.array(tj.occ.occupancy), mask_j=np.array(tj.occ.mask),
                occ_t=tt.occ.occupancy.numpy(), mask_t=tt.occ.mask.numpy(),
                frac_j=getattr(tj, "_occ_frac", 0.25), frac_t=tt._occ_frac))
    return records


def test_run_stage_sequence_matches_jax(run):
    for r in run:
        assert dataclasses.asdict(r["stage_t"]) == dataclasses.asdict(r["stage_j"]), r["epoch"]
    stages = [r["stage_t"] for r in run]
    # the run covers every transition of the slice
    assert [s.raymarch_type for s in stages] == ["ray"] * 5 + ["voxel"] * 7
    assert [s.training_val_poses for s in stages] == [e == 10 for e in range(12)]
    assert stages[0].pack_steps == 0 and stages[2].num_steps == 16
    assert all(s.pack_steps > 0 for s in stages[9:])        # after the real prune
    assert stages[6].use_sem and stages[6].use_inst and not stages[10].use_sem
    assert [r["epoch"] for r in run if r["pruned"]] == [2, 8]


def test_run_losses_match_jax(run):
    for r in run:
        lj, lt = r["losses_j"], r["losses_t"]
        assert sorted(lt) == sorted(lj), r["epoch"]
        for k in lj:
            assert np.isfinite(lt[k])
            np.testing.assert_allclose(lt[k], lj[k], rtol=1e-4,
                                       err_msg=f"epoch {r['epoch']} {k}")


def test_run_occupancy_matches_jax(run):
    """Masks equal where the accumulators are bit-equal; elsewhere a flip is
    a threshold tie, counted and bounded."""
    for r in run:
        assert r["frac_t"] == r["frac_j"], r["epoch"]
        if not r["pruned"]:
            assert np.array_equal(r["mask_t"], r["mask_j"]), r["epoch"]
            continue
        same = r["occ_t"].view(np.int32) == r["occ_j"].view(np.int32)
        thr = np.float32(MIN_DENSITY)
        ties = ~same & ((r["occ_t"] > thr) != (r["occ_j"] > thr))
        assert ties.sum() <= 0.01 * ties.size, r["epoch"]
        differ = r["mask_t"] != r["mask_j"]
        res = 1 << OCC_LEVEL
        reach = ties.reshape(res, res, res)
        dilate = CFG.prune_dilate + (1 if r["epoch"] == CFG.seed_prune_epoch else 0)
        for _ in range(dilate):
            reach = torch.nn.functional.max_pool3d(
                torch.from_numpy(reach.astype(np.float32))[None, None], 3, 1, 1)[0, 0] \
                .numpy() > 0
        assert not (differ & ~reach.reshape(-1)).any(), r["epoch"]
    kept = [r["frac_t"] for r in run if r["pruned"]]
    assert 0.05 < kept[-1] < kept[0] < 1.0         # the prunes really cut


# ---------------------------------------------------------------- stages
def _stage_pair(cfg: TrainerConfig, occ_level: int = 7):
    pipe_j, ds_j = graft._flagship(tiny=True)
    tj = TrainerJ(pipe_j, ds_j, CfgJ(**dataclasses.asdict(cfg)), OptJ(),
                  occ_level=occ_level)
    pipe_t, ds_t = entry_t.flagship(tiny=True, device="cpu")
    pipe_t.requires_grad_(True)
    return tj, PanopticTrainer(pipe_t, ds_t, cfg, OptimizerConfig(), occ_level=occ_level)


def _set_pruned(trainers, pruned: bool, frac: float):
    for t in trainers:
        t._pruned = pruned
        t._occ_frac = frac


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "compacted"])
def test_stage_budgets_match_jax(packed):
    cfg = dataclasses.replace(CFG, packed_compaction=packed, epochs=40)
    tj, tt = _stage_pair(cfg, OCC_LEVEL)
    for frac in (0.02, 0.1, 0.3, 0.45, 0.8, 0.95):
        for pruned in (False, True):
            _set_pruned((tj, tt), pruned, frac)
            for epoch in range(cfg.epochs):
                sj, st = tj.stage_for_epoch(epoch), tt.stage_for_epoch(epoch)
                assert dataclasses.asdict(st) == dataclasses.asdict(sj), (frac, pruned, epoch)
    # the compacted layout also takes an explicit budget
    cfg = dataclasses.replace(cfg, compact_steps_after_prune=8)
    tj, tt = _stage_pair(cfg, OCC_LEVEL)
    _set_pruned((tj, tt), True, 0.95)
    assert dataclasses.asdict(tt.stage_for_epoch(30)) == dataclasses.asdict(tj.stage_for_epoch(30))
    assert tt.stage_for_epoch(30).compact_steps == 8


def test_default_schedule_no_epoch_refused():
    """All 800 epochs of the default TrainerConfig, with the prune flags set
    as the prune sets them from epoch 201 on: the port refuses none, and
    each stage equals the JAX package's."""
    tj, tt = _stage_pair(TrainerConfig())
    seen = set()
    for epoch in range(tt.cfg.epochs):
        if epoch == 202:                 # the prune ran after epoch 201
            _set_pruned((tj, tt), True, 0.08)
        st = tt.stage_for_epoch(epoch)
        assert dataclasses.asdict(st) == dataclasses.asdict(tj.stage_for_epoch(epoch)), epoch
        seen.add((st.raymarch_type, st.num_steps, st.pack_steps, st.training_val_poses,
                  st.use_sem))
    assert ("voxel", 256, 24, False, True) in seen and ("voxel", 256, 24, True, False) in seen
    assert ("ray", 16, 0, True, False) in seen and ("ray", 16, 0, False, False) in seen
    assert [e for e in range(800) if tt.should_prune(e)] == [201, 402, 603]


def test_should_prune_and_seed_prune_match_jax():
    cfg = dataclasses.replace(CFG, seed_refresh_every=3, prune_every=9, epochs=20)
    tj, tt = _stage_pair(cfg, 3)
    calls = {"j": [], "t": []}
    tj.prune = lambda **kw: (calls["j"].append(kw), setattr(tj, "_pruned", True),
                             kw.get("seed") or setattr(tj, "_real_pruned", True))
    tt.prune = lambda **kw: (calls["t"].append(kw), setattr(tt, "_pruned", True),
                             kw.get("seed") or setattr(tt, "_real_pruned", True))
    for epoch in range(cfg.epochs):
        tj.maybe_seed_prune(epoch)
        tt.maybe_seed_prune(epoch)
        assert tt.should_prune(epoch) == tj.should_prune(epoch)
        if tj.should_prune(epoch):
            tj.prune()
            tt.prune()
    assert calls["t"] == calls["j"] and len(calls["t"]) == 5   # 2, 5, 8 seed; 9, 18
    assert copy.deepcopy(calls["t"][1]) == {"seed": True, "keep_frac": 0.02, "refresh": True}


@pytest.mark.parametrize("changes, want", [
    ({}, [601, 602, 603, 610]),
    ({"sem_epoch_start": 300, "inst_epoch_start": 300, "val_extrinsics_every": 7},
     [300, 302, 303, 308]),
    ({"prune_every": 150, "voxel_raymarch_epoch_start": 150, "sem_epoch_start": 0,
      "inst_epoch_start": 0}, [151, 152, 153, 160]),
])
def test_post_prune_epochs_follow_the_config(changes, want):
    """The schedule entry's epochs come from the trainer's schedule: the
    first panoptic voxel epochs past the first real prune (val-pose epochs
    skipped), then the next val-pose epoch."""
    _, tt = _stage_pair(dataclasses.replace(TrainerConfig(), **changes))
    assert entry_t.post_prune_epochs(tt, 3, 1) == want
    stages = [tt.stage_for_epoch(e) for e in want]
    assert all(st.use_sem and st.raymarch_type == "voxel" for st in stages[:3])
    assert stages[3].training_val_poses and not stages[3].use_sem


def test_train_flagship_schedule_tiny_on_cpu():
    """The schedule entry at the tiny size on the CPU: the real prune, the
    scene fixture's occupancy (64^3 grid), two panoptic steps and one
    val-pose step on the voxel march and the packed layout."""
    trainer, log = entry_t.train_flagship_schedule(steps=2, device="cpu", tiny=True)
    prune, steps = log[0], log[1:]
    assert prune["prune"] and trainer._real_pruned and trainer.occ.res == 64
    assert 0.01 <= trainer._occ_frac <= 0.40
    assert [s["epoch"] for s in steps] == [601, 602, 610]
    for s in steps:
        st = s["stage"]
        assert st.raymarch_type == "voxel" and 0 < st.pack_steps < st.num_steps
        assert all(np.isfinite(v) for v in s["losses"].values())
    assert all({"semantics", "inst_embedding"} <= s["stage"].channels for s in steps[:2])
    assert steps[2]["stage"].training_val_poses and set(steps[2]["losses"]) == {
        "rgb_loss", "total_loss"}
