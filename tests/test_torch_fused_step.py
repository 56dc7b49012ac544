"""The fused training step, ``dispatch_ahead`` and the optimizer's device
flag of the port, on the CPU at tiny shapes.

- ``fused_micro_step`` against the JAX trainer's fused step
  (``__graft_entry__._flagship(tiny=True)`` at float32, converted
  parameters, ``PAGNERF_FUSED_STEP`` unset): one step of each stage -- dense
  RGB, packed RGB after a prune, voxel packed panoptic, val-pose -- with 3
  microbatches, from the same state (the occupancy set on both sides), the
  same numpy batch and the jitter of the JAX trainer's keys. Losses within
  ``tests/test_torch_train.py``'s tolerances (atol 1e-5; ``total_loss``
  rtol 1e-6 with atol 1e-5); Adam's first moment, 0.1 times the step's
  averaged gradient, within that file's gradient tolerance (rtol 1e-4, atol
  1e-6 of the largest gradient entry where above 1) times 0.1; the counts
  equal; a frozen parameter bit-equal to its value before. The JAX march is
  run op by op, its values and its gradient (``eager_march``): inside the
  jitted step XLA's fused multiply-adds move the voxel march's samples near
  cell faces (``tests/test_torch_schedule.py``), and in the val-pose stage
  that moves the extrinsics' gradient of a camera by up to 5% (the JAX
  package's own step run eagerly agrees with the port within 6e-8).
- The fused step against the port's own host loop, bit for bit: two steps of
  each stage from one state, parameters, moments, counts and losses.
- A guard that the fused step reads nothing back from the device:
  ``Tensor.item``, ``__bool__``, ``__float__``, ``__int__``, ``__index__``,
  ``__array__``, ``cpu``, ``numpy`` and ``tolist`` raise during the step,
  except inside ``lap_assign_plain``, which on the CPU stands in for the
  card's assignment kernel (it reads its argmins back; the kernel does not).
- ``run_epoch`` with ``dispatch_ahead`` 0, 1 and 4: equal epoch totals.
- ``PAGNERF_FUSED_STEP`` read as the JAX trainer reads it.
- The optimizer's device flag: a non-finite step leaves parameters, moments
  and counts bit-equal (compared with copies), the rate after a skipped
  step is the schedule's at the unchanged count, counts survive a
  checkpoint, frozen leaves keep their values and moments, and a run past
  the rate tables grows them with the schedule's values.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pagnerf_tpu.models import tracer as tracer_j
from pagnerf_tpu.ops.occupancy import OccupancyGrid as OccJ
from pagnerf_tpu.train.optimizer import OptimizerConfig as OptJ
from pagnerf_tpu.train.trainer import PanopticTrainer as TrainerJ
from pagnerf_tpu.train.trainer import TrainerConfig as CfgJ
from pagnerf_tpu_torch import entry as entry_t
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.ops import assignment
from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid
from pagnerf_tpu_torch.train import checkpoint as ckpt_t
from pagnerf_tpu_torch.train import optimizer as opt_t
from pagnerf_tpu_torch.train.optimizer import OptimizerConfig
from pagnerf_tpu_torch.train.trainer import PanopticTrainer, TrainerConfig
from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.ops.raymarch import RaymarchResult as RaymarchResultJ

torch.set_num_threads(1)

RAYS, OCC_LEVEL, MICRO = 32, 4, 3
# the stages of chip_smoke.py's CLI_FLAGS at the tiny size: epoch 0 dense
# RGB, 1 packed RGB (after a prune), 2 voxel packed panoptic, 3 val-pose
CFG = TrainerConfig(epochs=4, batch_size=MICRO, num_rays_sampled_per_img=RAYS,
                    micro_batch_imgs=1, voxel_raymarch_epoch_start=1, sem_epoch_start=2,
                    inst_epoch_start=2, optimize_val_extrinsics=True,
                    val_extrinsics_start=3, val_extrinsics_every=3, prune_every=-1)
STAGES = {"ray_dense_rgb": (0, False), "ray_packed_rgb": (1, True),
          "voxel_packed_panoptic": (2, True), "val_pose": (3, True)}
OPT = dict(clip_grad_norm=100.0, use_lr_scheduler=True, lr_step_size=1,
           lr_step_gamma=0.5)


def _occupancy():
    """A ball of cells (radius 0.7): the occupancy a prune leaves."""
    res = 2 ** OCC_LEVEL
    c = (np.arange(res) + 0.5) / res * 2 - 1
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    mask = (x * x + y * y + z * z < 0.49).reshape(-1)
    return np.where(mask, 10.0, 0.0).astype(np.float32), mask


def _prune_state(t, pruned: bool) -> None:
    if not pruned:
        return
    occ, mask = _occupancy()
    t.occ = OccupancyGrid(occupancy=torch.from_numpy(occ), mask=torch.from_numpy(mask),
                          level=OCC_LEVEL)
    t._pruned, t._occ_frac = True, float(mask.mean())


def _trainer(fused: bool, pruned: bool, cfg: TrainerConfig = CFG):
    pipe, ds = entry_t.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    pipe.requires_grad_(True)
    t = PanopticTrainer(pipe, ds, dataclasses.replace(cfg, fused_micro_step=fused),
                        OptimizerConfig(**OPT), occ_level=OCC_LEVEL)
    _prune_state(t, pruned)
    return t


def _batch(t, epoch: int, seed: int):
    split = "val" if t.stage_for_epoch(epoch).training_val_poses else "train"
    return t.dataset.sample_batch(np.random.default_rng(seed), MICRO, RAYS, split)


def _state(t):
    return ({n: p.detach().clone() for n, p in t.params.items()},
            {n: m.clone() for n, m in t.opt.mu.items()},
            {n: m.clone() for n, m in t.opt.nu.items()}, t.opt.count)


def _assert_bit_equal(a, b, what):
    for da, db in zip(a[:3], b[:3]):
        assert da.keys() == db.keys()
        for n in da:
            assert torch.equal(da[n], db[n]), f"{what}: {n}"
    assert a[3] == b[3], what


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("PAGNERF_FUSED_STEP", raising=False)


# ----------------------------------------------------------- host loop
@pytest.mark.parametrize("stage", list(STAGES))
def test_fused_step_equals_host_loop_bit_for_bit(stage):
    epoch, pruned = STAGES[stage]
    runs = {}
    for fused in (False, True):
        t = _trainer(fused, pruned)
        st = t.stage_for_epoch(epoch)
        assert st.label == stage
        batches = [_batch(t, epoch, seed) for seed in (1, 2)]
        losses = [t.train_step(st, b) for b in batches]
        runs[fused] = (_state(t), losses, t)
    _assert_bit_equal(runs[False][0], runs[True][0], stage)
    for lh, lf in zip(runs[False][1], runs[True][1]):
        assert lh.keys() == lf.keys()
        assert all(torch.equal(lh[k], lf[k]) for k in lh), stage
    t = runs[True][2]
    # one entry of static buffers per key: the microbatches' anchor pattern
    anchor = t.pipeline.anchor_host
    keys = {tuple(bool(anchor[c]) for c in b["cam_idx"]) for b in batches}
    assert len(t._fused) == len(keys) and t.global_step == 2
    assert t.opt.count["grid"] == 2


def test_fused_step_takes_given_jitter_and_tv_normals():
    """``jitters`` replace the generator's uniforms and the TV windows'
    normals come from the generator in the host loop's order."""
    cfg = dataclasses.replace(CFG, grid_tvl1_reg=1e-3, delta_grid_tvl2_reg=1e-3,
                              tv_edge_num_samples=4)
    runs = []
    for fused in (False, True):
        t = _trainer(fused, True, cfg)
        st = t.stage_for_epoch(2)
        jit = [torch.from_numpy(np.random.default_rng(m).random(
            (RAYS, st.num_steps), dtype=np.float32)) for m in range(MICRO)]
        losses = t.train_step(st, _batch(t, 2, 3), jitters=jit)
        runs.append((_state(t), losses, torch.rand(2, generator=t.generator)))
    _assert_bit_equal(runs[0][0], runs[1][0], "tv")
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    # both drew the same number of normals from the generator
    assert torch.equal(runs[0][2], runs[1][2])


# --------------------------------------------------------------- guard
_READS = ("item", "__bool__", "__float__", "__int__", "__index__", "__array__", "cpu",
          "numpy", "tolist")


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    saved = {n: getattr(torch.Tensor, n) for n in _READS}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"the fused step read a tensor back: Tensor.{name}")
        return read

    def forbid():
        for n in _READS:
            setattr(torch.Tensor, n, refuse(n))

    def allow():
        for n in _READS:
            setattr(torch.Tensor, n, saved[n])

    plain = assignment.lap_assign_plain

    def kernel_stand_in(*args, **kwargs):
        allow()
        try:
            return plain(*args, **kwargs)
        finally:
            forbid()

    monkeypatch.setattr(assignment, "lap_assign_plain", kernel_stand_in)
    forbid()
    try:
        yield
    finally:
        allow()


@pytest.mark.parametrize("stage", list(STAGES))
def test_fused_step_reads_nothing_back(stage, monkeypatch):
    epoch, pruned = STAGES[stage]
    t = _trainer(True, pruned)
    st = t.stage_for_epoch(epoch)
    batches = [_batch(t, epoch, seed) for seed in (4, 5)]
    with _no_host_reads(monkeypatch):
        for b in batches:
            losses = t.fused_train_step(st, b)
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert t.opt.count["grid"] == 2
    # the guard catches a read
    with pytest.raises(AssertionError, match="read a tensor back"):
        with _no_host_reads(monkeypatch):
            bool(t.opt.counts[0] > 0)


def test_device_constant_made_under_inference_mode_serves_autograd():
    """A constant first made under ``inference_mode`` (a render) is kept and
    read by a later training step, which autograd must be able to save."""
    from pagnerf_tpu_torch.device import constant
    with torch.inference_mode():
        made = constant(6.0625, torch.float32, "cpu")
    assert not made.is_inference()
    x = torch.tensor([5.0, 7.0], requires_grad=True)
    torch.maximum(x, constant(6.0625, torch.float32, "cpu")).sum().backward()
    assert x.grad.tolist() == [0.0, 1.0]


# --------------------------------------------------------- dispatch_ahead
def test_dispatch_ahead_does_not_change_epoch_totals():
    totals = {}
    for depth in (0, 1, 4):
        cfg = dataclasses.replace(CFG, batch_size=1, dispatch_ahead=depth)
        t = _trainer(False, False, cfg)
        assert t.steps_per_epoch == 2
        totals[depth] = [t.run_epoch(e) for e in range(2)]
    assert totals[0] == totals[1] == totals[4]


def test_dispatch_ahead_with_the_fused_step():
    totals = {}
    for fused, depth in ((False, 0), (True, 4)):
        cfg = dataclasses.replace(CFG, batch_size=1, dispatch_ahead=depth)
        t = _trainer(fused, False, cfg)
        totals[fused] = [t.run_epoch(e) for e in range(2)]
    assert totals[False] == totals[True]


# ----------------------------------------------------- PAGNERF_FUSED_STEP
@pytest.mark.parametrize("env", [None, "1", "true", "YES", " on ", "y", "0", "false", "off",
                                 "no", "2", ""])
@pytest.mark.parametrize("flag", [False, True])
def test_fused_step_env_is_read_as_jax_reads_it(env, flag, monkeypatch):
    if env is not None:
        monkeypatch.setenv("PAGNERF_FUSED_STEP", env)
    t = _trainer(flag, False)
    stand_in = type("T", (), {"cfg": CfgJ(fused_micro_step=flag)})()
    assert t._fused_step_enabled() == TrainerJ._fused_step_enabled(stand_in)


# ---------------------------------------------------------------- vs JAX
def eager_march(raymarch_j):
    """The JAX package's ``raymarch`` inside a jitted step, its values and
    its gradient in the ray origins and directions both computed op by op,
    outside the caller's jit (host callbacks)."""
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

        def eager_vjp(o, d, *rest):
            gs, ex = rest[:5], rest[5:]
            with jax.disable_jit():
                _, vjp = jax.vjp(lambda o_, d_: run(o_, d_, *ex)[:5], o, d)
                return tuple(np.asarray(x) for x in vjp(tuple(gs)))

        @jax.custom_vjp
        def values(o, d):
            return jax.pure_callback(eager, shapes, o, d, *extra)

        def fwd(o, d):
            return values(o, d), (o, d)

        def bwd(res, g):
            o, d = res
            return jax.pure_callback(eager_vjp, (sds(o.shape, o.dtype), sds(d.shape, d.dtype)),
                                     o, d, *g[:5], *extra)

        values.defvjp(fwd, bwd)
        positionsT, depths, deltas, t0, span, mask = values(rays.origins, rays.dirs)
        return RaymarchResultJ(positionsT=positionsT, depths=depths, deltas=deltas,
                               mask=mask, t0=t0, span=span)
    return march


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Both trainers' fused step from one state, once per stage."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PAGNERF_FUSED_STEP", raising=False)
        mp.setattr(tracer_j, "raymarch", eager_march(tracer_j.raymarch))
        for stage, (epoch, pruned) in STAGES.items():
            cfg = dataclasses.replace(CFG, fused_micro_step=True)
            pipe_j, ds_j = graft._flagship(tiny=True)
            pipe_j.nef = pipe_j.nef.clone(compute_dtype_name="float32")
            tj = TrainerJ(pipe_j, ds_j, CfgJ(**dataclasses.asdict(cfg)), OptJ(**OPT),
                          occ_level=OCC_LEVEL)
            tt = _trainer(True, pruned)
            tt.pipeline.load_state_dict(params_from_flax(
                jax.tree_util.tree_map(np.asarray, tj.params)))
            if pruned:
                occ, mask = _occupancy()
                tj.occ = OccJ(occupancy=jnp.asarray(occ), mask=jnp.asarray(mask),
                              level=OCC_LEVEL)
                tj._pruned, tj._occ_frac = True, float(mask.mean())
            st_j, st_t = tj.stage_for_epoch(epoch), tt.stage_for_epoch(epoch)
            batch = _batch(tt, epoch, 6)
            key, jitters = tj._step_key, []
            for _ in range(MICRO):
                key, k = jax.random.split(key)
                jitters.append(torch.from_numpy(np.array(
                    jax.random.uniform(k, (RAYS, st_t.num_steps)))))
            before = {n: p.detach().clone() for n, p in tt.params.items()}
            losses_j = {k: float(v) for k, v in tj.train_step(st_j, batch).items()}
            losses_t = {k: float(v) for k, v in
                        tt.train_step(st_t, batch, jitters=jitters).items()}
            state_j = ckpt_state(tj, str(tmp_path_factory.mktemp(stage) / "jax.ckpt"))
            out[stage] = dict(stage_j=st_j, stage_t=st_t, losses_j=losses_j,
                              losses_t=losses_t, state_j=state_j, tt=tt, before=before)
    return out


def ckpt_state(tj, path):
    """The JAX trainer's state in the port's names: its own checkpoint
    writer, read back with flax, through ``convert.state_from_jax``."""
    from flax import serialization

    from pagnerf_tpu.train import checkpoint as ckpt_j
    from pagnerf_tpu_torch.convert import state_from_jax
    with open(ckpt_j.save_checkpoint(path, tj), "rb") as f:
        return state_from_jax(serialization.msgpack_restore(f.read()))


@pytest.mark.parametrize("stage", list(STAGES))
def test_fused_step_matches_jax_fused_step(jax_runs, stage):
    r = jax_runs[stage]
    assert dataclasses.asdict(r["stage_t"]) == dataclasses.asdict(r["stage_j"])
    lj, lt = r["losses_j"], r["losses_t"]
    assert sorted(lt) == sorted(lj)
    for k in lj:
        assert np.isfinite(lt[k])
        if k == "total_loss":
            np.testing.assert_allclose(lt[k], lj[k], rtol=1e-6, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(lt[k], lj[k], rtol=0, atol=1e-5, err_msg=k)
    tt, sj = r["tt"], r["state_j"]["opt_state"]
    assert tt.opt.count == sj["count"] == {g: 1 for g in opt_t.GROUPS}
    frozen = tt.frozen_fn(r["stage_t"])
    moved = 0
    for n, p in tt.params.items():
        want, got = sj["mu"][n].numpy(), tt.opt.mu[n].numpy()
        atol = 1e-7 * max(1.0, 10 * float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=f"{stage} mu {n}")
        if frozen(n):
            assert torch.equal(p.detach(), r["before"][n]), n
            assert not tt.opt.mu[n].any(), n
        else:
            moved += int(not torch.equal(p.detach(), r["before"][n]))
    assert moved > 0


# ---------------------------------------------------- optimizer device flag
SHAPES = {"nef.grid.tables": (3, 4, 2), "nef.decoder_color.kernel": (4, 3),
          "extrinsics": (2, 9)}


def _opt(kind="adam", **kw):
    rng = np.random.default_rng(0)
    params = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for n, s in SHAPES.items()}
    cfg = OptimizerConfig(optimizer_type=kind, use_lr_scheduler=True, lr_step_size=1,
                          lr_step_gamma=0.5, steps_per_epoch=3, num_epochs=2, **kw)
    return opt_t.MaskedOptimizer(cfg, params), params, rng


def _grads(rng, nan=False):
    g = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for n, s in SHAPES.items()}
    if nan:
        g["nef.grid.tables"][0, 0, 0] = float("nan")
    return g


@pytest.mark.parametrize("kind", ["adam", "sgd", "rmsprop"])
def test_nonfinite_step_leaves_everything_bit_equal(kind):
    opt, params, rng = _opt(kind)
    opt.update(_grads(rng))
    before = ({n: p.clone() for n, p in params.items()},
              {key: {n: m.clone() for n, m in getattr(opt, key).items()}
               for key in opt_t.MOMENTS[kind]}, opt.counts.clone())
    lr = {g: opt.lr(g) for g in opt_t.GROUPS}
    ok = opt.update(_grads(rng, nan=True), clip_norm=0.5)
    assert ok.dtype == torch.bool and ok.dim() == 0 and not bool(ok)
    assert all(torch.equal(params[n], before[0][n]) for n in params)
    for key, vals in before[1].items():
        assert all(torch.equal(getattr(opt, key)[n], v) for n, v in vals.items()), key
    assert torch.equal(opt.counts, before[2])
    # the rate of the next update is the schedule's at the unchanged count
    assert {g: opt.lr(g) for g in opt_t.GROUPS} == lr
    count = opt.count["grid"]
    assert count == 1 and opt.lr("grid") == opt.schedule["grid"](1)
    p0 = params["nef.decoder_color.kernel"].clone()
    g = _grads(rng)
    assert bool(opt.update(g))
    if kind == "sgd":
        # the update took the rate at count 1, as a host count would
        step = g["nef.decoder_color.kernel"] * torch.tensor(-opt.schedule["decoder"](1),
                                                            dtype=torch.float32)
        assert torch.equal(params["nef.decoder_color.kernel"], p0 + step)


def test_frozen_leaves_keep_values_and_moments():
    opt, params, rng = _opt()
    opt.update(_grads(rng))
    p, mu, nu = (params["extrinsics"].clone(), opt.mu["extrinsics"].clone(),
                 opt.nu["extrinsics"].clone())
    opt.update(_grads(rng), frozen_fn=lambda n: n.startswith("extrinsics"), clip_norm=1.0)
    assert torch.equal(params["extrinsics"], p)
    assert torch.equal(opt.mu["extrinsics"], mu) and torch.equal(opt.nu["extrinsics"], nu)
    # the frozen group's count advanced all the same
    assert opt.count == {g: 2 for g in opt_t.GROUPS}


def test_counts_survive_a_checkpoint(tmp_path):
    t = _trainer(False, False)
    for _ in range(3):
        t.opt.update({n: torch.ones_like(p) for n, p in t.params.items()})
    t.opt.update({n: torch.full_like(p, float("nan")) for n, p in t.params.items()})
    path = ckpt_t.save_checkpoint(str(tmp_path / "model.ckpt"), t)
    fresh = _trainer(False, False)
    ckpt_t.load_checkpoint(path, fresh)
    assert fresh.opt.count == t.opt.count == {g: 3 for g in opt_t.GROUPS}
    assert torch.equal(fresh.opt.counts, t.opt.counts)
    for n in t.opt.mu:
        assert torch.equal(fresh.opt.mu[n], t.opt.mu[n]), n
    # the restored moments are the optimizer's own tensors, written in place
    assert all(fresh.opt.mu[n] is m for n, m in fresh.opt.mu.items())


def test_rate_tables_grow_past_the_run():
    opt, params, rng = _opt()
    n0 = opt.lr_table.shape[1]
    assert n0 >= 2 * 3 + 2
    for _ in range(n0 + 5):
        opt.update(_grads(rng))
    assert opt.lr_table.shape[1] > n0 + 5
    count = opt.count["grid"]
    assert count == n0 + 5
    table = opt.lr_table.numpy()
    for i, g in enumerate(opt_t.GROUPS):
        want = np.array([opt.schedule[g](c) for c in range(table.shape[1])], np.float32)
        np.testing.assert_array_equal(table[i], want, err_msg=g)
    bc = opt.bc_table.numpy()
    for t in (0, 1, 7, count):
        assert bc[0, t] == np.float32(1 - torch.tensor(0.9, dtype=torch.float32) ** t)
        assert bc[1, t] == np.float32(1 - torch.tensor(0.999, dtype=torch.float32) ** t)


@pytest.mark.parametrize("schedule", [dict(use_lr_scheduler=False),
                                      dict(lr_scheduler_type="step", lr_step_size=1),
                                      dict(lr_scheduler_type="step", lr_step_size=1,
                                           steps_per_epoch=41),
                                      dict(lr_scheduler_type="one_cycle", num_epochs=10,
                                           lr_warmup_epochs=2),
                                      dict(lr_scheduler_type="panoptic_step",
                                           lr_step_size=2)])
def test_schedule_tables_equal_the_schedules(schedule):
    kw = dict(dict(use_lr_scheduler=True, steps_per_epoch=3, lr_step_gamma=0.5), **schedule)
    cfg = OptimizerConfig(**kw)
    for g in opt_t.GROUPS:
        sched = opt_t.lr_schedule(cfg, g)
        n = 700
        want = np.array([sched(c) for c in range(n)], np.float32)
        np.testing.assert_array_equal(sched.table(n), want, err_msg=g)
