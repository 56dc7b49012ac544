"""The learning-rate schedules, the LoD weights and an annealed run of the
port against the JAX package, on the CPU.

- Every group's learning rate at every step of the ``step``, ``one_cycle``
  and ``panoptic_step`` schedules (and the constant one) equals the rate
  optax applies inside the JAX package's jitted ``masked_update`` (rtol
  1e-6), across frozen steps, a ``reset_moments`` (the JAX trainer's
  ``_reinit_opt_state``) and a skipped non-finite step; the counts equal
  optax's Adam and schedule counts exactly. optax's rate is read off its
  update: -update / Adam's direction (optax's bias correction of the new
  moments at the new count).
- ``lod_weights`` equals the JAX package's exactly.
- A tiny run built by both factories from ``configs/synthetic/tiny.yaml``
  with LoD annealing, the step schedule and random LoD: the port on the
  JAX trainer's converted parameters and key stream, the JAX march run op
  by op (``test_torch_schedule.op_by_op_march``), per-epoch losses within
  1e-4 relative.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pagnerf_tpu.config import config as config_j
from pagnerf_tpu.config import factory as factory_j
from pagnerf_tpu.data import native as native_j
from pagnerf_tpu.models import tracer as tracer_j
from pagnerf_tpu.train import optimizer as opt_j
from pagnerf_tpu.train.trainer import PanopticTrainer as TrainerJ
from pagnerf_tpu.utils import lod_annealing as lod_j
from pagnerf_tpu_torch.config import config as config_t
from pagnerf_tpu_torch.config import factory as factory_t
from pagnerf_tpu_torch.convert import params_from_flax
from pagnerf_tpu_torch.train import optimizer as opt_t
from pagnerf_tpu_torch.utils import lod_annealing as lod_t
from test_torch_schedule import JaxDraws, op_by_op_march

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one leaf per group (label_for_path)
LEAVES = {"nef/decoder_color/kernel": (5, 3), "nef/sem_head/kernel": (4,),
          "nef/inst_head/kernel": (4,), "nef/delta_grid/tables": (6, 2),
          "nef/grid/tables": (6, 2), "nef/other/w": (3,), "extrinsics": (4, 9)}
SCHEDULES = {
    "constant": dict(use_lr_scheduler=False),
    "step": dict(lr_scheduler_type="step", lr_step_size=2, lr_step_gamma=0.5,
                 steps_per_epoch=3),
    # 41 steps: XLA's reciprocal of the transition steps puts the floor at
    # some multiples one step late (optimizer._staircase_decay)
    "step_41": dict(lr_scheduler_type="step", lr_step_size=1, lr_step_gamma=0.1,
                    steps_per_epoch=41),
    "one_cycle": dict(lr_scheduler_type="one_cycle", num_epochs=10, steps_per_epoch=3,
                      lr_warmup_epochs=2, lr_div_factor=1e4),
    "panoptic_step": dict(lr_scheduler_type="panoptic_step", lr_step_size=2,
                          lr_step_gamma=0.3, steps_per_epoch=3),
}
STEPS = {"step_41": 100}
B1, B2 = 0.9, 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops in one thread: beside five busy test workers, torch's
    spinning intra-op threads took a 5 s tiny CLI run to 293 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _inner(state, group):
    """(Adam state, schedule state) of a group in the multi_transform state."""
    return state.inner_states[group].inner_state


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_at_every_step_matches_optax(name):
    kw = dict(dict(lr=0.005, grid_lr_weight=30, delta_grid_lr_weight=30, extrinsics_lr=1e-4,
                   use_lr_scheduler=True), **SCHEDULES[name])
    cfg_j, cfg_t = opt_j.OptimizerConfig(**kw), opt_t.OptimizerConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in LEAVES.items()}
    params_j = _tree({k: jnp.asarray(v) for k, v in p0.items()})
    tx = opt_j.build_optimizer(cfg_j, params_j)
    state = tx.init(params_j)
    params_t = {k.replace("/", "."): torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = opt_t.MaskedOptimizer(cfg_t, params_t)
    groups = {k: opt_t.label_for_path(k) for k in LEAVES}
    assert sorted(set(groups.values())) == sorted(opt_t.GROUPS)

    def frozen_ext(path):
        return path.startswith("extrinsics")
    adam_direction = jax.jit(lambda mu, nu, c: optax.tree.bias_correction(mu, B1, c) / (
        jnp.sqrt(optax.tree.bias_correction(nu, B2, c)) + cfg_j.eps))
    steps = {None: jax.jit(lambda g, s, p: opt_j.masked_update(tx, g, s, p)),
             "ext": jax.jit(lambda g, s, p: opt_j.masked_update(tx, g, s, p, frozen_ext))}
    n_steps = STEPS.get(name, 40)
    reset_at, skip_at, frozen_at = 13, 20, (5, 6, 25)
    seen_lrs = set()
    for t in range(n_steps):
        if t == reset_at:
            opt.reset_moments()
            state = TrainerJ._reinit_opt_state(
                types.SimpleNamespace(opt_state=state, tx=tx, params=params_j))
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in LEAVES.items()}
        if t == skip_at:
            g["nef/grid/tables"][0, 0] = np.nan
        frozen = "ext" if t in frozen_at else None
        lr_t = {grp: opt.lr(grp) for grp in opt_t.GROUPS}
        updates, state = steps[frozen](_tree({k: jnp.asarray(v) for k, v in g.items()}),
                                       state, params_j)
        params_j = jax.tree.map(lambda p, u: p + u, params_j, updates)
        applied = opt.update({k.replace("/", "."): torch.from_numpy(v) for k, v in g.items()},
                             (lambda n: n.startswith("extrinsics")) if frozen else None)
        assert applied == (t != skip_at)
        for path, grp in groups.items():
            adam, sched = _inner(state, grp)
            assert opt.count[grp] == int(adam.count) == int(sched.count), (t, grp)
            if t == skip_at or (frozen and grp == "extrinsics"):
                continue
            # optax's rate: -update / Adam's direction, which optax's own
            # bias correction recomputes from the new moments and count
            direction = np.asarray(adam_direction(_leaf(adam.mu, path), _leaf(adam.nu, path),
                                                  adam.count), np.float64)
            lr_j = float(np.median(-np.asarray(_leaf(updates, path), np.float64) / direction))
            np.testing.assert_allclose(lr_t[grp], lr_j, rtol=1e-6, err_msg=f"{t} {grp}")
            seen_lrs.add((grp, lr_t[grp]))
    assert len(seen_lrs) >= (len(opt_t.GROUPS) if name == "constant" else 10)
    for path in LEAVES:
        np.testing.assert_allclose(params_t[path.replace("/", ".")].numpy(),
                                   np.asarray(_leaf(params_j, path)), rtol=1e-4, atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("name", ["step", "step_41", "one_cycle", "panoptic_step"])
def test_schedule_functions_match_jitted_optax(name):
    """``lr_schedule`` against the JAX package's ``_schedule`` compiled by
    XLA, at every count of the schedule and past its end (rtol 1e-6)."""
    kw = dict(lr=0.005, grid_lr_weight=30, use_lr_scheduler=True, **SCHEDULES[name])
    cfg_j, cfg_t = opt_j.OptimizerConfig(**kw), opt_t.OptimizerConfig(**kw)
    counts = jnp.arange(600, dtype=jnp.int32)
    for grp in opt_t.GROUPS:
        want = np.asarray(jax.jit(jax.vmap(opt_j._schedule(opt_t.group_lr(cfg_t, grp),
                                                           cfg_j, grp)))(counts))
        got = np.array([opt_t.lr_schedule(cfg_t, grp)(c) for c in range(600)])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30, err_msg=grp)


@pytest.mark.parametrize("kw", [
    dict(step=0, num_lods=24, feature_dim=2, epochs=40, steps_per_epoch=12),
    dict(step=137, num_lods=24, feature_dim=2, epochs=40, steps_per_epoch=12),
    dict(step=480, num_lods=24, feature_dim=2, epochs=40, steps_per_epoch=12),
    dict(step=5000, num_lods=24, feature_dim=2, epochs=12, steps_per_epoch=12),
    dict(step=7, num_lods=6, feature_dim=4, epochs=2, steps_per_epoch=5),
    dict(step=3, num_lods=8, feature_dim=1, epochs=3, steps_per_epoch=2, base_lod=2,
         spread=1.5),
    dict(step=9, num_lods=5, feature_dim=2, epochs=0, steps_per_epoch=0),
])
def test_lod_weights_equal_jax(kw):
    got, want = lod_t.lod_weights(**kw), lod_j.lod_weights(**kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lod_t.constant_lod_weights(4, 2),
                                  lod_j.constant_lod_weights(4, 2))


# ------------------------------------------------------------- annealed run
RUN_ARGV = ["--config", os.path.join(ROOT, "configs", "synthetic", "tiny.yaml"),
            "--epochs", "4", "--lod-anneling", "--lod-annel-epochs", "2",
            "--use-lr-scheduler", "--lr-step-size", "1", "--lr-step-gamma", "0.5",
            "--random-lod", "--num-rays-sampled-per-img", "32"]


@pytest.fixture(scope="module")
def annealed_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_j, "_load", lambda: None)
        mp.setattr(tracer_j, "raymarch", op_by_op_march(tracer_j.raymarch))
        _, _, tj = factory_j.get_modules_from_config(config_j.parse_options(RUN_ARGV))
        args = config_t.parse_options(RUN_ARGV)
        pipe, _, tt = factory_t.get_modules_from_config(args, "cpu")
        p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tj.params)
        pipe.load_state_dict(params_from_flax(p))
        tt.draw = JaxDraws(tt.cfg.seed)
        records = []
        for epoch in range(args.epochs):
            lj, lt = tj.run_epoch(epoch), tt.run_epoch(epoch)
            records.append(dict(epoch=epoch, losses_j=lj, losses_t=lt,
                                lod_j=np.array(tj.lod_w), lod_t=tt.lod_w.numpy(),
                                lr_t=tt.opt.lr("grid"), count=tt.opt.count["grid"],
                                stage=tt.stage_for_epoch(epoch)))
    return tj, tt, records


def test_annealed_run_losses_match_jax(annealed_run):
    _, _, records = annealed_run
    for r in records:
        assert sorted(r["losses_t"]) == sorted(r["losses_j"]), r["epoch"]
        for k, v in r["losses_j"].items():
            np.testing.assert_allclose(r["losses_t"][k], v, rtol=1e-4,
                                       err_msg=f"epoch {r['epoch']} {k}")
    assert records[-1]["stage"].use_sem and not records[0]["stage"].use_sem


def test_annealed_run_schedules_move(annealed_run):
    """Random LoD (the last step's cut, equal on both sides), the LR halved
    each epoch of 2 steps, and the counts of 8 steps."""
    tj, tt, records = annealed_run
    for r in records:
        np.testing.assert_array_equal(r["lod_t"], r["lod_j"])
    assert len({r["lod_t"].tobytes() for r in records}) > 1
    assert [r["count"] for r in records] == [2, 4, 6, 8]
    grid_lr = 0.005 * 20
    np.testing.assert_allclose([r["lr_t"] for r in records],
                               [grid_lr * 0.5 ** e for e in (1, 2, 3, 4)], rtol=1e-6)
    assert tt.global_step == tj.global_step == 8
    assert dataclasses.asdict(tt.cfg)["random_lod"] and tt.cfg.lod_anneling
