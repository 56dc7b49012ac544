"""The port's other optimizers, weight decay and decoder activations against
the JAX package, on the CPU.

- ``MaskedOptimizer`` of each kind -- adam, adam with weight decay (adamw on
  the grid groups), sgd and rmsprop -- against the JAX package's
  ``build_optimizer`` + ``masked_update`` + ``optax.apply_updates`` on the
  tiny flagship trainer's parameters (its names and shapes, the step
  schedule at 4 steps an epoch), the same numpy gradients: after the first
  step and over a 12-step run, parameters and state within 1e-6 (relative
  to entries above 1); Adam's parameters also within the float32 ``pow``
  term of ``tests/test_torch_optimizer.py``, summed over the steps. Cases:
  frozen extrinsics for three steps and a val-pose step (everything but the
  extrinsics frozen), a global-norm clip, and a non-finite gradient (the
  step is skipped: the port's state stays bit-identical).
- sgd and rmsprop ignore ``weight_decay`` as the JAX package's do:
  bit-equal to the same run without it.
- One real training step of the tiny trainer of each kind: its gradients
  through JAX's ``masked_update`` give the port's parameters and state.
- A checkpoint round trip of each kind is bit-exact; a JAX checkpoint of
  each kind, written by ``pagnerf_tpu.train.checkpoint.save_checkpoint`` and
  read with ``convert.state_from_jax``, restores the same state in the port;
  a state of another kind reinitialises the trainer's own optimizer with
  the JAX package's warning (whose own restore fails on such a state).
- ``BasicDecoder`` at ``sin``, ``selu`` and ``gelu`` against flax's: in
  float32 within 1e-6 (relative to entries above 1), and each activation on
  flax's own bfloat16 pre-activations within one bfloat16 ulp (the whole
  bf16 decoder within ``tests/test_torch_modules.py``'s matmul bound).
"""
import dataclasses
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as flax_ser

from pagnerf_tpu.models import decoder as dec_j
from pagnerf_tpu.train import checkpoint as ckpt_j
from pagnerf_tpu.train import optimizer as opt_j
from pagnerf_tpu_torch import entry as entry_t
from pagnerf_tpu_torch.convert import params_from_flax, state_from_jax
from pagnerf_tpu_torch.models import decoder as dec_t
from pagnerf_tpu_torch.train import checkpoint as ckpt_t
from pagnerf_tpu_torch.train import optimizer as opt_t
from pagnerf_tpu_torch.train.trainer import PanopticTrainer, TrainerConfig

KINDS = {"adam": {}, "adamw": {"weight_decay": 1e-2},
         "sgd": {"optimizer_type": "sgd", "weight_decay": 1e-2},
         "rmsprop": {"optimizer_type": "rmsprop", "weight_decay": 1e-2}}
SCHEDULE = dict(use_lr_scheduler=True, lr_step_size=2, steps_per_epoch=4, num_epochs=6)
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops in one thread: beside five busy test workers, torch's
    spinning intra-op threads took a 5 s tiny CLI run to 293 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def shapes():
    """The tiny flagship trainer's parameters (names, shapes, initial values)."""
    pipe, _ = entry_t.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    return {n: p.detach().numpy().copy() for n, p in pipe.named_parameters()}


def _jax_state(state, names):
    """{'count': {group: n}, 'mu' / 'nu': {name: array}} of a multi_transform
    state, through the port's own reader of a JAX checkpoint's state."""
    st = state_from_jax({"params": _nest(names), "opt_state": flax_ser.to_state_dict(
        jax.tree_util.tree_map(np.asarray, state)), "occupancy": 0, "occ_mask": 0,
        "occ_level": 0, "lod_weights": 0, "epoch": 0, "global_step": 0})["opt_state"]
    return st


def _grads(rng, init, step, case):
    g = {k: (rng.normal(size=v.shape) * 10 ** rng.uniform(-3, 0)).astype(np.float32)
         for k, v in init.items()}
    if case == "nonfinite" and step == 2:
        g["nef.grid.tables"][0, 0, 0] = np.inf
    return g


def _frozen(case, step):
    if case != "frozen":
        return None
    if step in (3, 4, 5):
        return lambda n: n.startswith("extrinsics")
    if step == 7:                      # a val-pose step: only the extrinsics train
        return lambda n: not n.startswith("extrinsics")
    return None


def _run(kind_kw, init, case, steps, seed=0):
    """Both optimizers over ``steps`` steps; yields (step, applied, port
    optimizer, port params, JAX params, JAX state) after each."""
    rng = np.random.default_rng(seed)
    clip = 0.5 if case == "clip" else 0.0
    cfg_j = opt_j.OptimizerConfig(clip_grad_norm=clip, **SCHEDULE, **kind_kw)
    params_j = _nest({k: jnp.asarray(v) for k, v in init.items()})
    tx = opt_j.build_optimizer(cfg_j, params_j)
    state_j = tx.init(params_j)
    params_t = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = opt_t.MaskedOptimizer(opt_t.OptimizerConfig(**dataclasses.asdict(cfg_j)), params_t)
    for step in range(steps):
        g = _grads(rng, init, step, case)
        frozen = _frozen(case, step)
        frozen_j = None if frozen is None else (lambda p, f=frozen: f(p.replace("/", ".")))
        updates, state_j = opt_j.masked_update(
            tx, _nest({k: jnp.asarray(v) for k, v in g.items()}), state_j, params_j,
            frozen_j, clip)
        params_j = optax.apply_updates(params_j, updates)
        applied = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, frozen, clip)
        yield step, applied, opt, params_t, params_j, state_j


def _close(a, b, atol, what):
    a, b = np.asarray(a), np.asarray(b)
    bound = atol + TOL * np.maximum(np.abs(b) - 1, 0)
    err = np.abs(a - b) - bound
    assert err.max() <= 0, f"{what}: {np.abs(a - b).max()} (bound {bound.max()})"


def _assert_matches(opt, params_t, params_j, state_j, pow_slack, what):
    flat_j = _flat(jax.tree_util.tree_map(np.asarray, params_j))
    sj = _jax_state(state_j, flat_j)
    assert opt.count == sj["count"], what
    assert sj["kind"] == opt.kind, what
    for n, p in params_t.items():
        grp = opt.group[n]
        _close(p.numpy(), flat_j[n], TOL + pow_slack.get(grp, 0.0), f"{what} param {n}")
        for key in opt_t.MOMENTS[opt.cfg.optimizer_type]:
            _close(getattr(opt, key)[n].numpy(), sj[key][n].numpy(), TOL, f"{what} {key} {n}")
    assert set(sj) - {"kind", "count"} == set(opt_t.MOMENTS[opt.cfg.optimizer_type])


@pytest.mark.parametrize("case", ["run", "frozen", "clip", "nonfinite"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_optimizer_matches_jax(kind, case, shapes):
    """One step and 12 (the non-run cases 8) against optax."""
    steps = 12 if case == "run" else 8
    pow_slack = {}
    for step, applied, opt, params_t, params_j, state_j in _run(KINDS[kind], shapes,
                                                                 case, steps):
        assert applied == (not (case == "nonfinite" and step == 2))
        if kind in ("adam", "adamw"):
            # XLA's and torch's float32 0.999 ** t may differ by an ulp
            for grp, t in opt.count.items():
                lr = opt_t.lr_schedule(opt.cfg, grp)(t - 1)
                pow_slack[grp] = pow_slack.get(grp, 0.0) + lr * 2.0 ** -23 / (1 - 0.999 ** t)
        if step in (0, steps - 1) or case != "run":
            _assert_matches(opt, params_t, params_j, state_j, pow_slack,
                            f"{kind} {case} step {step}")


def test_nonfinite_step_changes_nothing(shapes):
    """Under each kind the skipped step leaves parameters, moments and
    counts bit-identical (a step replaces the moment tensors and changes
    the parameters in place)."""
    for kind, kw in KINDS.items():
        for step, applied, opt, params_t, _, _ in _run(kw, shapes, "nonfinite", 3):
            if step == 1:
                before = ({n: p.clone() for n, p in params_t.items()},
                          {k: dict(v) for k, v in opt.state().items() if k != "kind"})
            if step == 2:
                assert not applied
                assert all(torch.equal(params_t[n], before[0][n]) for n in params_t), kind
                st = opt.state()
                assert st["count"] == before[1]["count"], kind
                for key in opt_t.MOMENTS[opt.cfg.optimizer_type]:
                    assert all(st[key][n] is before[1][key][n] for n in st[key]), kind


@pytest.mark.parametrize("kind", ["sgd", "rmsprop"])
def test_weight_decay_is_ignored_by_sgd_and_rmsprop(kind, shapes):
    kw = dict(KINDS[kind])
    with_wd = list(_run(kw, shapes, "run", 4))[-1]
    kw["weight_decay"] = 0.0
    without = list(_run(kw, shapes, "run", 4))[-1]
    assert with_wd[2].kind == without[2].kind == kind
    for n in with_wd[3]:
        assert torch.equal(with_wd[3][n], without[3][n]), n


def _trainer(kind, seed=0):
    pipe, ds = entry_t.flagship(tiny=True, device="cpu", compute_dtype=torch.float32,
                                seed=seed)
    pipe.requires_grad_(True)
    cfg = TrainerConfig(batch_size=2, num_rays_sampled_per_img=16, micro_batch_imgs=1,
                        epochs=6, seed=seed)
    return PanopticTrainer(pipe, ds, cfg, opt_t.OptimizerConfig(
        **SCHEDULE, **KINDS[kind]), occ_level=6)


@pytest.mark.parametrize("kind", list(KINDS))
def test_trainer_step_matches_jax_update(kind):
    """A real training step of each kind (RGB stage, epoch 0, with the val
    poses' extrinsics frozen by the stage): the port's parameters and state
    after it are JAX's ``masked_update`` of its own gradients."""
    t = _trainer(kind)
    init = {n: p.detach().numpy().copy() for n, p in t.params.items()}
    seen = {}
    update = t.opt.update

    def spy(grads, frozen_fn=None, clip_norm=0.0):
        seen.update(grads={n: g.detach().numpy().copy() for n, g in grads.items()
                           if g is not None}, frozen=frozen_fn, clip=clip_norm)
        return update(grads, frozen_fn, clip_norm)

    t.opt.update = spy
    stage = t.stage_for_epoch(0)
    batch = t.dataset.sample_batch(t.rng, t.cfg.batch_size, t.cfg.num_rays_sampled_per_img)
    t.train_step(stage, batch)
    params_j = _nest({k: jnp.asarray(v) for k, v in init.items()})
    tx = opt_j.build_optimizer(opt_j.OptimizerConfig(**dataclasses.asdict(t.opt.cfg)),
                               params_j)
    g = {n: seen["grads"].get(n, np.zeros_like(v)) for n, v in init.items()}
    frozen = seen["frozen"]
    updates, state_j = opt_j.masked_update(
        tx, _nest({k: jnp.asarray(v) for k, v in g.items()}), tx.init(params_j), params_j,
        None if frozen is None else (lambda p: frozen(p.replace("/", "."))), seen["clip"])
    params_j = optax.apply_updates(params_j, updates)
    assert t.opt.count["grid"] == 1
    _assert_matches(t.opt, {n: p.detach() for n, p in t.params.items()}, params_j,
                    state_j, {}, kind)


def _stepped(kind, steps=2):
    t = _trainer(kind)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        t.opt.update({n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
                      for n, p in t.params.items()})
    return t


def _assert_same_opt(a, b):
    assert (a.kind, a.count) == (b.kind, b.count)
    for key in opt_t.MOMENTS[a.cfg.optimizer_type]:
        ma, mb = getattr(a, key), getattr(b, key)
        assert set(ma) == set(mb) and all(torch.equal(ma[n], mb[n]) for n in ma), key
    for key in {"mu", "nu"} - set(opt_t.MOMENTS[a.cfg.optimizer_type]):
        assert getattr(a, key) == getattr(b, key) == {}


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpoint_round_trip_of_each_kind(kind, tmp_path):
    t = _stepped(kind)
    path = ckpt_t.save_checkpoint(str(tmp_path / "model.ckpt"), t)
    state = torch.load(path, weights_only=True)
    assert sorted(state["opt_state"]) == sorted(
        ("kind", "count") + opt_t.MOMENTS[t.opt.cfg.optimizer_type])
    fresh = _trainer(kind, seed=1)
    ckpt_t.load_checkpoint(path, fresh)
    _assert_same_opt(t.opt, fresh.opt)
    assert all(torch.equal(p, fresh.params[n]) for n, p in t.params.items())


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_checkpoint_of_each_kind(kind, tmp_path, shapes):
    """``pagnerf_tpu``'s writer on its optimizer's state after 3 steps, read
    with flax and ``state_from_jax``, restored into a port trainer of the
    same kind: the JAX state, within 1e-6."""
    *_, opt, params_t, params_j, state_j = list(_run(KINDS[kind], shapes, "run", 3))[-1]
    t = _trainer(kind)
    stand_in = types.SimpleNamespace(
        params=params_j, opt_state=state_j, occ=types.SimpleNamespace(
            occupancy=t.occ.occupancy.numpy(), mask=t.occ.mask.numpy(), level=t.occ.level),
        lod_w=t.lod_w.numpy(), epoch=1, global_step=3)
    path = ckpt_j.save_checkpoint(str(tmp_path / "jax.ckpt"), stand_in)
    with open(path, "rb") as f:
        state = state_from_jax(flax_ser.msgpack_restore(f.read()))
    ckpt_t.load_state(t, state)
    assert t.opt.kind == opt.kind and t.opt.count == opt.count
    _assert_matches(t.opt, {n: p.detach() for n, p in t.params.items()}, params_j,
                    state_j, {}, kind)


@pytest.mark.parametrize("saved,loaded", [("adam", "sgd"), ("sgd", "rmsprop"),
                                          ("rmsprop", "adam"), ("adam", "adamw")])
def test_kind_mismatch_reinitialises(saved, loaded, tmp_path, caplog, shapes):
    """The port warns and builds a fresh optimizer of the trainer's kind,
    counts and moments zero, parameters restored; the JAX package's own
    restore fails on the other kind's state and reinitialises alike."""
    params_j = _nest({k: jnp.asarray(v) for k, v in shapes.items()})
    tx_s = opt_j.build_optimizer(opt_j.OptimizerConfig(**KINDS[saved]), params_j)
    tx_l = opt_j.build_optimizer(opt_j.OptimizerConfig(**KINDS[loaded]), params_j)
    with pytest.raises(Exception):
        flax_ser.from_state_dict(tx_l.init(params_j),
                                 flax_ser.to_state_dict(tx_s.init(params_j)))
    path = ckpt_t.save_checkpoint(str(tmp_path / "model.ckpt"), _stepped(saved))
    t = _trainer(loaded, seed=1)
    with caplog.at_level(logging.WARNING):
        ckpt_t.load_checkpoint(path, t)
    assert "optimizer state incompatible; reinitialised" in caplog.text
    assert t.opt.kind == loaded and set(t.opt.count.values()) == {0}
    for key in opt_t.MOMENTS[t.opt.cfg.optimizer_type]:
        assert all(float(m.abs().max()) == 0 for m in getattr(t.opt, key).values())
    assert t.opt.params["nef.grid.tables"] is t.params["nef.grid.tables"]


# ------------------------------------------------------------------ activations
def _decoder_pair(activation, dtype, x):
    dj = dec_j.BasicDecoder(output_dim=8, hidden_dim=32, num_layers=2,
                            activation=activation, compute_dtype=getattr(jnp, dtype))
    params = dj.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    dt = dec_t.BasicDecoder(x.shape[0], 8, 32, 2, activation=activation,
                            compute_dtype=getattr(torch, dtype))
    dt.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return dj, params, dt


@pytest.mark.parametrize("activation", ["sin", "selu", "gelu"])
def test_decoder_activation_matches_flax_float32(activation):
    x = (np.random.default_rng(5).normal(size=(24, 500)) * 2).astype(np.float32)
    dj, params, dt = _decoder_pair(activation, "float32", x)
    want = np.asarray(dj.apply({"params": params}, jnp.asarray(x)))
    _close(dt(torch.from_numpy(x)).detach().numpy(), want, TOL, activation)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("activation", ["sin", "selu", "gelu"])
def test_decoder_activation_matches_flax_bfloat16(activation):
    """The activation on flax's own bfloat16 pre-activations of hidden_0,
    within one bfloat16 ulp of flax's; the decoder within the bf16 matmul
    bound of ``tests/test_torch_modules.py``."""
    x = (np.random.default_rng(6).normal(size=(24, 500)) * 2).astype(np.float32)
    dj, params, dt = _decoder_pair(activation, "bfloat16", x)
    pre = dec_j.DenseT(32, dtype=jnp.bfloat16).apply(
        {"params": params["hidden_0"]}, jnp.asarray(x).astype(jnp.bfloat16))
    want = np.asarray(dec_j.get_activation(activation)(pre).astype(jnp.float32))
    got = dt.act(torch.from_numpy(np.asarray(pre.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp), activation
    np.testing.assert_allclose(dt(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(dj.apply({"params": params}, jnp.asarray(x))),
                               rtol=0, atol=3e-2)


def test_unknown_activation_raises_as_jax():
    with pytest.raises(KeyError):
        dec_j.get_activation("swish")
    with pytest.raises(KeyError):
        dec_t.BasicDecoder(4, 2, activation="swish")
