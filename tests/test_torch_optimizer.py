"""The port's masked Adam against the JAX package's ``build_optimizer`` +
``masked_update`` + ``optax.apply_updates``: the same gradients for 3 steps,
both Adam moments within 1e-6 (float32 rounding of the same arithmetic),
the per-group step counts equal, and the parameters within 1e-6 plus
lr * 2^-23 / (1 - 0.999^t): XLA's and torch's float32 ``pow`` may round
``0.999 ** t`` one ulp apart, and ``1 - 0.999 ** t`` cancels, so that ulp
is 4e-5 of the bias correction at t = 3 and moves a grid step of lr = 0.1
by up to 4e-6. Cases: a frozen extrinsics span, a non-finite
gradient (the step is skipped: the port's state stays bit-identical), a
global-norm clip, and a parameter that gets no gradient (None in the port,
zeros in JAX)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pagnerf_tpu.train import optimizer as opt_j
from pagnerf_tpu_torch.train import optimizer as opt_t

SHAPES = {"nef/grid/tables": (4, 8, 2), "nef/delta_grid/tables": (4, 8, 2),
          "nef/decoder_color/hidden_0/kernel": (3, 5),
          "nef/decoder_color/hidden_0/bias": (5,),
          "nef/decoder_semantics/lout/bias": (3,), "extrinsics": (3, 9)}


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _kp(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in kp)


def _jax_state(state):
    """{(group, 'count')}: int and {('mu'|'nu', param path)}: array."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        parts = _kp(kp).split("/")       # inner_states/<group>/inner_state/<i>/...
        if parts[3] == "0" and parts[4] == "count":
            out[(parts[1], "count")] = int(leaf)
        elif parts[3] == "0" and parts[4] in ("mu", "nu"):
            out[(parts[4], "/".join(parts[5:]))] = np.asarray(leaf)
    return out


def _grads(rng, step, case):
    g = {k: (rng.normal(size=s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
         for k, s in SHAPES.items()}
    if case == "nonfinite" and step == 1:
        g["nef/grid/tables"][0, 0, 0] = np.nan
    return g


@pytest.mark.parametrize("case", ["frozen", "nonfinite", "clip", "no_grad"])
def test_masked_adam_matches_jax(case):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    cfg_kw = dict(clip_grad_norm=0.5 if case == "clip" else 0.0)
    tx = opt_j.build_optimizer(opt_j.OptimizerConfig(**cfg_kw),
                               _nest({k: jnp.asarray(v) for k, v in init.items()}))
    params_j = _nest({k: jnp.asarray(v) for k, v in init.items()})
    state_j = tx.init(params_j)
    names = {k: k.replace("/", ".") for k in SHAPES}
    params_t = {names[k]: torch.from_numpy(v.copy()) for k, v in init.items()}
    adam = opt_t.MaskedOptimizer(opt_t.OptimizerConfig(**cfg_kw), params_t)

    for step in range(3):
        g = _grads(rng, step, case)
        frozen = (case == "frozen" and step == 1)
        frozen_j = (lambda p: p.startswith("extrinsics")) if frozen else None
        frozen_t = (lambda n: n.startswith("extrinsics")) if frozen else None
        g_t = {names[k]: torch.from_numpy(v) for k, v in g.items()}
        if case == "no_grad":
            g["nef/decoder_semantics/lout/bias"] = np.zeros(3, np.float32)
            g_t[names["nef/decoder_semantics/lout/bias"]] = None
        before = ({n: p.clone() for n, p in params_t.items()},
                  {n: m.clone() for n, m in adam.mu.items()}, dict(adam.count))
        updates, state_j = opt_j.masked_update(
            tx, _nest({k: jnp.asarray(v) for k, v in g.items()}), state_j, params_j,
            frozen_j, cfg_kw["clip_grad_norm"])
        params_j = optax.apply_updates(params_j, updates)
        applied = adam.update(g_t, frozen_t, cfg_kw["clip_grad_norm"])
        assert applied == (not (case == "nonfinite" and step == 1))
        if not applied:
            assert all(torch.equal(params_t[n], before[0][n]) for n in params_t)
            assert all(torch.equal(adam.mu[n], before[1][n]) for n in params_t)
            assert adam.count == before[2]

        flat_j = {_kp(kp): np.asarray(v) for kp, v in
                  jax.tree_util.tree_flatten_with_path(params_j)[0]}
        sj = _jax_state(state_j)
        for k in SHAPES:
            t = adam.count[opt_t.label_for_path(k)]
            lr = opt_t.group_lr(adam.cfg, opt_t.label_for_path(k))
            tol = 1e-6 + (lr * 2.0 ** -23 / (1 - 0.999 ** t) if t else 0.0)
            np.testing.assert_allclose(params_t[names[k]].numpy(), flat_j[k],
                                       rtol=0, atol=tol, err_msg=f"{case} {step} {k}")
            np.testing.assert_allclose(adam.mu[names[k]].numpy(), sj[("mu", k)],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(adam.nu[names[k]].numpy(), sj[("nu", k)],
                                       rtol=0, atol=1e-6)
        for grp in opt_t.GROUPS:
            assert adam.count[grp] == sj[(grp, "count")], (case, step, grp)


def test_group_labels_and_rates():
    cfg = opt_t.OptimizerConfig()
    for path in SHAPES:
        assert opt_t.label_for_path(path) == opt_j.label_for_path(path)
        assert opt_t.label_for_path(path.replace("/", ".")) == opt_j.label_for_path(path)
    assert opt_t.group_lr(cfg, "grid") == pytest.approx(0.1)
    assert opt_t.group_lr(cfg, "delta_grid") == pytest.approx(0.1)
    assert opt_t.group_lr(cfg, "extrinsics") == pytest.approx(1e-4)
    assert opt_t.group_lr(cfg, "decoder") == pytest.approx(1e-3)


def test_unported_settings_raise():
    """Only an optimizer neither package knows raises (the name is kept):
    sgd, rmsprop and weight decay are ported (tests/test_torch_optimizers.py),
    as are the learning-rate schedules (tests/test_torch_schedules.py)."""
    p = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        opt_t.MaskedOptimizer(opt_t.OptimizerConfig(optimizer_type="lamb"), p)
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        opt_j._group_tx(opt_j.OptimizerConfig(optimizer_type="lamb"), "grid")
    for kw, kind in (({"optimizer_type": "sgd"}, "sgd"), ({"weight_decay": 0.1}, "adamw"),
                     ({"optimizer_type": "rmsprop", "weight_decay": 0.1}, "rmsprop"),
                     ({"use_lr_scheduler": True}, "adam")):
        assert opt_t.MaskedOptimizer(opt_t.OptimizerConfig(**kw), p).kind == kind
