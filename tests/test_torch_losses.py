"""Losses of the training slice against the JAX package, on the CPU: loss
values atol 1e-6 (float32 sums in another order) and gradients with respect
to the rendered channels atol 1e-5; the host assignment against the JAX
package's device Jonker-Volgenant solver (same total cost)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.losses import lin_assignment as la_j
from pagnerf_tpu.losses import photometric as ph_j
from pagnerf_tpu.losses import regularizers as rg_j
from pagnerf_tpu.ops import assignment as as_j
from pagnerf_tpu_torch.losses import lin_assignment as la_t
from pagnerf_tpu_torch.losses import photometric as ph_t
from pagnerf_tpu_torch.losses import regularizers as rg_t
from pagnerf_tpu_torch.ops import assignment as as_t


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _value_and_grad_t(fn, x):
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt)
    out.backward()
    return float(out), xt.grad.numpy()


def _check(fn_j, fn_t, x):
    vj, gj = jax.value_and_grad(fn_j)(jnp.asarray(x))
    vt, gt = _value_and_grad_t(fn_t, x)
    np.testing.assert_allclose(vt, float(vj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gt, np.asarray(gj), rtol=0, atol=1e-5)


def test_rgb_l1_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    _check(lambda p: ph_j.rgb_l1_loss(p, jnp.asarray(target)),
           lambda p: ph_t.rgb_l1_loss(p, torch.from_numpy(target)), pred)


@pytest.mark.parametrize("sem_softmax,conf", [(True, False), (True, True),
                                              (False, False)])
def test_semantic_loss_matches_jax(sem_softmax, conf):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(400, 5)).astype(np.float32)
    if sem_softmax:
        x = _softmax(x)
        x[:7, 2] = 0.0          # zero and a hair below zero: the clamp's region
        x[7:9, 3] = -1e-9
    targets = rng.integers(-1, 6, 400).astype(np.int32)       # -1 and 5 invalid
    c = rng.uniform(0, 1, 400).astype(np.float32) if conf else None
    _check(lambda p: ph_j.semantic_loss(p, jnp.asarray(targets), sem_softmax, 0.7,
                                        None if c is None else jnp.asarray(c)),
           lambda p: ph_t.semantic_loss(p, torch.from_numpy(targets), sem_softmax,
                                        0.7, None if c is None else torch.from_numpy(c)),
           x)


def test_safe_prob_log_clamps():
    p = torch.tensor([-1e-9, 0.0, 0.5], requires_grad=True)
    out = ph_t.safe_prob_log(p)
    assert bool(torch.isfinite(out).all())
    out.sum().backward()
    assert float(p.grad[0]) == 0.0


def _things_inputs(seed, b=2, r=300, m=8, k=6):
    rng = np.random.default_rng(seed)
    probs = _softmax(rng.normal(size=(b, r, m)) * 2)
    labels = rng.integers(0, k + 1, (b, r)).astype(np.int32)   # k: out of range
    stuff = rng.uniform(size=(b, r)) < 0.2
    pts = rng.uniform(-1, 1, (b, r, 3)).astype(np.float32)
    return probs, labels, stuff, pts


@pytest.mark.parametrize("rejection,m", [(False, 8), (True, 8), (True, 64)],
                         ids=["plain", "rejection_noop", "rejection_active"])
def test_lin_assignment_things_loss_matches_jax(rejection, m):
    k = 6
    probs, labels, stuff, pts = _things_inputs(2, m=m, k=k)
    _check(lambda p: jnp.mean(la_j.lin_assignment_things_loss(
               p, jnp.asarray(labels), jnp.asarray(stuff), k,
               points_3d=jnp.asarray(pts), outlier_rejection=rejection)),
           lambda p: torch.mean(la_t.lin_assignment_things_loss(
               p, torch.from_numpy(labels), torch.from_numpy(stuff), k,
               points_3d=torch.from_numpy(pts), outlier_rejection=rejection)),
           probs)


def test_rejection_parts_match_jax():
    rng = np.random.default_rng(3)
    k, m = 12, 64
    cost = rng.normal(size=(k, m)).astype(np.float32)
    present = rng.uniform(size=k) < 0.7
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    labels = rng.integers(0, k + 2, 500).astype(np.int32)
    w = (rng.uniform(size=500) < 0.8).astype(np.float32)
    cj = la_j.centers_from_points_with_labels(jnp.asarray(pts), jnp.asarray(labels),
                                              jnp.asarray(w), k)
    ct = la_t.centers_from_points_with_labels(torch.from_numpy(pts),
                                              torch.from_numpy(labels).long(),
                                              torch.from_numpy(w), k)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    rj = la_j.add_position_id_range_cost(jnp.asarray(cost), cj[:, 0],
                                         jnp.asarray(present))
    rt = la_t.add_position_id_range_cost(torch.from_numpy(cost), ct[:, 0],
                                         torch.from_numpy(present))
    assert float(np.abs(np.asarray(rj) - cost).max()) == 10000.0   # rejection acts
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-6)
    sj, pj = la_j._label_slot_cost(jnp.asarray(_softmax(cost.T[:, :10])),
                                   jnp.asarray(labels[:m]), jnp.asarray(w[:m]), k)
    st, pt = la_t._label_slot_cost(torch.from_numpy(_softmax(cost.T[:, :10])),
                                   torch.from_numpy(labels[:m]).long(),
                                   torch.from_numpy(w[:m]), k)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)
    assert np.array_equal(pt.numpy(), np.asarray(pj))


@pytest.mark.parametrize("k,m,frac", [(10, 20, 0.6), (30, 8, 0.9), (5, 5, 1.0)])
def test_lap_assign_matches_jv_solver_cost(k, m, frac):
    rng = np.random.default_rng(k * m)
    cost = rng.normal(size=(k, m)).astype(np.float32)
    present = rng.uniform(size=k) < frac
    aj = np.asarray(as_j.lap_assign(jnp.asarray(cost), jnp.asarray(present)))
    at = as_t.lap_assign(torch.from_numpy(cost), torch.from_numpy(present)).numpy()
    rows = np.nonzero(present)[0][:m]
    assert len(set(at[rows])) == len(rows)                     # distinct columns
    np.testing.assert_allclose(cost[rows, at[rows]].sum(), cost[rows, aj[rows]].sum(),
                               rtol=0, atol=1e-5)
    assert np.all(at[np.setdiff1d(np.arange(k), rows)] == 0)


def test_segment_consistency_regularizer_matches_jax():
    rng = np.random.default_rng(4)
    k = 7
    probs = _softmax(rng.normal(size=(2, 300, k)) * 2) + 1e-27
    labels = rng.integers(0, k, (2, 300)).astype(np.int32)
    labels[1, :100] = 0                     # a dominant background segment
    _check(lambda p: rg_j.segment_consistency_regularizer(p, jnp.asarray(labels), k),
           lambda p: rg_t.segment_consistency_regularizer(p, torch.from_numpy(labels), k),
           probs)
