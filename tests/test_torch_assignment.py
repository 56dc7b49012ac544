"""The port's exact assignment (``ops/assignment.py``) against the JAX
package's device solver ``pagnerf_tpu/ops/assignment.py:41 lap_assign``,
on the CPU, on the cases of ``tests/test_assignment.py``: random k x m
(more columns, more rows, square), separated costs, absent rows, more
present rows than columns, 200 x 200 with rejection penalties, quantised
near ties, plateaus, two-tier ties with penalties, the deployed 20 labels
of 200 against 200 slots, and non-finite costs through
``hungarian_assign``.

The plain version (what ``lap_assign`` runs on CPU tensors) follows the
JAX algorithm's float32 operations in their order, so the matchings are
identical, ties included; the matched cost also equals scipy's optimum
within float32 rounding (the bound of ``tests/test_assignment.py``). The
batched entry equals per-image calls; the wrapper's checks refuse what the
kernel does not take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.losses.lin_assignment import hungarian_assign as hungarian_j
from pagnerf_tpu.losses.lin_assignment import hungarian_host
from pagnerf_tpu.ops.assignment import lap_assign as lap_j
from pagnerf_tpu_torch.losses.lin_assignment import hungarian_assign as hungarian_t
from pagnerf_tpu_torch.ops import assignment as as_t

torch.set_num_threads(1)


def matched_cost(cost, present, assign):
    rows = np.nonzero(present)[0][:cost.shape[1]]
    return float(sum(cost[r, assign[r]] for r in rows))


def _cases():
    """(name, cost, present, tol) of ``tests/test_assignment.py``."""
    out = []
    for k, m, seed in [(5, 5, 0), (8, 12, 1), (12, 8, 2), (30, 30, 3)]:
        rng = np.random.default_rng(seed)
        cost = rng.uniform(-1, 0, (k, m)).astype(np.float32)
        out.append((f"random_{k}x{m}", cost, rng.random(k) > 0.2, None))
    out.append(("separated", np.array([[0.0, 5, 5, 5], [5, 5, 0, 5], [5, 0, 5, 5]],
                                      np.float32), np.ones(3, bool), None))
    cost = np.zeros((4, 3), np.float32)
    cost[1] = [-1, 0, 0]
    out.append(("absent_rows", cost, np.array([False, True, False, False]), None))
    rng = np.random.default_rng(4)
    out.append(("more_rows", rng.uniform(-1, 0, (10, 4)).astype(np.float32),
                np.ones(10, bool), None))
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        cost = rng.uniform(-1.0, 0.0, (200, 200)).astype(np.float32)
        penal = rng.random((200, 200)) < 0.3
        penal[np.arange(200), rng.integers(0, 200, 200)] = False
        cost = np.where(penal, cost + 10000.0, cost).astype(np.float32)
        out.append((f"penalties_{seed}", cost, rng.random(200) > 0.1, 1.0))
    for quant in (1.0, 0.1, 0.01):
        rng = np.random.default_rng(7)
        cost = (np.round(rng.uniform(-1.0, 0.0, (200, 200)) / quant) * quant
                ).astype(np.float32)
        out.append((f"near_ties_{quant}", cost, np.ones(200, bool), None))
    for i, cost in enumerate((np.zeros((200, 200), np.float32),
                              np.full((200, 200), -0.5, np.float32),
                              (-np.outer(np.linspace(0, 1, 200),
                                         np.linspace(0, 1, 200))).astype(np.float32))):
        out.append((f"plateau_{i}", cost, np.ones(200, bool), None))
    rng = np.random.default_rng(11)
    base = rng.choice([-1.0, -0.999999], size=(200, 200))
    penal = np.zeros((200, 200), bool)
    penal[:, :100] = rng.random((200, 100)) < 0.5
    out.append(("two_tier", np.where(penal, base + 10000.0, base).astype(np.float32),
                np.ones(200, bool), 1.0))
    rng = np.random.default_rng(13)
    emb, slots = rng.normal(size=(200, 8)), rng.normal(size=(200, 8))
    cost = ((emb[:, None] - slots[None]) ** 2).sum(-1).astype(np.float32)
    present = np.zeros(200, bool)
    present[rng.choice(200, 20, replace=False)] = True
    penal = rng.random((200, 200)) < 0.85
    penal[np.arange(200), cost.argmin(1)] = False
    out.append(("deployed_20_of_200", np.where(penal, cost + 10000.0, cost).astype(
        np.float32), present, 1.0))
    return out


CASES = {name: (cost, present, tol) for name, cost, present, tol in _cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_jv_equals_jax_lap_assign(name):
    cost, present, tol = CASES[name]
    want = np.asarray(lap_j(jnp.asarray(cost), jnp.asarray(present)))
    got = as_t.lap_assign(torch.from_numpy(cost), torch.from_numpy(present))
    assert got.dtype == torch.int64 and got.shape == (cost.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # a valid matching of scipy's optimal cost (f32 rounding)
    rows = np.nonzero(present)[0][:cost.shape[1]]
    a = got.numpy()
    assert len(set(a[rows])) == len(rows)
    assert np.all(a[np.setdiff1d(np.arange(cost.shape[0]), rows)] == 0)
    c_ref = matched_cost(cost, present, hungarian_host(cost, present))
    if tol is None:
        tol = 1e-4 * max(1.0, float(np.abs(cost[rows]).max())) * max(len(rows), 1)
    assert matched_cost(cost, present, a) <= c_ref + tol


def test_batched_entry_equals_per_image_calls():
    rng = np.random.default_rng(5)
    costs = rng.uniform(-1, 0, (4, 12, 30)).astype(np.float32)
    costs[2] = np.round(costs[2] * 4) / 4               # ties in one image
    present = rng.random((4, 12)) > 0.3
    batched = as_t.lap_assign(torch.from_numpy(costs), torch.from_numpy(present))
    assert batched.shape == (4, 12) and batched.dtype == torch.int64
    for b in range(4):
        single = as_t.lap_assign(torch.from_numpy(costs[b]), torch.from_numpy(present[b]))
        assert torch.equal(batched[b], single), b
        np.testing.assert_array_equal(
            batched[b].numpy(), np.asarray(lap_j(jnp.asarray(costs[b]),
                                                 jnp.asarray(present[b]))))
    # no image at all
    assert as_t.lap_assign(torch.zeros((0, 3, 4)), torch.zeros((0, 3), dtype=torch.bool)
                           ).shape == (0, 3)


def test_nonfinite_costs_through_hungarian_assign():
    rng = np.random.default_rng(21)
    cost = rng.uniform(-1, 0, (2, 8, 20)).astype(np.float32)
    cost[0, 0, :10] = np.inf
    cost[0, 3, 5] = np.nan
    cost[1, 2, :] = -np.inf
    present = np.ones((2, 8), bool)
    got = hungarian_t(torch.from_numpy(cost), torch.from_numpy(present)).numpy()
    for b in range(2):
        want = np.asarray(hungarian_j(jnp.asarray(cost[b]), jnp.asarray(present[b])))
        np.testing.assert_array_equal(got[b], want)
        assert len(set(got[b].tolist())) == 8


def test_wrapper_refusals():
    cost = torch.zeros((2, 3, 4))
    with pytest.raises(TypeError, match="float32"):
        as_t.lap_assign(cost.double(), torch.ones((2, 3), dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        as_t.lap_assign(cost, torch.ones((2, 3)))
    with pytest.raises(ValueError, match=r"\[B, K, M\]"):
        as_t.lap_assign(cost, torch.ones((2, 4), dtype=torch.bool))
    assert as_t.smem_bytes(200, 200) < 48 * 1024
