"""Backward of the table gather and of the lattice: the port's plain
versions and autograd Functions against the JAX package, on the CPU.

- ``gather_dbary_plain`` against the Pallas ``multilevel_gather_dbary``
  (interpret mode) and the XLA backward's dbary: atol 1e-6 (float32 sums of
  F=2 products, reordered).
- ``table_grad_plain`` / ``dual_table_grad_plain`` against the XLA scatter
  backward: atol 1e-6 (the plain version sums in float64, XLA in float32).
  Against the Pallas ``table_grad_matmul_T`` / ``_dual_T`` and the legacy
  ``table_grad_matmul`` / ``_dual`` (interpret mode, with ``rows_used``):
  per entry within 2^-8 of the entry's sum of |bary * g|, because the TPU
  kernels multiply bary * g in bfloat16 (relative error up to 2^-9 per
  product) before the float32 sum.
- ``torch.autograd.gradcheck`` on the single and dual gather Functions in
  float32 (the wrappers take float32 or bfloat16 only): eps 1e-3, atol 1e-3,
  rtol 1e-2, because the gathers are bilinear and a float32 central
  difference loses about eps_f32 * |out| / eps = 1e-4 of the output. The
  lattice Function in float64, away from simplex faces (the weights are
  piecewise linear in x).
- The encodes' table and coordinate gradients against ``jax.grad`` of
  ``permuto_encode_T`` / ``permuto_encode_dual_T``: atol 1e-5, plus rtol
  1e-5 for the table gradients, whose coarse-level entries sum thousands of
  unit-sized events: XLA sums them in float32 (a relative error of a few
  1e-6 at |dT| ~ 4), the port's plain version in float64. The coordinate
  gradients carry the finest level's 1/scale = 1000, so there atol is 1e-5
  of the largest |dx| (float32 rounding of per-level terms ~ 1e3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.ops import pallas_gather, pallas_scatter
from pagnerf_tpu.ops import permuto_encoding as pe_j
from pagnerf_tpu.ops import table_gather as tg_j
from pagnerf_tpu_torch.ops import permuto_encoding as pe_t
from pagnerf_tpu_torch.ops import table_gather as tg_t

L, C, F, V = 3, 512, 2, 4
ROWS = (C * F) // pallas_gather.LANES


def _rand(seed, n=4 * 2 * ROWS, entries=C):
    rng = np.random.default_rng(seed)
    ta = rng.normal(size=(L, C, F)).astype(np.float32)
    tb = rng.normal(size=(L, C, F)).astype(np.float32)
    idx = rng.integers(0, entries, size=(L, V, n)).astype(np.int32)
    bary = rng.uniform(0, 1, size=(L, V, n)).astype(np.float32)
    g_a = rng.normal(size=(L, F, n)).astype(np.float32)
    g_b = rng.normal(size=(L, F, n)).astype(np.float32)
    return ta, tb, idx, bary, g_a, g_b


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def test_dbary_plain_matches_pallas_interpret_and_xla():
    ta, _, idx, bary, g, _ = _rand(0)
    ref = pallas_gather.multilevel_gather_dbary(
        jnp.asarray(ta).reshape(L, ROWS, -1), jnp.asarray(idx), jnp.asarray(g),
        F, interpret=True)
    _, vjp = jax.vjp(lambda b: tg_j.multilevel_table_gather(
        jnp.asarray(ta), jnp.asarray(idx), b), jnp.asarray(bary))
    (xla,) = vjp(jnp.asarray(g))
    out = tg_t.gather_dbary_plain(*_t(ta, idx, g))
    assert out.shape == (L, V, idx.shape[2]) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_table_grad_plain_matches_xla_scatter(n):
    ta, tb, idx, bary, g_a, g_b = _rand(1, n=n)
    _, vjp = jax.vjp(lambda a: tg_j.multilevel_table_gather(
        a, jnp.asarray(idx), jnp.asarray(bary)), jnp.asarray(ta))
    (ref,) = vjp(jnp.asarray(g_a))
    _, vjp2 = jax.vjp(lambda a, b: tg_j.dual_multilevel_table_gather(
        a, b, jnp.asarray(idx), jnp.asarray(bary)), jnp.asarray(ta), jnp.asarray(tb))
    ref_a, ref_b = vjp2((jnp.asarray(g_a), jnp.asarray(g_b)))
    out = tg_t.table_grad_plain(*_t(idx, bary, g_a), C)
    oa, ob = tg_t.dual_table_grad_plain(*_t(idx, bary, g_a, g_b), C)
    assert out.shape == (L, C, F) and out.dtype == torch.float32
    for got, want in ((out, ref), (oa, ref_a), (ob, ref_b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _bf16_multiply_bound(idx, bary, g):
    """Per-entry bound for the TPU kernels' bfloat16 products: 2^-8 of the
    entry's sum of |bary * g| (plus float32 slack)."""
    mag = tg_t.table_grad_plain(*_t(idx, np.abs(bary), np.abs(g)), C).numpy()
    return 2.0 ** -8 * mag + 1e-6


@pytest.mark.parametrize("rows_used", [0, 3])
def test_table_grad_plain_matches_pallas_kernels(rows_used):
    entries = rows_used * pallas_scatter.LANES // F if rows_used else C
    _, _, idx, bary, g_a, g_b = _rand(2, n=300, entries=entries)
    plain = tg_t.table_grad_plain(*_t(idx, bary, g_a), C).numpy()
    pa, pb = (x.numpy() for x in tg_t.dual_table_grad_plain(
        *_t(idx, bary, g_a, g_b), C))
    bound_a = _bf16_multiply_bound(idx, bary, g_a)
    bound_b = _bf16_multiply_bound(idx, bary, g_b)
    for lv in range(L):
        args = (jnp.asarray(idx[lv]), jnp.asarray(bary[lv]))
        single_t = pallas_scatter.table_grad_matmul_T(
            *args, jnp.asarray(g_a[lv]), C, F, rows_used=rows_used, interpret=True)
        single = pallas_scatter.table_grad_matmul(
            *args, jnp.asarray(g_a[lv]), C, F, rows_used=rows_used, interpret=True)
        dual_t = pallas_scatter.table_grad_matmul_dual_T(
            *args, jnp.asarray(g_a[lv]), jnp.asarray(g_b[lv]), C, F,
            rows_used=rows_used, interpret=True)
        dual = pallas_scatter.table_grad_matmul_dual(
            *args, jnp.asarray(g_a[lv]), jnp.asarray(g_b[lv]), C, F,
            rows_used=rows_used, interpret=True)
        for got, ref, bound in ((plain[lv], single_t, bound_a[lv]),
                                (plain[lv], single, bound_a[lv]),
                                (pa[lv], dual_t[0], bound_a[lv]),
                                (pb[lv], dual_t[1], bound_b[lv]),
                                (pa[lv], dual[0], bound_a[lv]),
                                (pb[lv], dual[1], bound_b[lv])):
            assert np.all(np.abs(got - np.asarray(ref)) <= bound)


@pytest.mark.parametrize("within", [True, False], ids=["indices_within", "indices_beyond"])
def test_table_grad_rows_used_matches_full_plain_and_pallas(within):
    """``rows_used`` bounds the scatter to a level's live rows: with every
    index inside them the wrappers equal the full-capacity plain version
    bit for bit; events beyond them are dropped, as the Pallas
    ``table_grad_matmul_T(..., rows_used)`` drops them (its ``rows_used``
    counts 128-lane rows: 8 of them are 8 * 128 / F = 512 rows of [C, F])."""
    c, packed = 2048, 8
    entries = packed * pallas_scatter.LANES // F
    rng = np.random.default_rng(7)
    n = 400
    idx = rng.integers(0, entries if within else c, size=(L, V, n)).astype(np.int32)
    bary = rng.uniform(0, 1, size=(L, V, n)).astype(np.float32)
    g_a = rng.normal(size=(L, F, n)).astype(np.float32)
    g_b = rng.normal(size=(L, F, n)).astype(np.float32)
    rows_used = (entries,) * L
    got = tg_t.multilevel_table_grad(*_t(idx, bary, g_a), c, rows_used=rows_used)
    ga, gb = tg_t.dual_multilevel_table_grad(*_t(idx, bary, g_a, g_b), c,
                                             rows_used=rows_used)
    kept = np.where(idx < entries, bary, 0).astype(np.float32)
    for out, g in ((got, g_a), (ga, g_a), (gb, g_b)):
        assert out.shape == (L, c, F) and out.dtype == torch.float32
        assert torch.equal(out, tg_t.table_grad_plain(*_t(idx, kept, g), c))
        assert bool((out[:, entries:] == 0).all())
    if within:
        assert torch.equal(got, tg_t.table_grad_plain(*_t(idx, bary, g_a), c))
    mag = tg_t.table_grad_plain(*_t(idx, np.abs(kept), np.abs(g_a)), c).numpy()
    for lv in range(L):
        ref = pallas_scatter.table_grad_matmul_T(
            jnp.asarray(idx[lv]), jnp.asarray(bary[lv]), jnp.asarray(g_a[lv]), c, F,
            rows_used=packed, interpret=True)
        assert np.all(np.abs(got[lv].numpy() - np.asarray(ref))
                      <= 2.0 ** -8 * mag[lv] + 1e-6)


def test_scatter_plan_bounds_direct_levels_like_the_jax_package():
    """The port's live rows of a direct level are its reachable rows
    ``4 * Dm^3``, within the JAX package's 128-lane ``rows_used``; hashed
    levels are unbounded (0). Direct levels never take the float32 mode."""
    scales = np.geomspace(1.0, 1e-4, 24)
    cap = 1 << 18
    rows, modes = pe_t.scatter_plan(scales, cap, F)
    _, dm, direct, rows_j = pe_j.direct_level_specs(scales, cap, F)
    for r, d, dr, rj in zip(rows, dm, direct, rows_j):
        assert r == (V * int(d) ** 3 if dr else 0)
        assert r <= rj * pallas_scatter.LANES // F
    assert modes[0] == tg_t.SHARED and modes[-1] == tg_t.FLOAT
    assert all(m != tg_t.FLOAT for m, dr in zip(modes, direct) if dr)
    assert tg_t.level_modes(tg_t.live_rows(rows, 24, cap), cap) == tuple(
        tg_t.FLOAT if not dr else tg_t.SHARED if r <= tg_t.SHARED_MAX_ROWS
        else tg_t.GLOBAL for r, dr in zip(rows, direct))


def test_cpu_dispatch_takes_plain_and_counts_nothing():
    ta, tb, idx, bary, g_a, g_b = _t(*_rand(3))
    before = {k: fn.launches for k, fn in tg_t.KERNELS.items()}
    tg_t.multilevel_table_grad(idx, bary, g_a, C)
    tg_t.dual_multilevel_table_grad(idx, bary, g_a, g_b, C)
    tg_t.multilevel_gather_dbary(ta, idx, g_a)
    assert {k: fn.launches for k, fn in tg_t.KERNELS.items()} == before


@pytest.mark.parametrize("case", ["idx_dtype", "g_dtype", "g_shape", "bary_shape",
                                  "capacity", "contiguous", "dbary_table_dtype",
                                  "dbary_g_shape", "rows_used", "modes"])
def test_backward_wrappers_reject_what_the_kernels_do_not_take(case):
    ta, tb, idx, bary, g_a, g_b = _t(*_rand(4))
    fn, args = tg_t.multilevel_table_grad, [idx, bary, g_a, C]
    if case == "idx_dtype":
        args[0] = idx.long()
    elif case == "g_dtype":
        args[2] = g_a.bfloat16()
    elif case == "g_shape":
        fn, args = tg_t.dual_multilevel_table_grad, [idx, bary, g_a, g_b[:, :, 1:], C]
    elif case == "bary_shape":
        args[1] = bary[:, :3]
    elif case == "capacity":
        args[3] = 0
    elif case == "contiguous":
        args[2] = g_a.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "dbary_table_dtype":
        # float32 and bfloat16 rows (the bf16 table read's) are taken
        fn, args = tg_t.multilevel_gather_dbary, [ta.half(), idx, g_a]
    elif case == "dbary_g_shape":
        fn, args = tg_t.multilevel_gather_dbary, [ta, idx, g_a[:, :1]]
    elif case == "rows_used":
        args.append((C,) * (L - 1))
    elif case == "modes":
        args += [None, (tg_t.SHARED, tg_t.FLOAT, 7)]
    with pytest.raises((TypeError, ValueError)):
        fn(*args)


def test_gather_functions_gradcheck():
    rng = np.random.default_rng(5)
    c, n = 16, 9
    ta = torch.from_numpy(rng.normal(size=(2, c, F)).astype(np.float32))
    tb = torch.from_numpy(rng.normal(size=(2, c, F)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, c, (2, V, n)).astype(np.int32))
    bary = torch.from_numpy(rng.uniform(0, 1, (2, V, n)).astype(np.float32))
    ta.requires_grad_(), tb.requires_grad_(), bary.requires_grad_()
    tol = dict(eps=1e-3, atol=1e-3, rtol=1e-2)
    assert torch.autograd.gradcheck(
        lambda t, b: tg_t.multilevel_table_gather(t, idx, b), (ta, bary), **tol)
    assert torch.autograd.gradcheck(
        lambda a, b: tg_t.dual_multilevel_table_gather(a, b, idx, bary.detach()),
        (ta, tb), **tol)
    assert torch.autograd.gradcheck(
        lambda b: tg_t.dual_multilevel_table_gather(ta.detach(), tb.detach(), idx, b)[0],
        (bary,), **tol)


def test_dual_gather_weight_gradient_comes_from_a_side_only():
    ta, tb, idx, bary, g_a, g_b = _t(*_rand(6, n=50))
    bary.requires_grad_()
    _, ob = tg_t.dual_multilevel_table_gather(ta, tb, idx, bary)
    (ob * g_b).sum().backward()
    assert bary.grad is not None and float(bary.grad.abs().max()) == 0.0
    bary.grad = None
    oa, _ = tg_t.dual_multilevel_table_gather(ta, tb, idx, bary)
    (oa * g_a).sum().backward()
    np.testing.assert_allclose(bary.grad.numpy(),
                               tg_t.gather_dbary_plain(ta, idx, g_a).numpy(),
                               rtol=0, atol=1e-6)


def test_lattice_function_gradcheck():
    spec = pe_t.PermutoEncodingSpec(3, 2, 10, 1.0, 0.05)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-0.9, 0.9, (3, 40))).requires_grad_()
    log2_c = spec.capacity_log2
    inv_s = (1.0 / spec.scales).astype(np.float32)
    mm, dm, direct, _ = pe_t.direct_level_specs(spec.scales, spec.capacity, 2)
    assert torch.autograd.gradcheck(
        lambda xx: pe_t.lattice_all_levels(xx, log2_c, inv_s, mm, dm, direct)[1],
        (x,), eps=1e-7, atol=1e-6, rtol=1e-4)


def _encode_inputs(seed, n=2000):
    spec = pe_j.PermutoEncodingSpec(6, 2, 14, 1.0, 1e-3)    # direct + hashed levels
    rng = np.random.default_rng(seed)
    ta = rng.uniform(-1, 1, (6, spec.capacity, 2)).astype(np.float32)
    tb = rng.uniform(-1, 1, (6, spec.capacity, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    ga = rng.normal(size=(12, n)).astype(np.float32)
    gb = rng.normal(size=(12, n)).astype(np.float32)
    return spec, ta, tb, x, ga, gb


def _assert_dx_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_encode_gradients_match_jax():
    spec, ta, _, x, ga, _ = _encode_inputs(8)
    dt_j, dx_j = jax.grad(lambda t, xx: jnp.sum(pe_j.permuto_encode_T(
        t, xx, spec.scales) * ga), argnums=(0, 1))(jnp.asarray(ta), jnp.asarray(x))
    t, xx = (torch.from_numpy(a).requires_grad_() for a in (ta, x))
    (pe_t.permuto_encode_T(t, xx, spec.scales) * torch.from_numpy(ga)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(dt_j), rtol=1e-5, atol=1e-5)
    _assert_dx_close(xx.grad, dx_j)


def test_dual_encode_gradients_match_jax():
    spec, ta, tb, x, ga, gb = _encode_inputs(9)

    def loss_j(a, b, xx):
        fa, fb = pe_j.permuto_encode_dual_T(a, b, xx, spec.scales)
        return jnp.sum(fa * ga) + jnp.sum(fb * gb)
    da_j, db_j, dx_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(x))
    a, b, xx = (torch.from_numpy(v).requires_grad_() for v in (ta, tb, x))
    fa, fb = pe_t.permuto_encode_dual_T(a, b, xx, spec.scales)
    ((fa * torch.from_numpy(ga)).sum() + (fb * torch.from_numpy(gb)).sum()).backward()
    for got, want in ((a.grad, da_j), (b.grad, db_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    _assert_dx_close(xx.grad, dx_j)
    # the B side carries no coordinate gradient
    xx.grad = None
    _, fb = pe_t.permuto_encode_dual_T(a, b, xx, spec.scales)
    (fb * torch.from_numpy(gb)).sum().backward()
    assert float(xx.grad.abs().max()) == 0.0
