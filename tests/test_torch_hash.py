"""The hash encoding and the table-gather functions at V = 8 vertices (the
hash grid's voxel corners): the port against the JAX package, on the CPU.

- Hash indices equal to the JAX package's (its uint32 hash of the [3, 8, N]
  corners), weights within 1e-6 (they are the same float32 operations in
  the same order).
- ``hash_encode_T`` / ``hash_encode_dual_T`` against the JAX encodes:
  atol 1e-6 (float32 sums of 8 products, reordered); their table and
  coordinate gradients against ``jax.grad``: rtol 1e-4, atol 1e-6 of the
  largest entry (the coordinate gradient carries the finest level's
  resolution / 2).
- The plain gather, dual gather and dbary at V = 8 against the Pallas
  kernels in interpret mode: atol 1e-6. The plain table-gradient scatter
  (single and dual) against the XLA scatter backward within 64 eps_f32 of
  each entry's sum of |bary * g| (the port's accuracy contract), and
  against the Pallas ``table_grad_matmul_T`` / ``_dual_T`` (interpret)
  within 2^-8 of it, because those multiply bary * g in bfloat16.
- The scatter's per-level modes of a hash grid (GLOBAL, then the window
  merge), the wrappers' acceptance of V = 8 (and refusal of other V) and of
  the window mode at V = 4 and 8, the seeded init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.ops import hash_encoding as he_j
from pagnerf_tpu.ops import pallas_gather, pallas_scatter
from pagnerf_tpu.ops import table_gather as tg_j
from pagnerf_tpu_torch.ops import hash_encoding as he_t
from pagnerf_tpu_torch.ops import table_gather as tg_t

torch.set_num_threads(1)
L, C, F, V = 3, 512, 2, 8
ROWS = (C * F) // pallas_gather.LANES
F32_EPS = 2.0 ** -23


def _rand(seed, n=4 * 2 * ROWS):
    rng = np.random.default_rng(seed)
    ta = rng.normal(size=(L, C, F)).astype(np.float32)
    tb = rng.normal(size=(L, C, F)).astype(np.float32)
    idx = rng.integers(0, C, size=(L, V, n)).astype(np.int32)
    bary = rng.uniform(0, 1, size=(L, V, n)).astype(np.float32)
    g_a = rng.normal(size=(L, F, n)).astype(np.float32)
    g_b = rng.normal(size=(L, F, n)).astype(np.float32)
    return ta, tb, idx, bary, g_a, g_b


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _coords(seed=0, n=3000):
    # a margin beyond [-1, 1] exercises the clip
    return np.random.default_rng(seed).uniform(-1.1, 1.1, (3, n)).astype(np.float32)


def _jax_indices(x, res, log2_t):
    """The JAX encode's per-level indices and weights, as its
    ``hash_encode_T`` forms them."""
    xj = jnp.clip(jnp.asarray(x), -1.0, 1.0)
    corners_t = jnp.asarray(he_j._CORNERS.T)

    def level_index(r):
        cell = (xj + 1.0) * (r / 2.0)
        bl = jnp.floor(cell)
        frac = cell - bl
        corners = bl.astype(jnp.int32)[:, None, :] + corners_t[:, :, None]
        idx = he_j._spatial_hash_T(corners, log2_t)
        w = jnp.where(corners_t[:, :, None].astype(bool), frac[:, None, :],
                      1.0 - frac[:, None, :])
        return idx, w[0] * w[1] * w[2]

    idx, w = jax.vmap(level_index)(jnp.asarray(np.asarray(res), jnp.float32))
    return np.asarray(idx), np.asarray(w)


@pytest.mark.parametrize("levels, base, finest, log2_t", [
    (4, 16, 512, 8), (14, 16, 512, 19), (1, 16, 512, 10)])
def test_hash_indices_match_jax(levels, base, finest, log2_t):
    res = he_t.geometric_resolutions(base, finest, levels)
    np.testing.assert_array_equal(res, he_j.geometric_resolutions(base, finest, levels))
    x = _coords(levels)
    idx_j, w_j = _jax_indices(x, res, log2_t)
    idx_t, w_t = he_t.hash_indices(torch.from_numpy(x), res, log2_t)
    assert idx_t.dtype == torch.int32 and idx_t.shape == (levels, 8, x.shape[1])
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=0, atol=1e-6)
    corners = np.random.default_rng(1).integers(0, 514, (3, 8, 100)).astype(np.int32)
    np.testing.assert_array_equal(
        he_t._spatial_hash_T(torch.from_numpy(corners), log2_t).numpy(),
        np.asarray(he_j._spatial_hash_T(jnp.asarray(corners), log2_t)))


def _tables(seed, levels=4, log2_t=8):
    rng = np.random.default_rng(seed)
    shape = (levels, 1 << log2_t, F)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def test_hash_encode_and_dual_match_jax():
    res = he_j.geometric_resolutions(16, 512, 4)
    x = _coords(2)
    ta, tb = _tables(3)
    want = np.asarray(he_j.hash_encode_T(jnp.asarray(ta), jnp.asarray(x), res))
    got = he_t.hash_encode_T(*_t(ta, x), res)
    assert got.shape == (4 * F, x.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    wa, wb = he_j.hash_encode_dual_T(jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(x), res)
    ga, gb = he_t.hash_encode_dual_T(*_t(ta, tb, x), res)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-6)
    assert torch.equal(ga, got)
    spec = he_t.HashEncodingSpec(4, F, 8, 16, 512)
    assert torch.equal(spec.encode_T(*_t(ta, x)), got)


def _close(got, want, what):
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=what)


def test_hash_encode_gradients_match_jax():
    res = he_j.geometric_resolutions(16, 512, 4)
    x = _coords(4, n=2000)
    ta, tb = _tables(5)
    w = np.random.default_rng(6).normal(size=(4 * F, x.shape[1])).astype(np.float32)

    def loss_j(a, b, xx):
        fa, fb = he_j.hash_encode_dual_T(a, b, xx, res)
        return jnp.sum(fa * w) + jnp.sum(fb * w[::-1])
    dta, dtb, dx = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(x))
    a, b, xx = (torch.from_numpy(v).requires_grad_() for v in (ta, tb, x))
    fa, fb = he_t.hash_encode_dual_T(a, b, xx, res)
    (torch.sum(fa * torch.from_numpy(w)) + torch.sum(fb * torch.from_numpy(w[::-1].copy()))
     ).backward()
    _close(a.grad.numpy(), np.asarray(dta), "tables A")
    _close(b.grad.numpy(), np.asarray(dtb), "tables B")
    _close(xx.grad.numpy(), np.asarray(dx), "coordinates (A side only)")

    dt_j, dx_j = jax.grad(lambda t, xx_: jnp.sum(he_j.hash_encode_T(t, xx_, res) * w),
                          argnums=(0, 1))(jnp.asarray(ta), jnp.asarray(x))
    a, xx = (torch.from_numpy(v).requires_grad_() for v in (ta, x))
    torch.sum(he_t.hash_encode_T(a, xx, res) * torch.from_numpy(w)).backward()
    _close(a.grad.numpy(), np.asarray(dt_j), "tables")
    _close(xx.grad.numpy(), np.asarray(dx_j), "coordinates")


def test_plain_gathers_match_pallas_interpret():
    ta, tb, idx, bary, _, _ = _rand(7)
    packed = lambda t: jnp.asarray(t).reshape(L, ROWS, -1)
    ref = pallas_gather.multilevel_gather_fwd(packed(ta), jnp.asarray(idx),
                                              jnp.asarray(bary), F, interpret=True)
    out = tg_t.multilevel_gather_plain(*_t(ta, idx, bary))
    assert out.shape == (L, F, idx.shape[2])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    ra, rb = pallas_gather.multilevel_gather_dual_fwd(
        packed(ta), packed(tb), jnp.asarray(idx), jnp.asarray(bary), F, interpret=True)
    oa, ob = tg_t.dual_gather_plain(*_t(ta, tb, idx, bary))
    np.testing.assert_allclose(oa.numpy(), np.asarray(ra), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ob.numpy(), np.asarray(rb), rtol=0, atol=1e-6)
    # the wrappers take V = 8 and reach the plain versions on the CPU
    assert torch.equal(tg_t.multilevel_table_gather(*_t(ta, idx, bary)), out)
    wa, wb = tg_t.dual_multilevel_table_gather(*_t(ta, tb, idx, bary))
    assert torch.equal(wa, oa) and torch.equal(wb, ob)


def test_plain_dbary_matches_pallas_interpret_and_xla():
    ta, _, idx, bary, g, _ = _rand(8)
    ref = pallas_gather.multilevel_gather_dbary(
        jnp.asarray(ta).reshape(L, ROWS, -1), jnp.asarray(idx), jnp.asarray(g), F,
        interpret=True)
    _, vjp = jax.vjp(lambda b: tg_j.multilevel_table_gather(
        jnp.asarray(ta), jnp.asarray(idx), b), jnp.asarray(bary))
    (xla,) = vjp(jnp.asarray(g))
    out = tg_t.gather_dbary_plain(*_t(ta, idx, g))
    assert out.shape == (L, V, idx.shape[2]) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=0, atol=1e-6)
    assert torch.equal(tg_t.multilevel_gather_dbary(*_t(ta, idx, g)), out)


def _within(got, want, mag, factor):
    assert np.all(np.abs(got - want) <= factor * mag + 1e-30)


@pytest.mark.parametrize("n", [37, 1000])
def test_plain_scatter_matches_xla_and_pallas(n):
    ta, tb, idx, bary, g_a, g_b = _rand(9, n=n)
    mag_a = tg_t.table_grad_plain(*_t(idx, np.abs(bary), np.abs(g_a)), C).numpy()
    mag_b = tg_t.table_grad_plain(*_t(idx, np.abs(bary), np.abs(g_b)), C).numpy()
    _, vjp = jax.vjp(lambda a, b: tg_j.dual_multilevel_table_gather(
        a, b, jnp.asarray(idx), jnp.asarray(bary)), jnp.asarray(ta), jnp.asarray(tb))
    xa, xb = vjp((jnp.asarray(g_a), jnp.asarray(g_b)))
    single = tg_t.table_grad_plain(*_t(idx, bary, g_a), C).numpy()
    pa, pb = (o.numpy() for o in tg_t.dual_table_grad_plain(*_t(idx, bary, g_a, g_b), C))
    for got, want, mag in ((single, xa, mag_a), (pa, xa, mag_a), (pb, xb, mag_b)):
        _within(got, np.asarray(want), mag, 64 * F32_EPS)
    for lv in range(L):
        args = (jnp.asarray(idx[lv]), jnp.asarray(bary[lv]))
        st = pallas_scatter.table_grad_matmul_T(*args, jnp.asarray(g_a[lv]), C, F,
                                                rows_used=0, interpret=True)
        da, db = pallas_scatter.table_grad_matmul_dual_T(
            *args, jnp.asarray(g_a[lv]), jnp.asarray(g_b[lv]), C, F, rows_used=0,
            interpret=True)
        for got, want, mag in ((single[lv], st, mag_a[lv]), (pa[lv], da, mag_a[lv]),
                               (pb[lv], db, mag_b[lv])):
            _within(got, np.asarray(want).reshape(C, F), mag, 2.0 ** -8)
    got = tg_t.multilevel_table_grad(*_t(idx, bary, g_a), C,
                                     modes=he_t.scatter_modes((16, 20, 600), C))
    assert torch.equal(got, torch.from_numpy(single))


def test_scatter_modes_of_the_hash_grid():
    """GLOBAL up to ``HASH_WINDOW_MIN_CORNERS`` lattice corners, the window
    merge beyond; the plan of panoptic_nerf.yaml's grid."""
    spec = he_t.HashEncodingSpec(14, 2, 19, 16, 512)
    modes = he_t.scatter_modes(spec.resolutions, spec.capacity)
    corners = (spec.resolutions.astype(np.int64) + 1) ** 3
    assert len(modes) == 14
    for m, k in zip(modes, corners):
        assert m == (tg_t.GLOBAL if k <= he_t.HASH_WINDOW_MIN_CORNERS else tg_t.WINDOW)
    # the measured plan of panoptic_nerf.yaml's grid (resolutions 16 -> 512)
    assert modes == (tg_t.GLOBAL,) * 8 + (tg_t.WINDOW,) * 6
    assert he_t.scatter_modes((16, 64), 1 << 8) == (tg_t.GLOBAL, tg_t.GLOBAL)
    assert he_t.scatter_modes((16, 600), 1 << 8) == (tg_t.GLOBAL, tg_t.WINDOW)
    assert tg_t.level_modes((C,) * 14, C, modes) == modes


@pytest.mark.parametrize("v", [4, 8])
@pytest.mark.parametrize("modes", [(3, 3, 3), (0, 3, 1), (2, 3, 2), (3, 1, 0)])
def test_window_mode_takes_the_plain_version_on_the_cpu(v, modes):
    """The window mode (3) passes the wrappers' checks beside the others, at
    V = 4 and 8; on the CPU the result is the plain version's, bit for bit,
    single and dual; a mode outside 0..3 raises."""
    _, _, idx, bary, g_a, g_b = _rand(20 + v, n=301)
    idx, bary = idx[:, :v].copy(), bary[:, :v].copy()
    want_a = tg_t.table_grad_plain(*_t(idx, bary, g_a), C)
    want_b = tg_t.table_grad_plain(*_t(idx, bary, g_b), C)
    got = tg_t.multilevel_table_grad(*_t(idx, bary, g_a), C, modes=modes)
    da, db = tg_t.dual_multilevel_table_grad(*_t(idx, bary, g_a, g_b), C, modes=modes)
    assert torch.equal(got, want_a) and torch.equal(da, want_a) and torch.equal(db, want_b)
    for bad in (4, -1):
        with pytest.raises(ValueError, match="WINDOW"):
            tg_t.multilevel_table_grad(*_t(idx, bary, g_a), C, modes=modes[:2] + (bad,))


@pytest.mark.parametrize("v", [3, 5, 16])
def test_wrappers_refuse_other_vertex_counts(v):
    ta, _, idx, bary, g, _ = _rand(10)
    idx, bary = idx[:, :1].repeat(v, 1), bary[:, :1].repeat(v, 1)
    for call in (lambda: tg_t.multilevel_table_gather(*_t(ta, idx, bary)),
                 lambda: tg_t.multilevel_table_grad(*_t(idx, bary, g), C),
                 lambda: tg_t.multilevel_gather_dbary(*_t(ta, idx, g))):
        with pytest.raises(ValueError, match="V in"):
            call()


def test_hash_spec_init_is_seeded_and_bounded():
    spec = he_t.HashEncodingSpec(3, 2, 6, 16, 64)
    a = spec.init(torch.Generator().manual_seed(0))
    b = spec.init(torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == (3, 64, 2) and a.dtype == torch.float32
    assert float(a.abs().max()) <= 1e-4 and float(a.std()) > 1e-5
