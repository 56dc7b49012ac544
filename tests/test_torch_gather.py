"""Table-gather parity: the port's plain single and dual gathers against the
JAX Pallas kernels (interpret mode, as tests/test_pallas_gather.py runs
them) and against the XLA table gathers, float32, atol 1e-6; dual equals two
singles bit for bit; the wrapper's contract checks; and the permutohedral
encodes against the JAX encodes in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.ops import pallas_gather, table_gather as tg_j
from pagnerf_tpu.ops import permuto_encoding as pe_j
from pagnerf_tpu_torch.ops import permuto_encoding as pe_t
from pagnerf_tpu_torch.ops import table_gather as tg_t

L, C, F, V = 3, 512, 2, 4
ROWS = (C * F) // pallas_gather.LANES


def _rand(seed, n=4 * 2 * ROWS):
    rng = np.random.default_rng(seed)
    ta = rng.normal(size=(L, C, F)).astype(np.float32)
    tb = rng.normal(size=(L, C, F)).astype(np.float32)
    idx = rng.integers(0, C, size=(L, V, n)).astype(np.int32)
    bary = rng.uniform(0, 1, size=(L, V, n)).astype(np.float32)
    return ta, tb, idx, bary


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def test_plain_matches_pallas_interpret():
    ta, _, idx, bary = _rand(0)
    ref = pallas_gather.multilevel_gather_fwd(
        jnp.asarray(ta).reshape(L, ROWS, -1), jnp.asarray(idx),
        jnp.asarray(bary), F, interpret=True)
    out = tg_t.multilevel_gather_plain(*_t(ta, idx, bary))
    assert out.shape == (L, F, idx.shape[2]) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_dual_plain_matches_pallas_interpret():
    ta, tb, idx, bary = _rand(1)
    ra, rb = pallas_gather.multilevel_gather_dual_fwd(
        jnp.asarray(ta).reshape(L, ROWS, -1), jnp.asarray(tb).reshape(L, ROWS, -1),
        jnp.asarray(idx), jnp.asarray(bary), F, interpret=True)
    oa, ob = tg_t.dual_gather_plain(*_t(ta, tb, idx, bary))
    np.testing.assert_allclose(oa.numpy(), np.asarray(ra), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ob.numpy(), np.asarray(rb), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_matches_xla_table_gathers(n):
    ta, tb, idx, bary = _rand(2, n=n)
    rj = tg_j.multilevel_table_gather(jnp.asarray(ta), jnp.asarray(idx),
                                      jnp.asarray(bary))
    raj, rbj = tg_j.dual_multilevel_table_gather(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(idx), jnp.asarray(bary))
    out = tg_t.multilevel_table_gather(*_t(ta, idx, bary))
    oa, ob = tg_t.dual_multilevel_table_gather(*_t(ta, tb, idx, bary))
    for got, ref in ((out, rj), (oa, raj), (ob, rbj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_bit_exact_vs_two_singles(dtype):
    ta, tb, idx, bary = _rand(3)
    ta, tb, idx, bary = _t(ta, tb, idx, bary)
    ta, tb, bary = ta.to(dtype), tb.to(dtype), bary.to(dtype)
    oa, ob = tg_t.dual_multilevel_table_gather(ta, tb, idx, bary)
    assert oa.dtype == dtype
    assert torch.equal(oa, tg_t.multilevel_table_gather(ta, idx, bary))
    assert torch.equal(ob, tg_t.multilevel_table_gather(tb, idx, bary))


def test_bf16_rounds_once_from_float32():
    ta, _, idx, bary = _rand(4)
    ta16 = torch.from_numpy(ta).bfloat16()
    b16 = torch.from_numpy(bary).bfloat16()
    idx = torch.from_numpy(idx)
    out = tg_t.multilevel_gather_plain(ta16, idx, b16)
    ref = tg_t.multilevel_gather_plain(ta16.float(), idx, b16.float()).bfloat16()
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


def test_cpu_dispatch_takes_plain_and_counts_nothing():
    ta, tb, idx, bary = _t(*_rand(5))
    before = (tg_t.multilevel_table_gather.launches,
              tg_t.dual_multilevel_table_gather.launches)
    tg_t.multilevel_table_gather(ta, idx, bary)
    tg_t.dual_multilevel_table_gather(ta, tb, idx, bary)
    assert (tg_t.multilevel_table_gather.launches,
            tg_t.dual_multilevel_table_gather.launches) == before


@pytest.mark.parametrize("case", ["idx_dtype", "bary_dtype", "table_dtype",
                                  "shape", "feat", "contiguous", "dual_shape",
                                  "grad"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    ta, tb, idx, bary = _t(*_rand(6))
    args = [ta, idx, bary]
    fn = tg_t.multilevel_table_gather
    if case == "idx_dtype":
        args[1] = idx.long()
    elif case == "bary_dtype":
        args[2] = bary.double()
    elif case == "table_dtype":
        args[0], args[2] = ta.half(), bary.half()
    elif case == "shape":
        args[1], args[2] = idx[:, :3], bary[:, :3]
    elif case == "feat":
        args[0] = torch.zeros((L, C, 3))
    elif case == "contiguous":
        args[1] = idx.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "dual_shape":
        fn = tg_t.dual_multilevel_table_gather
        args = [ta, tb[:, :256], idx, bary]
    elif case == "grad":
        # the gather is differentiable now; its table-gradient kernel takes
        # float32 cotangents [L, F, N] only
        fn = tg_t.multilevel_table_grad
        args = [idx, bary, torch.zeros((L, F, idx.shape[2]), dtype=torch.bfloat16), C]
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        fn(*args)


def _encode_inputs(seed=7, n=3000):
    spec = pe_j.PermutoEncodingSpec(6, 2, 14, 1.0, 1e-3)    # direct + hashed levels
    assert 0 < pe_j.direct_level_specs(spec.scales, spec.capacity, 2)[2].sum() < 6
    rng = np.random.default_rng(seed)
    ta = rng.uniform(-1, 1, (6, spec.capacity, 2)).astype(np.float32)
    tb = rng.uniform(-1, 1, (6, spec.capacity, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    return spec, ta, tb, x


def test_permuto_encode_matches_jax():
    spec, ta, _, x = _encode_inputs()
    ref = pe_j.permuto_encode_T(jnp.asarray(ta), jnp.asarray(x), spec.scales)
    out = pe_t.permuto_encode_T(torch.from_numpy(ta), torch.from_numpy(x),
                                spec.scales)
    assert out.shape == (12, x.shape[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_permuto_encode_dual_matches_jax():
    spec, ta, tb, x = _encode_inputs(seed=8)
    ra, rb = pe_j.permuto_encode_dual_T(jnp.asarray(ta), jnp.asarray(tb),
                                        jnp.asarray(x), spec.scales)
    oa, ob = pe_t.permuto_encode_dual_T(torch.from_numpy(ta), torch.from_numpy(tb),
                                        torch.from_numpy(x), spec.scales)
    np.testing.assert_allclose(oa.numpy(), np.asarray(ra), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ob.numpy(), np.asarray(rb), rtol=0, atol=1e-6)
    single = pe_t.permuto_encode_T(torch.from_numpy(tb), torch.from_numpy(x),
                                   spec.scales)
    assert torch.equal(ob, single)


def test_encoding_spec_init_is_seeded_and_bounded():
    spec = pe_t.PermutoEncodingSpec(4, 2, 8, 1.0, 0.05)
    a = spec.init(torch.Generator().manual_seed(0))
    b = spec.init(torch.Generator().manual_seed(0))
    assert a.shape == (4, 256, 2) and torch.equal(a, b)
    assert float(a.abs().max()) <= 1e-4
    np.testing.assert_allclose(spec.scales, pe_j.PermutoEncodingSpec(
        4, 2, 8, 1.0, 0.05).scales)
