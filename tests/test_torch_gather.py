"""Table-gather parity: the port's plain single and dual gathers against the
JAX Pallas kernels (interpret mode, as tests/test_pallas_gather.py runs
them) and against the XLA table gathers, float32, atol 1e-6; dual equals two
singles bit for bit; the dual kernel's plain version on packed [L, C, 2F]
rows equals the two-table one bit for bit at V = 4 and 8, float32 and
bfloat16, and the packed copy is kept once per table version; the wrapper's
contract checks; and the permutohedral encodes against the JAX encodes in
float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.ops import pallas_gather, table_gather as tg_j
from pagnerf_tpu.ops import permuto_encoding as pe_j
from pagnerf_tpu_torch.ops import permuto_encoding as pe_t
from pagnerf_tpu_torch.ops import table_gather as tg_t
from pagnerf_tpu_torch.ops import table_pack

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


@pytest.mark.parametrize("v", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_dual_plain_matches_two_tables_and_pallas_interpret(v, dtype):
    """The dual kernel's plain version on the packed [L, C, 2F] rows equals
    the two-table plain version bit for bit (and is what the wrapper takes
    on the CPU); against the JAX dual kernel in interpret mode, which packs
    the same rows: float32 within the 1e-6 of the gathers' JAX tests,
    bfloat16 within (2V + 1) bf16 roundings of sum_v |bary * T| (the JAX
    kernel rounds each product and sum to bfloat16, the port once)."""
    rng = np.random.default_rng(20 + v)
    n = 4 * 2 * ROWS
    ta, tb, _, _ = _rand(20 + v)
    idx = rng.integers(0, C, size=(L, v, n)).astype(np.int32)
    bary = rng.uniform(0, 1, size=(L, v, n)).astype(np.float32)
    ta_t, tb_t, idx_t, bary_t = _t(ta, tb, idx, bary)
    ta_t, tb_t, bary_t = ta_t.to(dtype), tb_t.to(dtype), bary_t.to(dtype)
    packed = table_pack.packed_tables(ta_t, tb_t)
    assert packed.shape == (L, C, 2 * F) and torch.equal(packed[..., F:], tb_t)
    pa, pb = tg_t.dual_gather_packed_plain(packed, idx_t, bary_t)
    oa, ob = tg_t.dual_gather_plain(ta_t, tb_t, idx_t, bary_t)
    assert pa.dtype == dtype and pa.shape == (L, F, n)
    assert torch.equal(pa, oa) and torch.equal(pb, ob)
    wa, wb = tg_t.dual_multilevel_table_gather(ta_t, tb_t, idx_t, bary_t)
    assert torch.equal(wa, pa) and torch.equal(wb, pb)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    as_j = lambda x: jnp.asarray(x.float().numpy()).astype(jdt)
    ra, rb = pallas_gather.multilevel_gather_dual_fwd(
        as_j(ta_t).reshape(L, ROWS, -1), as_j(tb_t).reshape(L, ROWS, -1),
        jnp.asarray(idx), as_j(bary_t), F, interpret=True)
    for got, ref, tab in ((pa, ra, ta_t), (pb, rb, tb_t)):
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
        else:
            mag = tg_t.multilevel_gather_plain(tab.float().abs(), idx_t, bary_t.float())
            bound = (2 * v + 1) * 2.0 ** -8 * mag.numpy()
            assert np.all(np.abs(got.float().numpy() - ref) <= bound)


def test_packed_tables_one_copy_per_table_version():
    """The dual gather's kernel and the dual encode's share ``table_pack``'s
    one packed copy: kept while both tables are unchanged, made again once
    after an in-place update. The CPU dual gather packs for each call, so
    its outputs follow any write to a table, also one through ``.data``
    that moves no version counter."""
    ta, tb, idx, bary = _t(*_rand(8))
    assert pe_t.packed_tables is table_pack.packed_tables
    first = table_pack.packed_tables(ta, tb)
    assert table_pack.packed_tables(ta, tb) is first
    with torch.no_grad():
        tb.add_(1.0)
    again = table_pack.packed_tables(ta, tb)
    assert again is not first and torch.equal(again, torch.cat((ta, tb), dim=2))
    assert table_pack.packed_tables(ta, tb) is again and table_pack._packed_copy[2] is again
    tb.data.mul_(-2.0)
    _, out_b = tg_t.dual_multilevel_table_gather(ta, tb, idx, bary)
    assert torch.equal(out_b, tg_t.multilevel_gather_plain(tb, idx, bary))


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
