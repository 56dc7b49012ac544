"""The encode's coordinate gradient (``permuto_encoding.encode_dx``: on the
card one kernel, ``csrc/permuto_encode_bwd.cu``, for dbary and the lattice
backward together) on the CPU, where it takes its plain version
``encode_dx_plain``.

- ``encode_dx_plain`` on the port's lattice (idx and the packed rank of the
  CPU forward) against the JAX coordinate gradient, ``jax.vjp`` of
  ``permuto_encode_T`` / ``permuto_encode_dual_T`` with respect to the
  coordinates: float32 tables (F = 1, 2, 4) and the bf16 table read's
  bfloat16 rows (``PAGNERF_BF16_GATHER=1``), single, and dual with the rows
  given as the packed [L, C, 2F] copy, atol 1e-5 of the largest |dx|: the
  finest level's 1 / scale = 1000 scales the float32 rounding of each
  level's term. Bfloat16 tables (``compute_dtype``): the JAX package forms
  their dbary in bfloat16 arithmetic and the port in float32 rounded once,
  so there the lattice backward is held to JAX's at 1e-5 on the port's
  dbary, and the whole gradient within 2^-6 of its largest |dx|.
- ``_Encode.backward`` on the CPU goes through ``encode_dx_plain``, counts no
  launch, and gives dx bit-equal to the composition it replaced (the plain
  dbary of ``table_gather.dbary_rows``, rounded to the tables' dtype, then
  ``_lattice_levels_dx``).
- The wrapper rejects what the kernel does not take.

6 levels of 2^14 entries (direct and hashed levels), N = 2000, torch in one
thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.ops import permuto_encoding as pe_j
from pagnerf_tpu_torch.ops import permuto_encoding as pe_t
from pagnerf_tpu_torch.ops import table_gather as tg_t

torch.set_num_threads(1)
ENV = "PAGNERF_BF16_GATHER"
# (tables' dtype, bf16 table read)
CASES = {"float32": (torch.float32, False), "bfloat16": (torch.bfloat16, False),
         "bf16_read": (torch.float32, True)}


def _inputs(seed, f=2, n=2000, levels=6, log2_c=14, finest=1e-3):
    """A spec with direct and hashed levels, tables, coordinates in
    [-1, 1]^3 (a few on lattice points) and cotangents, from numpy."""
    spec = pe_j.PermutoEncodingSpec(levels, f, log2_c, 1.0, finest)
    rng = np.random.default_rng(seed)
    ta = rng.uniform(-1, 1, (levels, spec.capacity, f)).astype(np.float32)
    tb = rng.uniform(-1, 1, (levels, spec.capacity, f)).astype(np.float32)
    x = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    x[:, :16] = np.round(x[:, :16] * 4) / 4
    x[:, 16] = 0.0
    ga = rng.normal(size=(levels, f, n)).astype(np.float32)
    gb = rng.normal(size=(levels, f, n)).astype(np.float32)
    return spec, ta, tb, x, ga, gb


def _lattice(spec, x):
    """idx [L, 4, N] and the packed rank [L, N] of the port's CPU forward."""
    st = pe_t.level_statics(spec.scales, spec.capacity, spec.feature_dim)
    idx, _, rank = pe_t._lattice_levels(torch.from_numpy(x), st.log2_c, st.inv_scales,
                                        st.mm, st.dm, st.direct)
    return st, idx, rank


def _jax_dx(spec, ta, tb, x, ga, gb, dtype, dual):
    """The JAX coordinate gradient of the (dual) encode at cotangents ga
    (and gb) in the encode's output dtype."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    l, f, n = ga.shape
    cot_a = jnp.asarray(ga.reshape(l * f, n)).astype(jd)
    if dual:
        _, vjp = jax.vjp(lambda xx: pe_j.permuto_encode_dual_T(
            jnp.asarray(ta), jnp.asarray(tb), xx, spec.scales, jd), jnp.asarray(x))
        (dx,) = vjp((cot_a, jnp.asarray(gb.reshape(l * f, n)).astype(jd)))
    else:
        _, vjp = jax.vjp(lambda xx: pe_j.permuto_encode_T(
            jnp.asarray(ta), xx, spec.scales, jd), jnp.asarray(x))
        (dx,) = vjp(cot_a)
    return np.asarray(dx, dtype=np.float32)


def _jax_lattice_dx(spec, x, dbary):
    """The JAX lattice backward (the custom VJP of ``_lattice_all_levels``)
    of the weights' cotangent ``dbary`` [L, 4, N] float32."""
    mm, dm, direct, _ = pe_j.direct_level_specs(spec.scales, spec.capacity,
                                                spec.feature_dim)
    inv_scales = (1.0 / np.asarray(spec.scales)).astype(np.float32)
    log2_c = int(np.log2(spec.capacity))
    _, vjp = jax.vjp(lambda xx: pe_j._lattice_all_levels(log2_c, xx, inv_scales, mm, dm,
                                                         direct)[1], jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(dbary.numpy()))
    return np.asarray(dx)


def _assert_dx_close(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual_packed"])
@pytest.mark.parametrize("case", list(CASES))
def test_encode_dx_plain_matches_jax(case, dual, monkeypatch):
    dtype, bf16_read = CASES[case]
    spec, ta, tb, x, ga, gb = _inputs(1)
    if bf16_read:
        monkeypatch.setenv(ENV, "1")
    want = _jax_dx(spec, ta, tb, x, ga, gb, dtype, dual)
    st, idx, rank = _lattice(spec, x)
    a, b = torch.from_numpy(ta).to(dtype), torch.from_numpy(tb).to(dtype)
    rows_dtype = torch.bfloat16 if bf16_read else dtype
    rows = torch.cat((a, b), dim=2) if dual else a
    # the cotangent as the backward widens it from the output's dtype
    g = torch.from_numpy(ga).to(dtype).float()
    got = pe_t.encode_dx_plain(rows.to(rows_dtype), idx, rank, g, st.inv_scales, dtype)
    assert float(got.abs().max()) > 1.0        # the fine levels' 1 / scale shows
    if dtype != torch.bfloat16:
        _assert_dx_close(got, want)
        return
    # bfloat16 tables: the JAX package's gather backward forms a bfloat16
    # output's dbary in bfloat16 (its products and their sum, table_gather.py
    # ``_ml_bwd``), the port in float32 rounded once to bfloat16. So the
    # lattice backward is held to JAX's at 1e-5 on the port's dbary, and the
    # whole gradient to JAX's within 2^-6 of its largest |dx| (a few bfloat16
    # roundings of each level's dbary, 2^-9 each, through 6 levels).
    dbary = tg_t.gather_dbary_plain(a, idx, g).to(dtype).float()
    _assert_dx_close(got, _jax_lattice_dx(spec, x, dbary))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2.0 ** -6 * float(np.abs(want).max()))


@pytest.mark.parametrize("f", [1, 4])
def test_encode_dx_plain_matches_jax_feature_widths(f):
    spec, ta, tb, x, ga, gb = _inputs(2, f=f)
    want = _jax_dx(spec, ta, tb, x, ga, gb, torch.float32, False)
    st, idx, rank = _lattice(spec, x)
    got = pe_t.encode_dx_plain(torch.from_numpy(ta), idx, rank, torch.from_numpy(ga),
                               st.inv_scales)
    _assert_dx_close(got, want)


def _old_dx(ctx_inputs, dtype, bf16_read):
    """The backward's coordinate gradient as it was composed before
    ``encode_dx``: the plain dbary of ``dbary_rows``, rounded to the tables'
    dtype, then ``_lattice_levels_dx`` on the forward's rank."""
    x, a, idx, rank, g, inv_scales = ctx_inputs
    dbary = tg_t.gather_dbary_plain(tg_t.dbary_rows(a, bf16_read), idx, g)
    return pe_t._lattice_levels_dx(x, inv_scales, dbary.to(dtype).float(), rank)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_on_cpu_takes_plain_bit_equal_to_old_path(case, dual, monkeypatch):
    dtype, bf16_read = CASES[case]
    if bf16_read:
        monkeypatch.setenv(ENV, "1")
    spec, ta, tb, x, ga, gb = _inputs(3)
    calls = []
    plain = pe_t.encode_dx_plain

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)
    monkeypatch.setattr(pe_t, "encode_dx_plain", spy)
    tg_t.reset_launches()
    a = torch.from_numpy(ta).to(dtype).requires_grad_()
    b = torch.from_numpy(tb).to(dtype).requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    g_a, g_b = torch.from_numpy(ga).to(dtype), torch.from_numpy(gb).to(dtype)
    if dual:
        oa, ob = pe_t.fused_encode_dual(a, b, xx, spec.scales)
        ((oa * g_a).float().sum() + (ob * g_b).float().sum()).backward()
    else:
        oa = pe_t.fused_encode(a, xx, spec.scales)
        (oa * g_a).float().sum().backward()
    # the cotangent the backward got: d(sum(o * g))/do in the output's dtype
    st, idx, rank = _lattice(spec, x)
    want = _old_dx((xx.detach(), a.detach(), idx, rank, g_a.float(), st.inv_scales),
                   dtype, bf16_read)
    assert calls == [(spec.num_levels, spec.capacity, spec.feature_dim)]
    assert all(fn.launches == 0 for fn in tg_t.KERNELS.values())
    assert torch.equal(xx.grad, want)


def test_encode_dx_wrapper_on_cpu_is_the_plain_version():
    spec, ta, tb, x, ga, _ = _inputs(4, n=300)
    st, idx, rank = _lattice(spec, x)
    a, g = torch.from_numpy(ta), torch.from_numpy(ga)
    tg_t.reset_launches()
    got = pe_t.encode_dx(a, idx, rank, g, st.inv_scales)
    assert torch.equal(got, pe_t.encode_dx_plain(a, idx, rank, g, st.inv_scales))
    # A's half of the packed rows gives table A's dx
    packed = torch.cat((a, torch.from_numpy(tb)), dim=2)
    assert torch.equal(pe_t.encode_dx(packed, idx, rank, g, st.inv_scales), got)
    assert pe_t.encode_dx.launches == 0
    assert tg_t.KERNELS["encode_dx"] is pe_t.encode_dx


def test_encode_dx_zero_samples():
    spec, ta, _, _, _, _ = _inputs(5, n=64)
    st = pe_t.level_statics(spec.scales, spec.capacity, 2)
    l = spec.num_levels
    dx = pe_t.encode_dx(torch.from_numpy(ta), torch.zeros((l, 4, 0), dtype=torch.int32),
                        torch.zeros((l, 0), dtype=torch.uint8), torch.zeros((l, 2, 0)),
                        st.inv_scales)
    assert dx.shape == (3, 0) and dx.dtype == torch.float32


def _refusal(case):
    spec, ta, tb, x, ga, _ = _inputs(6, n=64)
    st, idx, rank = _lattice(spec, x)
    a, g, s = torch.from_numpy(ta), torch.from_numpy(ga), st.inv_scales
    args = [a, idx, rank, g, s]
    kwargs = {}
    if case == "verts_8":
        args[1] = torch.cat((idx, idx), dim=1)
        return args, kwargs, ValueError
    if case == "feature_3":
        args[0] = torch.cat((a, a[..., :1]), dim=2)
        args[3] = torch.cat((g, g[:, :1]), dim=1)
        return args, kwargs, ValueError
    if case == "idx_int64":
        args[1] = idx.long()
        return args, kwargs, TypeError
    if case == "rank_int32":
        args[2] = rank.int()
        return args, kwargs, TypeError
    if case == "g_float64":
        args[3] = g.double()
        return args, kwargs, TypeError
    if case == "rows_float16":
        args[0] = a.half()
        return args, kwargs, TypeError
    if case == "float32_rows_bf16_tables":
        kwargs["dtype"] = torch.bfloat16
        return args, kwargs, TypeError
    if case == "too_many_levels":
        k = tg_t.MAX_LEVELS + 1
        return ([torch.zeros((k, 16, 2)), torch.zeros((k, 4, 8), dtype=torch.int32),
                 torch.zeros((k, 8), dtype=torch.uint8), torch.zeros((k, 2, 8)),
                 np.ones(k, np.float32)], kwargs, ValueError)
    if case == "g_n_mismatch":
        args[3] = g[..., :-1].contiguous()
        return args, kwargs, ValueError
    if case == "rank_n_mismatch":
        args[2] = rank[:, :-1].contiguous()
        return args, kwargs, ValueError
    if case == "rows_width":
        args[0] = torch.cat((a, a, a), dim=2)
        return args, kwargs, ValueError
    if case == "rows_levels":
        args[0] = a[:-1].contiguous()
        return args, kwargs, ValueError
    if case == "scales":
        args[4] = s[:-1]
        return args, kwargs, ValueError
    if case == "contiguous":
        args[3] = g.transpose(0, 1).contiguous().transpose(0, 1)
        return args, kwargs, ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "verts_8", "feature_3", "idx_int64", "rank_int32", "g_float64", "rows_float16",
    "float32_rows_bf16_tables", "too_many_levels", "g_n_mismatch", "rank_n_mismatch",
    "rows_width", "rows_levels", "scales", "contiguous"])
def test_encode_dx_rejects_what_the_kernel_does_not_take(case):
    args, kwargs, err = _refusal(case)
    with pytest.raises(err):
        pe_t.encode_dx(*args, **kwargs)
