"""The fused permutohedral encode (``fused_encode`` / ``fused_encode_dual``):
its CPU path against the JAX package's encodes, and its wrapper contract.

- Forward against ``permuto_encode_T`` / ``permuto_encode_dual_T`` in
  float32: atol 1e-6 (the same lattice indices; weights and sums within
  float32 rounding).
- Gradients to the tables and the coordinates against ``jax.grad``: the
  tolerances of ``tests/test_torch_backward.py`` (atol 1e-5 plus rtol 1e-5
  for the tables, whose coarse entries sum thousands of events, float32 in
  XLA and float64 here; atol 1e-5 of the largest |dx| for the coordinates,
  which carry the finest level's 1/scale = 1000).
- The CPU path of the Function is the plain lattice and gathers: it equals
  ``encode_plain`` / ``dual_encode_plain`` and the unfused path (lattice
  Function, then the gather Functions) bit for bit, gradients included, in
  float32 and bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.ops import permuto_encoding as pe_j
from pagnerf_tpu_torch.ops import permuto_encoding as pe_t
from pagnerf_tpu_torch.ops import table_gather as tg_t
from pagnerf_tpu_torch.ops import table_pack


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


def _t(*arrays, grad=False):
    return tuple(torch.from_numpy(a).requires_grad_(grad) for a in arrays)


@pytest.mark.parametrize("f", [1, 2, 4])
def test_fused_encode_matches_jax(f):
    spec, ta, tb, x, _, _ = _inputs(0, f)
    want = pe_j.permuto_encode_T(jnp.asarray(ta), jnp.asarray(x), spec.scales)
    want_a, want_b = pe_j.permuto_encode_dual_T(jnp.asarray(ta), jnp.asarray(tb),
                                                jnp.asarray(x), spec.scales)
    a, b, xx = _t(ta, tb, x)
    out = pe_t.fused_encode(a, xx, spec.scales)
    out_a, out_b = pe_t.fused_encode_dual(a, b, xx, spec.scales)
    assert out.shape == (spec.num_levels, f, x.shape[1]) and out.dtype == torch.float32
    for got, ref in ((out, want), (out_a, want_a), (out_b, want_b)):
        np.testing.assert_allclose(got.reshape(-1, x.shape[1]).numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_fused_encode_gradients_match_jax(dual):
    spec, ta, tb, x, ga, gb = _inputs(1)
    l, f, n = ga.shape

    def loss_j(a, b, xx):
        if not dual:
            return jnp.sum(pe_j.permuto_encode_T(a, xx, spec.scales) * ga.reshape(l * f, n))
        fa, fb = pe_j.permuto_encode_dual_T(a, b, xx, spec.scales)
        return jnp.sum(fa * ga.reshape(l * f, n)) + jnp.sum(fb * gb.reshape(l * f, n))
    da_j, db_j, dx_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(x))
    a, b, xx = _t(ta, tb, x, grad=True)
    if dual:
        oa, ob = pe_t.fused_encode_dual(a, b, xx, spec.scales)
        ((oa * torch.from_numpy(ga)).sum() + (ob * torch.from_numpy(gb)).sum()).backward()
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(db_j), rtol=1e-5, atol=1e-5)
    else:
        (pe_t.fused_encode(a, xx, spec.scales) * torch.from_numpy(ga)).sum().backward()
        assert b.grad is None
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(da_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(dx_j), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(dx_j)).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_bit_equal_to_dual_a_and_to_plain(dtype):
    spec, ta, tb, x, _, _ = _inputs(2)
    a, b = (t.to(dtype) for t in _t(ta, tb))
    xx = torch.from_numpy(x)
    single = pe_t.fused_encode(a, xx, spec.scales)
    oa, ob = pe_t.fused_encode_dual(a, b, xx, spec.scales)
    assert single.dtype == dtype
    assert torch.equal(single, oa)
    assert torch.equal(single, pe_t.encode_plain(a, xx, spec.scales))
    pa, pb = pe_t.dual_encode_plain(a, b, xx, spec.scales)
    assert torch.equal(oa, pa) and torch.equal(ob, pb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_bit_equal_to_unfused_path(dtype):
    """The Function's backward (scatter over the weights rounded to the
    table dtype, dbary from the A side rounded to it, then the lattice
    backward) repeats the unfused lattice + gather Functions exactly."""
    spec, ta, tb, x, ga, gb = _inputs(3)
    grads = []
    for fused in (True, False):
        a, b, xx = _t(ta, tb, x, grad=True)
        if fused:
            oa, ob = pe_t.fused_encode_dual(a.to(dtype), b.to(dtype), xx, spec.scales)
        else:
            idx, bary = pe_t.lattice(a, xx, spec.scales)
            oa, ob = tg_t.dual_multilevel_table_gather(
                a.to(dtype), b.to(dtype), idx, bary.to(dtype),
                *pe_t.scatter_plan(spec.scales, spec.capacity, 2))
        ((oa.float() * torch.from_numpy(ga)).sum()
         + (ob.float() * torch.from_numpy(gb)).sum()).backward()
        grads.append((a.grad, b.grad, xx.grad))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_idx_bary_kept_only_when_a_gradient_is_needed():
    spec, ta, _, x, _, _ = _inputs(4, n=300)
    a, xx = _t(ta, x)
    assert pe_t.fused_encode(a, xx, spec.scales).grad_fn is None
    a.requires_grad_()
    with torch.no_grad():
        assert pe_t.fused_encode(a, xx, spec.scales).grad_fn is None
    out = pe_t.fused_encode(a, xx, spec.scales)
    saved_x, idx, bary, table = out.grad_fn.saved_tensors
    assert torch.equal(saved_x, xx) and table.data_ptr() == a.data_ptr()
    assert idx.dtype == torch.int32 and idx.shape == (spec.num_levels, 4, 300)
    assert bary.dtype == torch.float32 and bary.shape == idx.shape
    want_idx, want_bary = pe_t.lattice(a, xx, spec.scales)
    assert torch.equal(idx, want_idx) and torch.equal(bary, want_bary)


def test_fixed_coordinates_skip_dbary_and_lattice_backward(monkeypatch):
    """An anchor microbatch: the coordinates need no gradient, so the
    backward scatters the tables' gradients and nothing else."""
    spec, ta, tb, x, ga, gb = _inputs(5, n=300)
    a, b = _t(ta, tb, grad=True)

    def refuse(*args, **kwargs):
        raise AssertionError("dbary / lattice backward called for fixed coordinates")
    monkeypatch.setattr(tg_t, "multilevel_gather_dbary", refuse)
    monkeypatch.setattr(pe_t, "_lattice_levels_dx", refuse)
    oa, ob = pe_t.fused_encode_dual(a, b, torch.from_numpy(x), spec.scales)
    ((oa * torch.from_numpy(ga)).sum() + (ob * torch.from_numpy(gb)).sum()).backward()
    assert a.grad.shape == ta.shape and float(a.grad.abs().sum()) > 0
    assert float(b.grad.abs().sum()) > 0


def test_only_the_a_side_moves_the_coordinates():
    spec, ta, tb, x, _, gb = _inputs(6, n=300)
    a, b, xx = _t(ta, tb, x, grad=True)
    _, ob = pe_t.fused_encode_dual(a, b, xx, spec.scales)
    (ob * torch.from_numpy(gb)).sum().backward()
    assert float(xx.grad.abs().max()) == 0.0 and a.grad is not None


def test_level_statics_match_the_specs():
    spec, _, _, _, _, _ = _inputs(0)
    st = pe_t.level_statics(spec.scales, spec.capacity, 2)
    mm, dm, direct, _ = pe_t.direct_level_specs(spec.scales, spec.capacity, 2)
    assert st.log2_c == 14 and st.inv_scales.dtype == np.float32
    np.testing.assert_array_equal(st.inv_scales,
                                  (1.0 / np.asarray(spec.scales)).astype(np.float32))
    for got, want in ((st.mm, mm), (st.dm, dm), (st.direct, direct)):
        np.testing.assert_array_equal(got, want)
    assert (st.rows_used, st.modes) == pe_t.scatter_plan(spec.scales, spec.capacity, 2)
    assert any(direct) and not all(direct)


def test_cpu_dispatch_counts_no_launch_and_kernels_registered():
    spec, ta, tb, x, _, _ = _inputs(7, n=100)
    assert tg_t.KERNELS["encode"] is pe_t.fused_encode
    assert tg_t.KERNELS["dual_encode"] is pe_t.fused_encode_dual
    tg_t.reset_launches()
    a, b, xx = _t(ta, tb, x)
    pe_t.fused_encode(a, xx, spec.scales)
    pe_t.fused_encode_dual(a, b, xx, spec.scales)
    pe_t.permuto_encode_dual_T(a, b, xx, spec.scales)
    assert pe_t.fused_encode.launches == 0 and pe_t.fused_encode_dual.launches == 0
    pe_t.fused_encode.launches = 5
    tg_t.reset_launches()
    assert pe_t.fused_encode.launches == 0


def test_zero_samples():
    spec, ta, tb, _, _, _ = _inputs(8, n=64)
    a, b = _t(ta, tb)
    x = torch.zeros((3, 0))
    assert pe_t.fused_encode(a, x, spec.scales).shape == (spec.num_levels, 2, 0)
    oa, ob = pe_t.fused_encode_dual(a, b, x, spec.scales)
    assert oa.shape == ob.shape == (spec.num_levels, 2, 0)


def _bad(case, spec, a, b, x):
    """(tables, x, scales) that the wrappers must refuse, and the error."""
    s = spec.scales
    return {
        "x_dtype": ((a,), x.double(), s, TypeError),
        "x_shape": ((a,), x[:2], s, ValueError),
        "x_contiguity": ((a,), x.t().contiguous().t(), s, ValueError),
        "table_dtype": ((a.half(),), x, s, TypeError),
        "table_rank": ((a[0],), x, s, ValueError),
        "feature_width": ((torch.zeros((a.shape[0], a.shape[1], 3)),), x, s, ValueError),
        "capacity": ((a[:, :1000].contiguous(),), x, s, ValueError),
        "table_contiguity": ((a.transpose(0, 1).contiguous().transpose(0, 1),), x, s,
                             ValueError),
        "level_count": ((a,), x, s[:-1], ValueError),
        "too_many_levels": ((torch.zeros((65, 16, 2)),), x, np.geomspace(1, 1e-3, 65),
                            ValueError),
        "dual_shape": ((a, b[:-1].contiguous()), x, s, ValueError),
        "dual_dtype": ((a, b.to(torch.bfloat16)), x, s, ValueError),
        "device": ((a.to("meta"),), x, s, ValueError),
    }[case]


@pytest.mark.parametrize("case", ["x_dtype", "x_shape", "x_contiguity", "table_dtype",
                                  "table_rank", "feature_width", "capacity",
                                  "table_contiguity", "level_count", "too_many_levels",
                                  "dual_shape", "dual_dtype", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    spec, ta, tb, x, _, _ = _inputs(9, n=64)
    a, b, xx = _t(ta, tb, x)
    tables, xb, scales, err = _bad(case, spec, a, b, xx)
    with pytest.raises(err):
        if len(tables) == 2:
            pe_t.fused_encode_dual(tables[0], tables[1], xb, scales)
        else:
            pe_t.fused_encode(tables[0], xb, scales)


def test_rank_kept_for_the_backward_is_the_lattice_rank():
    """The Function keeps the forward's rank, one byte per level and
    sample (coordinate i's rank at bits 2i); on the CPU it is the plain
    lattice's ``_rank_and_el`` rank, and the JAX package's, so dx formed on
    it equals dx on a recomputed rank bit for bit."""
    spec, ta, tb, x, ga, _ = _inputs(8, n=500)
    a, b, xx = _t(ta, tb, x, grad=True)
    oa, _ = pe_t.fused_encode_dual(a, b, xx, spec.scales)
    rank = oa.grad_fn.rank
    assert rank.dtype == torch.uint8 and rank.shape == (spec.num_levels, 500)
    inv = (1.0 / np.asarray(spec.scales)).astype(np.float32)
    for lv in range(spec.num_levels):
        _, _, want = pe_t._rank_and_el(xx.detach() * torch.tensor(inv[lv]))
        assert torch.equal(pe_t.unpack_rank(rank[lv]), want)
        _, _, want_j = pe_j._rank_and_el(jnp.asarray(x) * inv[lv])
        assert np.array_equal(want.numpy(), np.asarray(want_j))
    assert torch.equal(pe_t.pack_rank(pe_t.unpack_rank(rank)), rank)
    dbary = torch.from_numpy(np.random.default_rng(9).normal(
        size=(spec.num_levels, 4, 500)).astype(np.float32))
    recomputed = pe_t.pack_rank(torch.stack([
        pe_t._rank_and_el(xx.detach() * torch.tensor(s))[2] for s in inv]))
    assert torch.equal(pe_t._lattice_levels_dx(xx.detach(), inv, dbary, rank),
                       pe_t._lattice_levels_dx(xx.detach(), inv, dbary, recomputed))


# ------------------------------------------------- the dual encode's packed copy
def _packed_case():
    g = torch.Generator().manual_seed(11)
    a = torch.randn((3, 64, 2), generator=g).requires_grad_()
    b = torch.randn((3, 64, 2), generator=g).requires_grad_()
    return a, b


def _change(how, a, b):
    """Change table a or b in place as a path does, or hand in a new one."""
    if how == "add_a":
        with torch.no_grad():
            a.add_(0.5)                     # the optimizer's update
    elif how == "add_b":
        with torch.no_grad():
            b.add_(-0.25)
    elif how == "copy_b":
        with torch.no_grad():
            b.copy_(torch.ones_like(b))     # a checkpoint's restore
    elif how == "optimizer_a":
        a.grad = torch.ones_like(a)
        torch.optim.SGD([a], lr=0.1).step()
    elif how == "new_b":
        b = b.detach().clone() * 3          # same shape and dtype, another tensor
    return a, b


def test_packed_tables_kept_while_the_tables_are_unchanged():
    a, b = _packed_case()
    first = pe_t.packed_tables(a, b)
    assert torch.equal(first, torch.cat((a, b), dim=2)) and not first.requires_grad
    assert pe_t.packed_tables(a, b) is first
    with torch.no_grad():
        _ = a * 2                           # reads do not rebuild
    assert pe_t.packed_tables(a, b) is first


@pytest.mark.parametrize("how", ["add_a", "add_b", "copy_b", "optimizer_a", "new_b"])
def test_packed_tables_rebuilt_after_a_change(how):
    a, b = _packed_case()
    first = pe_t.packed_tables(a, b)
    a, b = _change(how, a, b)
    again = pe_t.packed_tables(a, b)
    assert again is not first
    assert torch.equal(again, torch.cat((a.detach(), b.detach()), dim=2))
    assert pe_t.packed_tables(a, b) is again
    # one copy at most: the first is no longer held
    assert table_pack._packed_copy[2] is again


def test_packed_tables_rebuilt_for_a_new_tensor_at_a_freed_address():
    """A table freed and another allocated in its place (the same address,
    version 0, as a bfloat16 cast per call may be) is not taken for the
    first: the copy holds only weak references, checked by identity."""
    a, b = _packed_case()
    b16 = b.detach().to(torch.bfloat16)
    a16 = a.detach().to(torch.bfloat16)
    first = pe_t.packed_tables(a16, b16).clone()
    del a16
    a16 = (a.detach() * 2).to(torch.bfloat16)
    got = pe_t.packed_tables(a16, b16)
    assert torch.equal(got, torch.cat((a16, b16), dim=2))
    assert not torch.equal(got, first)
    assert table_pack._packed_copy[0][0]() is a16
