"""The bf16 table-read path (``PAGNERF_BF16_GATHER=1``): float32 tables read
as rows rounded to bfloat16, float32 weights, sums and outputs, dbary from
the same rounded rows, float32 table gradients.

On the CPU, with the variable set for both packages (the JAX package reads
it at each gather, ``pagnerf_tpu/ops/table_gather.py:52-62``):

- the port's single and dual permutohedral encodes (``fused_encode``,
  ``fused_encode_dual``) and the V = 8 hash encodes against the JAX
  package's, forward and gradients (``jax.grad``), at the float32
  tolerances of ``tests/test_torch_encode.py`` and
  ``tests/test_torch_hash.py``: both round the same rows, so this is not
  the 2e-2 of bf16 against float32; the switch is live in both (the
  outputs move from the float32 read's by more than the tolerance), the
  outputs and every gradient float32;
- the plain versions (``bf16_rows=True``) equal the float32 plain versions
  on the tables rounded with ``.to(torch.bfloat16).to(torch.float32)``, bit
  for bit, gradients (dbary) included; the wrappers read the variable at
  each call; tables in bfloat16 already read as they are;
- ``table_pack``'s bfloat16 copies: kept while the table is unchanged,
  rebuilt after a change, one of each kind;
- the fused step keys its graph on the switch.

Marked ``cuda`` (they skip without a card; on the card run them with
``python -m pytest tests/test_torch_bf16_gather.py -q --noconftest -m
cuda``, this file imports JAX only inside the CPU tests): every kernel of
the bf16 read -- the gathers at V = 4 and 8, single and dual on packed
bfloat16 rows, the single and dual encode, dbary at V = 4 and 8 -- against
its plain version on the card, at ``tests/test_torch_cuda.py``'s float32
bounds, with its launch counted.
"""
import numpy as np
import pytest
import torch

from pagnerf_tpu_torch.ops import hash_encoding as he_t
from pagnerf_tpu_torch.ops import permuto_encoding as pe_t
from pagnerf_tpu_torch.ops import table_gather as tg_t
from pagnerf_tpu_torch.ops import table_pack

torch.set_num_threads(1)
ENV = "PAGNERF_BF16_GATHER"


def _round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _permuto_inputs(seed, n=2000):
    from pagnerf_tpu.ops import permuto_encoding as pe_j
    spec = pe_j.PermutoEncodingSpec(6, 2, 14, 1.0, 1e-3)     # direct and hashed levels
    rng = np.random.default_rng(seed)
    ta = rng.uniform(-1, 1, (6, spec.capacity, 2)).astype(np.float32)
    tb = rng.uniform(-1, 1, (6, spec.capacity, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    ga = rng.normal(size=(6 * 2, n)).astype(np.float32)
    gb = rng.normal(size=(6 * 2, n)).astype(np.float32)
    return spec, ta, tb, x, ga, gb


def _t(*arrays, grad=False):
    return tuple(torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_permuto_encode_bf16_read_matches_jax(dual, monkeypatch):
    import jax
    import jax.numpy as jnp
    from pagnerf_tpu.ops import permuto_encoding as pe_j
    spec, ta, tb, x, ga, gb = _permuto_inputs(1)

    def loss_j(a, b, xx):
        if not dual:
            return jnp.sum(pe_j.permuto_encode_T(a, xx, spec.scales) * ga)
        fa, fb = pe_j.permuto_encode_dual_T(a, b, xx, spec.scales)
        return jnp.sum(fa * ga) + jnp.sum(fb * gb)

    def run_t():
        a, b, xx = _t(ta, tb, x, grad=True)
        if dual:
            oa, ob = pe_t.fused_encode_dual(a, b, xx, spec.scales)
            outs = (oa, ob)
            ((oa.reshape(12, -1) * torch.from_numpy(ga)).sum()
             + (ob.reshape(12, -1) * torch.from_numpy(gb)).sum()).backward()
        else:
            outs = (pe_t.fused_encode(a, xx, spec.scales),)
            (outs[0].reshape(12, -1) * torch.from_numpy(ga)).sum().backward()
        return [o.detach() for o in outs], (a.grad, b.grad, xx.grad)

    def run_j():
        return ((pe_j.permuto_encode_T(args[0], args[2], spec.scales),) if not dual else
                pe_j.permuto_encode_dual_T(args[0], args[1], args[2], spec.scales))

    args = (jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(x))
    want32 = run_j()
    outs32, _ = run_t()
    monkeypatch.setenv(ENV, "1")
    da_j, db_j, dx_j = jax.grad(loss_j, argnums=(0, 1, 2))(*args)
    want = run_j()
    outs, (da, db, dx) = run_t()
    # the switch is live in both packages
    assert float(np.abs(np.asarray(want[0]) - np.asarray(want32[0])).max()) > 1e-4
    assert float((outs[0] - outs32[0]).abs().max()) > 1e-4
    for got, ref in zip(outs, want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.reshape(12, -1).numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-6)
    assert da.dtype == torch.float32 and dx.dtype == torch.float32
    np.testing.assert_allclose(da.numpy(), np.asarray(da_j), rtol=1e-5, atol=1e-5)
    if dual:
        assert db.dtype == torch.float32
        np.testing.assert_allclose(db.numpy(), np.asarray(db_j), rtol=1e-5, atol=1e-5)
    else:
        assert db is None
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(dx_j)).max()))


def test_hash_encode_bf16_read_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp
    from pagnerf_tpu.ops import hash_encoding as he_j
    res = he_j.geometric_resolutions(16, 512, 4)
    rng = np.random.default_rng(5)
    ta = rng.uniform(-1, 1, (4, 256, 2)).astype(np.float32)
    tb = rng.uniform(-1, 1, (4, 256, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (3, 2000)).astype(np.float32)
    w = rng.normal(size=(4 * 2, x.shape[1])).astype(np.float32)

    def close(got, want, what):
        atol = 1e-6 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=what)

    def loss_dual(a, b, xx):
        fa, fb = he_j.hash_encode_dual_T(a, b, xx, res)
        return jnp.sum(fa * w) + jnp.sum(fb * w[::-1])

    def loss_single(a, xx):
        return jnp.sum(he_j.hash_encode_T(a, xx, res) * w)

    args = (jnp.asarray(ta), jnp.asarray(tb), jnp.asarray(x))
    f32 = he_t.hash_encode_T(*_t(ta, x), res)
    want32 = np.asarray(he_j.hash_encode_T(args[0], args[2], res))
    monkeypatch.setenv(ENV, "1")
    want = np.asarray(he_j.hash_encode_T(args[0], args[2], res))
    got = he_t.hash_encode_T(*_t(ta, x), res)
    assert got.dtype == torch.float32
    assert float((got - f32).abs().max()) > 1e-4
    assert float(np.abs(want - want32).max()) > 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    dta, dtb, dx = jax.grad(loss_dual, argnums=(0, 1, 2))(*args)
    a, b, xx = _t(ta, tb, x, grad=True)
    fa, fb = he_t.hash_encode_dual_T(a, b, xx, res)
    (torch.sum(fa * torch.from_numpy(w)) + torch.sum(fb * torch.from_numpy(w[::-1].copy()))
     ).backward()
    for g in (a.grad, b.grad, xx.grad):
        assert g.dtype == torch.float32
    close(a.grad.numpy(), np.asarray(dta), "tables A")
    close(b.grad.numpy(), np.asarray(dtb), "tables B")
    close(xx.grad.numpy(), np.asarray(dx), "coordinates (A side only)")

    dt_j, dx_j = jax.grad(loss_single, argnums=(0, 1))(args[0], args[2])
    a, xx = _t(ta, x, grad=True)
    torch.sum(he_t.hash_encode_T(a, xx, res) * torch.from_numpy(w)).backward()
    close(a.grad.numpy(), np.asarray(dt_j), "tables")
    close(xx.grad.numpy(), np.asarray(dx_j), "coordinates")


def _gather_case(seed, v, n=999, l=3, c=1 << 10, f=2):
    rng = np.random.default_rng(seed)
    ta = rng.uniform(-1, 1, (l, c, f)).astype(np.float32)
    tb = rng.uniform(-1, 1, (l, c, f)).astype(np.float32)
    idx = rng.integers(0, c, (l, v, n)).astype(np.int32)
    bary = rng.uniform(0, 1, (l, v, n)).astype(np.float32)
    g = rng.normal(size=(l, f, n)).astype(np.float32)
    return ta, tb, idx, bary, g


@pytest.mark.parametrize("v", [4, 8])
def test_plain_versions_are_the_float32_ones_on_rounded_rows(v):
    ta, tb, idx, bary, g = _gather_case(2, v)
    ra, rb = _round(ta), _round(tb)
    a, b, i, w, gg = _t(ta, tb, idx, bary, g)
    a32, b32 = _t(ra, rb)
    assert torch.equal(tg_t.multilevel_gather_plain(a, i, w, bf16_rows=True),
                       tg_t.multilevel_gather_plain(a32, i, w))
    for got, want in zip(tg_t.dual_gather_plain(a, b, i, w, bf16_rows=True),
                         tg_t.dual_gather_plain(a32, b32, i, w)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    packed = torch.cat((a, b), dim=2)
    for got, want in zip(tg_t.dual_gather_packed_plain(packed, i, w, bf16_rows=True),
                         tg_t.dual_gather_plain(a32, b32, i, w)):
        assert torch.equal(got, want)
    assert torch.equal(tg_t.gather_dbary_plain(a, i, gg, bf16_rows=True),
                       tg_t.gather_dbary_plain(a32, i, gg))
    # the dbary wrapper takes the bf16 read's rows as they are
    assert torch.equal(tg_t.multilevel_gather_dbary(a.to(torch.bfloat16), i, gg),
                       tg_t.gather_dbary_plain(a32, i, gg))


@pytest.mark.parametrize("v", [4, 8])
def test_wrappers_read_the_switch_at_each_call(v, monkeypatch):
    ta, tb, idx, bary, g = _gather_case(3, v)
    a, b, i, w, gg = _t(ta, tb, idx, bary, g)
    a32, b32 = _t(_round(ta), _round(tb))
    monkeypatch.delenv(ENV, raising=False)
    assert torch.equal(tg_t.multilevel_table_gather(a, i, w),
                       tg_t.multilevel_gather_plain(a, i, w))
    monkeypatch.setenv(ENV, "1")
    assert torch.equal(tg_t.multilevel_table_gather(a, i, w),
                       tg_t.multilevel_gather_plain(a32, i, w))
    for got, want in zip(tg_t.dual_multilevel_table_gather(a, b, i, w),
                         tg_t.dual_gather_plain(a32, b32, i, w)):
        assert torch.equal(got, want)
    # gradients: the tables' float32 and unchanged, dbary from the rounded rows
    a, b, w = (t.detach().requires_grad_() for t in (a, b, w))
    oa, ob = tg_t.dual_multilevel_table_gather(a, b, i, w)
    (torch.sum(oa * gg) + torch.sum(ob * gg * 2)).backward()
    assert a.grad.dtype == torch.float32 and b.grad.dtype == torch.float32
    assert torch.equal(a.grad, tg_t.table_grad_plain(i, w.detach(), gg, a.shape[1]))
    assert torch.equal(w.grad, tg_t.gather_dbary_plain(a32, i, gg))
    monkeypatch.setenv(ENV, "0")
    assert torch.equal(tg_t.multilevel_table_gather(a.detach(), i, w.detach()),
                       tg_t.multilevel_gather_plain(a.detach(), i, w.detach()))


def test_bf16_tables_and_encodes_read_as_they_are(monkeypatch):
    """Tables in bfloat16 (``compute_dtype``) are not rounded again; the
    encodes' plain versions take ``bf16_rows`` as the gathers do."""
    spec, ta, tb, x, _, _ = _permuto_inputs(4, n=500)
    a, b, xx = _t(ta, tb, x)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    want16 = pe_t.fused_encode(a16, xx, spec.scales)
    monkeypatch.setenv(ENV, "1")
    assert torch.equal(pe_t.fused_encode(a16, xx, spec.scales), want16)
    assert want16.dtype == torch.bfloat16
    got = pe_t.fused_encode(a, xx, spec.scales)
    assert torch.equal(got, pe_t.encode_plain(a, xx, spec.scales, bf16_rows=True))
    assert torch.equal(got, pe_t.encode_plain(a16.float(), xx, spec.scales))
    for g_, w_ in zip(pe_t.fused_encode_dual(a, b, xx, spec.scales),
                      pe_t.dual_encode_plain(a16.float(), b16.float(), xx, spec.scales)):
        assert torch.equal(g_, w_)


def test_bf16_copies_kept_while_the_table_is_unchanged():
    ta, tb, _, _, _ = _gather_case(6, 4)
    a, b = _t(ta, tb)
    first = table_pack.rows_as(a, torch.bfloat16)
    assert first.dtype == torch.bfloat16 and torch.equal(first, a.to(torch.bfloat16))
    assert table_pack.rows_as(a, torch.bfloat16) is first
    with torch.no_grad():
        a.add_(1.0)
    again = table_pack.rows_as(a, torch.bfloat16)
    assert again is not first and torch.equal(again, a.to(torch.bfloat16))
    assert table_pack._rows_copy[2] is again
    packed = table_pack.packed_tables(a, b, torch.bfloat16)
    assert packed.dtype == torch.bfloat16
    assert torch.equal(packed, torch.cat((a, b), dim=2).to(torch.bfloat16))
    assert table_pack.packed_tables(a, b, torch.bfloat16) is packed
    # one packed copy at a time: the float32 one replaces it
    p32 = table_pack.packed_tables(a, b)
    assert p32.dtype == torch.float32 and table_pack._packed_copy[2] is p32


def test_fused_step_keys_its_graph_on_the_switch(monkeypatch):
    from pagnerf_tpu_torch import entry
    from pagnerf_tpu_torch.train.trainer import PanopticTrainer, TrainerConfig
    pipe, ds = entry.flagship(tiny=True, device="cpu", compute_dtype=torch.float32)
    cfg = TrainerConfig(batch_size=1, num_rays_sampled_per_img=16, sem_epoch_start=100,
                        inst_epoch_start=100, prune_every=-1, optimize_val_extrinsics=False,
                        voxel_raymarch_epoch_start=1000)
    t = PanopticTrainer(pipe.requires_grad_(True), ds, cfg, occ_level=4)
    stage = t.stage_for_epoch(0)
    batch = ds.sample_batch(np.random.default_rng(0), 1, 16)
    monkeypatch.delenv(ENV, raising=False)
    t.fused_train_step(stage, batch)
    monkeypatch.setenv(ENV, "1")
    t.fused_train_step(stage, batch)
    t.fused_train_step(stage, batch)
    assert len(t._fused) == 2
    assert sorted(k[-1] for k in t._fused) == [False, True]
    assert [e["steps"] for e in t.fused_log] == [1, 2]


# ------------------------------------------------------------------ card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bound(tables, v):
    """``tests/test_torch_cuda.py``'s float32 gather bound: 8 ulp of the
    largest table entry, doubled at V = 8."""
    return (v // 4) * 8 * 2.0 ** -23 * max(float(t.abs().max()) for t in tables)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [4, 8])
@pytest.mark.parametrize("f", [1, 2, 4])
def test_bf16_read_gathers_and_dbary_match_plain_on_the_card(dev, v, f, monkeypatch):
    ta, tb, idx, bary, g = _gather_case(7 + f, v, n=4097, l=5, c=1 << 12, f=f)
    a, b, i, w, gg = (t.to(dev) for t in _t(ta, tb, idx, bary, g))
    monkeypatch.setenv(ENV, "1")
    tol = _bound((a, b), v)
    before = (tg_t.multilevel_table_gather.launches, tg_t.dual_multilevel_table_gather.launches,
              tg_t.multilevel_gather_dbary.launches)
    out = tg_t.multilevel_table_gather(a, i, w)
    oa, ob = tg_t.dual_multilevel_table_gather(a, b, i, w)
    db = tg_t.multilevel_gather_dbary(table_pack.rows_as(a, torch.bfloat16), i, gg)
    torch.cuda.synchronize()
    assert (tg_t.multilevel_table_gather.launches, tg_t.dual_multilevel_table_gather.launches,
            tg_t.multilevel_gather_dbary.launches) == tuple(x + 1 for x in before)
    assert out.dtype == oa.dtype == ob.dtype == torch.float32
    assert torch.equal(out, oa)
    want_a, want_b = tg_t.dual_gather_plain(a, b, i, w, bf16_rows=True)
    for got, want in ((out, want_a), (oa, want_a), (ob, want_b)):
        assert float((got - want).abs().max()) <= tol
    want_db = tg_t.gather_dbary_plain(a, i, gg, bf16_rows=True)
    mag = torch.sum(gg.abs().permute(0, 2, 1)[:, None] * tg_t._gather_rows(
        a.to(torch.bfloat16), i).abs(), dim=-1)
    assert bool(((db - want_db).abs() <= 4 * 2.0 ** -23 * mag + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_bf16_read_encode_matches_plain_on_the_card(dev, dual, monkeypatch):
    spec = pe_t.PermutoEncodingSpec(8, 2, 14, 1.0, 1e-3)
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.rand((8, spec.capacity, 2), generator=gen, device=dev) * 2 - 1
    b = torch.rand((8, spec.capacity, 2), generator=gen, device=dev) * 2 - 1
    x = torch.rand((3, 100000), generator=gen, device=dev) * 2 - 1
    monkeypatch.setenv(ENV, "1")
    if dual:
        before = pe_t.fused_encode_dual.launches
        outs = pe_t.fused_encode_dual(a, b, x, spec.scales)
        want = pe_t.dual_encode_plain(a, b, x, spec.scales, bf16_rows=True)
        assert pe_t.fused_encode_dual.launches == before + 1
    else:
        before = pe_t.fused_encode.launches
        outs = (pe_t.fused_encode(a, x, spec.scales),)
        want = (pe_t.encode_plain(a, x, spec.scales, bf16_rows=True),)
        assert pe_t.fused_encode.launches == before + 1
    st = pe_t.level_statics(spec.scales, spec.capacity, 2)
    el = max(float((torch.as_tensor(pe_t._E, dtype=torch.float32, device=dev) @ (
        x * float(s))).abs().max()) for s in st.inv_scales)
    tol = (4 * el * 2.0 ** -23 + 8 * 2.0 ** -23) * 1.0
    for got, ref in zip(outs, want):
        assert got.dtype == torch.float32
        # a point within an ulp of a simplex boundary may take the other simplex
        bad = ((got - ref).abs() > tol).float().mean()
        assert float(bad) <= 1e-5
