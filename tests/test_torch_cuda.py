"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these tests build ``ops/csrc/permuto_encode.cu``,
``ops/csrc/permuto_gather.cu`` and ``ops/csrc/permuto_scatter.cu`` with nvcc
and launch them, so on a host without a card they skip. Run them on the card
with ``python -m pytest tests/test_torch_cuda.py -q --noconftest``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).

Tolerance of the gathers: float32, 8 ulp of the largest table entry (fused vs
separate multiply-adds over 4 vertices); bfloat16, that plus one bf16 ulp of
the largest output (the float32 sums may round to neighbouring bf16 values).
The table-gradient scatter sums float32 products per level either in float64
(shared-memory rows, then float64 atomics) or with float32 atomics on rows of
at most 120 addends (rows beyond are summed again in float64), in an order
that changes from run to run; each entry is held within 64 * eps_f32 of its
sum of |bary * g| to the plain version's float64 sum, with random,
same-signed and run-pattern cotangents, under every per-level mode. The row
scatter-add sums in float64 and rounds once: each entry within 64 * eps_f32
of its sum of |vals|. dbary: each entry within 4 * eps_f32 of its sum over F
of |g * T| (a fused multiply-add chain against separate products). The
fused encode against the plain lattice and gathers: idx equal on all but
1e-6 of the entries (at least one allowed), features per level within
(4 ulp_f32(max|el|) + 8 eps_f32) max|table| (one ulp of el moves each weight
by at most ulp/4), plus one bf16 ulp of the largest output in bfloat16; the
single encode bit-equal to the dual's A side.

At V = 8 (the hash grid's voxel corners) the same contracts hold, the
gathers' bound doubled for their 8 multiply-adds, at small shapes, at the
hash path's N = 2^20 with 14 levels of 2^19 rows, and through
``hash_encode_dual_T`` with gradients against the plain versions on the
card (table gradients and coordinate gradients within 1e-5 of their largest
entry). The scatter's window mode (each thread's run of consecutive samples
merged in registers, equal rows in any vertex slot) holds the scatter's
contract on ray-ordered hash events (rays in random directions and along
+x, N odd or below a segment, F in 1, 2, 4) and on patterns at its bounds
(hot rows past their count, every event on one row, no row repeated, rows
continued in other slots), at V = 8 and 4, with live-row bounds; the V = 4
default plan keeps its contract beside window levels.

The dual gather reads one packed [L, C, 2F] row a vertex: bit-equal to two
single gathers, within the gathers' bound of the two-table plain version,
at V = 4 and 8, F = 1, 2, 4, both dtypes, and again after a table changed.
The assignment kernel (one warp per image) gives its plain version's
columns exactly on ``chip_smoke.py``'s cases, on small-integer ties across
its 32-column chunks and under every launch plan (images a block, staged
or not, columns in registers or shared memory), and scipy's optimal cost
on the uncut 200 x 200 cases."""
import contextlib

import numpy as np
import pytest
import torch

from pagnerf_tpu_torch.ops import permuto_encoding as pe
from pagnerf_tpu_torch.ops import scatter_rows as sr
from pagnerf_tpu_torch.ops import table_gather as tg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, l, c, f, n, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    ta = torch.randn((l, c, f), generator=g, device=dev).to(dtype)
    tb = torch.randn((l, c, f), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, c, (l, 4, n), generator=g, device=dev, dtype=torch.int32)
    bary = torch.rand((l, 4, n), generator=g, device=dev).to(dtype)
    return ta, tb, idx, bary


def _tol(tables, out, dtype):
    tmax = max(float(t.float().abs().max()) for t in tables)
    tol = 8 * 2.0 ** -23 * tmax
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * float(out.float().abs().max())
    return tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 255, 4097])
def test_kernel_matches_plain(dev, dtype, f, n):
    ta, tb, idx, bary = _inputs(dev, 5, 1 << 12, f, n, dtype)
    s0, d0 = tg.multilevel_table_gather.launches, tg.dual_multilevel_table_gather.launches
    out = tg.multilevel_table_gather(ta, idx, bary)
    oa, ob = tg.dual_multilevel_table_gather(ta, tb, idx, bary)
    torch.cuda.synchronize()
    assert tg.multilevel_table_gather.launches == s0 + 1
    assert tg.dual_multilevel_table_gather.launches == d0 + 1
    ref = tg.multilevel_gather_plain(ta, idx, bary)
    ref_b = tg.multilevel_gather_plain(tb, idx, bary)
    assert out.dtype == dtype and out.shape == (5, f, n)
    for got, want in ((out, ref), (oa, ref), (ob, ref_b)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= _tol((ta, tb), want, dtype)
    assert torch.equal(oa, out)
    assert torch.equal(ob, tg.multilevel_table_gather(tb, idx, bary))


def test_kernel_rejects_mixed_devices(dev):
    ta, _, idx, bary = _inputs(dev, 2, 256, 2, 64, torch.float32)
    with pytest.raises(ValueError):
        tg.multilevel_table_gather(ta.cpu(), idx, bary)


def test_tiny_render_on_card_matches_cpu(dev):
    from pagnerf_tpu_torch.entry import entry
    outs = []
    for d in (dev, torch.device("cpu")):
        fn, args = entry(device=d, tiny=True, compute_dtype=torch.float32)
        outs.append([o.cpu() for o in fn(*args)])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


F32_EPS = 2.0 ** -23


def _grad_inputs(dev, l, c, f, n, seed=1, runs=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    if runs:      # coarse-level pattern: long runs of equal indices along N
        base = (torch.arange(n, device=dev) // 37) % 5
        idx = (base[None, None, :] + torch.arange(4, device=dev)[None, :, None]
               ).expand(l, 4, n).to(torch.int32).contiguous()
    else:
        idx = torch.randint(0, c, (l, 4, n), generator=g, device=dev, dtype=torch.int32)
    bary = torch.rand((l, 4, n), generator=g, device=dev)
    g_a = torch.randn((l, f, n), generator=g, device=dev)
    g_b = torch.randn((l, f, n), generator=g, device=dev)
    g_a[:, :, ::3] = 0.0                  # masked samples carry zero cotangents
    return idx, bary, g_a, g_b


def _assert_scatter_close(got, idx, bary, g, c, rows_used=None):
    want = tg.table_grad_plain(idx, bary, g, c, rows_used)
    mag = tg.table_grad_plain(idx, bary.abs(), g.abs(), c, rows_used)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 64 * F32_EPS * mag).all())


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 255, 4097])
@pytest.mark.parametrize("runs", [False, True], ids=["random", "runs"])
def test_table_grad_kernels_match_plain(dev, f, n, runs):
    l, c = 3, 1 << 12
    idx, bary, g_a, g_b = _grad_inputs(dev, l, c, f, n, runs=runs)
    s0 = tg.multilevel_table_grad.launches
    d0 = tg.dual_multilevel_table_grad.launches
    single = tg.multilevel_table_grad(idx, bary, g_a, c)
    da, db = tg.dual_multilevel_table_grad(idx, bary, g_a, g_b, c)
    torch.cuda.synchronize()
    assert tg.multilevel_table_grad.launches == s0 + 1
    assert tg.dual_multilevel_table_grad.launches == d0 + 1
    _assert_scatter_close(single, idx, bary, g_a, c)
    _assert_scatter_close(da, idx, bary, g_a, c)
    _assert_scatter_close(db, idx, bary, g_b, c)


@pytest.mark.parametrize("modes", ["shared", "float", "global", "mixed"])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("pattern", ["random", "runs", "hot"])
def test_table_grad_modes_match_plain_same_signed(dev, modes, f, pattern):
    """Every per-level accumulation on same-signed cotangents: "hot" sends
    ~1e5 events to a few rows (the FLOAT rows overflow 120 addends and are
    redone in float64), "random" over 4096 rows overfills a block's hash
    table (events go straight to the float64 accumulator), with and without
    live-row bounds."""
    l, c, n = 4, 1 << 12, 1 << 15
    idx, bary, g_a, g_b = _grad_inputs(dev, l, c, f, n, seed=5, runs=pattern == "runs")
    if pattern == "hot":
        idx = (idx % 7).contiguous()
    g_a, g_b = g_a.abs(), g_b.abs()
    rows_used = (64, 0, 4096, 0)
    if pattern != "hot":
        idx[0] %= 64
    mode = {"shared": (tg.SHARED,) * l, "float": (tg.FLOAT,) * l,
            "global": (tg.GLOBAL,) * l,
            "mixed": (tg.SHARED, tg.FLOAT, tg.GLOBAL, tg.SHARED)}[modes]
    (single,) = tg._launch_grad(idx, bary, (g_a,), c, rows_used, mode)
    da, db = tg._launch_grad(idx, bary, (g_a, g_b), c, rows_used, mode)
    torch.cuda.synchronize()
    _assert_scatter_close(single, idx, bary, g_a, c, rows_used)
    _assert_scatter_close(da, idx, bary, g_a, c, rows_used)
    _assert_scatter_close(db, idx, bary, g_b, c, rows_used)


def test_table_grad_rows_used_drops_events_beyond(dev):
    l, c, f, n = 2, 1 << 10, 2, 5000
    idx, bary, g_a, g_b = _grad_inputs(dev, l, c, f, n, seed=6)
    got = tg.multilevel_table_grad(idx, bary, g_a, c, rows_used=(100, 0))
    torch.cuda.synchronize()
    _assert_scatter_close(got, idx, bary, g_a, c, (100, 0))
    assert bool((got[0, 100:] == 0).all())
    with pytest.raises(ValueError):
        tg.multilevel_table_grad(idx, bary, g_a, c, rows_used=(100,))


@pytest.mark.parametrize("num_rows", [1, 64, 200, 201, 640, 4096])
@pytest.mark.parametrize("order", ["random", "runs"])
def test_scatter_rows_kernel_matches_plain(dev, num_rows, order):
    gen = torch.Generator(device=dev).manual_seed(num_rows)
    m = 20000
    if order == "runs":
        row = (torch.arange(m, device=dev) // 97 % (num_rows + 3) - 1).to(torch.int32)
    else:
        row = torch.randint(-1, num_rows + 2, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
    vals = torch.randn((m, 128), generator=gen, device=dev).abs()
    n0 = sr.scatter_rows.launches
    got = sr.scatter_rows(row, vals, num_rows)
    torch.cuda.synchronize()
    assert sr.scatter_rows.launches == n0 + 1
    want = sr.scatter_rows_plain(row, vals, num_rows)
    mag = sr.scatter_rows_plain(row, vals.abs(), num_rows)
    assert got.shape == (num_rows, 128) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 64 * F32_EPS * mag).all())


def test_scatter_rows_kernel_zero_events_and_checks(dev):
    out = sr.scatter_rows(torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((0, 128), device=dev), 640)
    assert out.shape == (640, 128) and bool((out == 0).all())
    with pytest.raises(TypeError):
        sr.scatter_rows(torch.zeros((4,), dtype=torch.int64, device=dev),
                        torch.zeros((4, 128), device=dev), 8)


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 255, 4097])
def test_dbary_kernel_matches_plain(dev, f, n):
    l, c = 3, 1 << 12
    ta, _, _, _ = _inputs(dev, l, c, f, 1, torch.float32)
    idx, _, g_a, _ = _grad_inputs(dev, l, c, f, n)
    d0 = tg.multilevel_gather_dbary.launches
    got = tg.multilevel_gather_dbary(ta, idx, g_a)
    torch.cuda.synchronize()
    assert tg.multilevel_gather_dbary.launches == d0 + 1
    want = tg.gather_dbary_plain(ta, idx, g_a)
    mag = tg.gather_dbary_plain(ta.abs(), idx, g_a.abs())
    assert bool(((got - want).abs() <= 4 * F32_EPS * mag).all())


def test_autograd_on_card_launches_backward_kernels(dev):
    ta, tb, idx, bary = _inputs(dev, 3, 1 << 10, 2, 999, torch.float32)
    ta.requires_grad_(), tb.requires_grad_()
    tg.reset_launches()
    oa, ob = tg.dual_multilevel_table_gather(ta, tb, idx, bary)   # bary: no grad
    (oa.sum() + ob.sum()).backward()
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in tg.KERNELS.items()} == {
        "gather": 0, "dual_gather": 1, "table_grad": 0, "dual_table_grad": 1,
        "dbary": 0, "encode": 0, "dual_encode": 0}
    bary.requires_grad_()
    out = tg.multilevel_table_gather(ta, idx, bary)
    out.sum().backward()
    torch.cuda.synchronize()
    assert tg.multilevel_table_grad.launches == 1
    assert tg.multilevel_gather_dbary.launches == 1


def test_tiny_train_step_on_card_matches_cpu(dev):
    from pagnerf_tpu_torch.entry import flagship, train_config
    from pagnerf_tpu_torch.train.optimizer import OptimizerConfig
    from pagnerf_tpu_torch.train.trainer import PanopticTrainer
    cfg = train_config("panoptic", tiny=True)
    batch = None
    grads = []
    for d in (dev, torch.device("cpu")):
        pipe, ds = flagship(tiny=True, device=d, compute_dtype=torch.float32)
        pipe.requires_grad_(True)
        trainer = PanopticTrainer(pipe, ds, cfg, OptimizerConfig())
        if batch is None:
            batch = ds.sample_batch(np.random.default_rng(0), 6, cfg.num_rays_sampled_per_img)
            sub = {k: v[1:2] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == 2 else v
                   for k, v in batch.items()}
            jitter = torch.rand((cfg.num_rays_sampled_per_img, pipe.tracer_cfg.num_steps),
                                generator=torch.Generator().manual_seed(0))
        g, _ = trainer.grad_step(trainer.stage_for_epoch(2), sub, jitter.to(d))
        grads.append({k: v.cpu() for k, v in g.items()})
    for name, want in grads[1].items():
        atol = 1e-5 * max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(grads[0][name].numpy(), want.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=name)


# ------------------------------------------------------------ fused encode
def _encode_case(dev, f, n, dtype, levels=8, log2_c=12, finest=1e-4, seed=7):
    """Coordinates in [-1, 1]^3 with points on rounding and simplex-tie
    boundaries (grid-aligned coordinates, the origin) and random tables of
    a spec with direct and hashed levels."""
    spec = pe.PermutoEncodingSpec(levels, f, log2_c, 1.0, finest)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((3, n), generator=g, device=dev) * 2 - 1
    k = min(n, 64)
    x[:, :k] = torch.round(x[:, :k] * 8) / 8
    if n > k:
        x[:, k] = 0.0
    ta = torch.randn((levels, spec.capacity, f), generator=g, device=dev).to(dtype)
    tb = torch.randn((levels, spec.capacity, f), generator=g, device=dev).to(dtype)
    return spec, x.contiguous(), ta, tb


def _el_ulps(spec, x):
    """Per level, one float32 ulp of the largest |el| = |E @ (x / s_l)|."""
    e = torch.as_tensor(pe._E, dtype=torch.float32, device=x.device)
    inv = (1.0 / np.asarray(spec.scales)).astype(np.float32)
    out = []
    for lv in range(spec.num_levels):
        el_max = float((e @ (x * torch.tensor(inv[lv], device=x.device))).abs().max())
        out.append(2.0 ** (np.floor(np.log2(max(el_max, 2.0 ** -126))) - 23))
    return out


def _encode_tol(ulps, tables, ref, dtype):
    """Per level (chip_smoke.py's encode bound): one ulp of el moves each of
    the 4 weights by at most ulp/4, and the products and sums round in
    float32; bfloat16 outputs may then round one bf16 ulp apart."""
    tols = []
    for lv, ulp in enumerate(ulps):
        tmax = max(float(t[lv].float().abs().max()) for t in tables)
        tol = (4 * ulp + 8 * F32_EPS) * tmax
        if dtype == torch.bfloat16:
            tol += 2.0 ** -7 * float(ref[lv].float().abs().max())
        tols.append(tol)
    return tols


def _assert_encode_matches_plain(spec, x, ta, tb, dtype, same_el_order):
    """cuBLAS picks its kernel for the plain lattice's E @ s by N, and at
    some N (4096 to 65536 among those probed) rounds el in another order
    than the kernel, whose order is cuBLAS's at the main path's N. Where el
    rounds apart, a point on a rounding or simplex-tie boundary may take
    another vertex: a vertex may differ only where its weight is within one
    ulp of el of 0. Where the orders agree (``same_el_order``), idx is
    equal on all but 1e-6 of the entries."""
    st = pe.level_statics(spec.scales, spec.capacity, spec.feature_dim)
    (single,), idx, bary, rank = pe._launch_encode(x, (ta,), st, True, False)
    (oa, ob), idx_d, bary_d, rank_d = pe._launch_encode(x, (ta, tb), st, True, True)
    (oa2, ob2), none_i, none_b, none_r = pe._launch_encode(x, (ta, tb), st, False, False)
    torch.cuda.synchronize()
    assert none_i is None and none_b is None and none_r is None
    idx_p, bary_p = pe.lattice(ta, x, spec.scales)
    ulps = _el_ulps(spec, x)
    bad = idx != idx_p
    if same_el_order:
        assert int(bad.sum()) <= 1e-6 * idx.numel()
    for lv, ulp in enumerate(ulps):
        assert bool((bary_p[lv][bad[lv]].abs() <= ulp).all()), lv
    pa, pb = tg.dual_gather_plain(ta, tb, idx_p, bary_p.to(dtype))
    for got, want in ((oa, pa), (ob, pb)):
        assert got.dtype == dtype and got.shape == want.shape
        for lv, tol in enumerate(_encode_tol(ulps, (ta, tb), want, dtype)):
            assert float((got[lv].float() - want[lv].float()).abs().max()) <= tol, lv
    assert torch.equal(single, oa)
    assert torch.equal(oa, oa2) and torch.equal(ob, ob2)
    assert torch.equal(idx_d, idx) and torch.equal(bary_d, bary) and torch.equal(rank_d, rank)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 255, 4097])
def test_encode_kernel_matches_plain(dev, dtype, f, n):
    _assert_encode_matches_plain(*_encode_case(dev, f, n, dtype), dtype, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_kernel_matches_plain_flagship_2_21(dev, dtype):
    spec, x, ta, tb = _encode_case(dev, 2, 1 << 21, dtype, levels=24, log2_c=18)
    _assert_encode_matches_plain(spec, x, ta, tb, dtype, True)


def test_encode_gradients_match_plain_path(dev):
    """Through the Function, against the plain backward over the lattice
    the forward kept: table gradients within 64 eps_f32 of each entry's sum
    of |bary * g| of the plain float64 scatter; the coordinate gradient
    within 1e-5 of its largest entry of the plain dbary -> dx."""
    spec, x, ta, tb = _encode_case(dev, 2, 20000, torch.float32)
    g = torch.Generator(device=dev).manual_seed(3)
    g_a = torch.randn((spec.num_levels, 2, x.shape[1]), generator=g, device=dev)
    g_b = torch.randn((spec.num_levels, 2, x.shape[1]), generator=g, device=dev)
    a, b, xx = (t.clone().requires_grad_() for t in (ta, tb, x))
    tg.reset_launches()
    oa, ob = pe.fused_encode_dual(a, b, xx, spec.scales)
    _, idx, bary, _ = oa.grad_fn.saved_tensors       # the forward's lattice
    ((oa * g_a).sum() + (ob * g_b).sum()).backward()
    torch.cuda.synchronize()
    assert {k: tg.KERNELS[k].launches for k in ("dual_encode", "dual_table_grad", "dbary",
                                                  "dual_gather")} == {
        "dual_encode": 1, "dual_table_grad": 1, "dbary": 1, "dual_gather": 0}
    st = pe.level_statics(spec.scales, spec.capacity, 2)
    for got, gg in ((a.grad, g_a), (b.grad, g_b)):
        _assert_scatter_close(got, idx, bary, gg, spec.capacity, st.rows_used)
    dx = pe._lattice_levels_dx(x, st.inv_scales, tg.gather_dbary_plain(ta, idx, g_a),
                               oa.grad_fn.rank)
    assert float((xx.grad - dx).abs().max()) <= 1e-5 * float(dx.abs().max())


def test_encode_launches_and_lattice_outputs(dev):
    """Under no_grad the encode writes no idx/bary; with tables that need a
    gradient it keeps them; fixed coordinates (an anchor microbatch) skip
    dbary and the lattice backward."""
    spec, x, ta, _ = _encode_case(dev, 2, 999, torch.float32)
    t = ta.clone().requires_grad_()
    tg.reset_launches()
    with torch.no_grad():
        out = pe.fused_encode(t, x, spec.scales)
    assert out.grad_fn is None and pe.fused_encode.launches == 1
    out = pe.fused_encode(t, x, spec.scales)
    saved = out.grad_fn.saved_tensors
    assert saved[1].dtype == torch.int32 and saved[1].shape == (spec.num_levels, 4, 999)
    out.sum().backward()
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in tg.KERNELS.items()} == {
        "gather": 0, "dual_gather": 0, "table_grad": 1, "dual_table_grad": 0,
        "dbary": 0, "encode": 2, "dual_encode": 0}


# ------------------------------------------------- the post-prune slice
PACKED_B = 163840        # the post-prune microbatch: pack_steps 40 x 4096 rays


@pytest.mark.parametrize("n", [32768, 65536, 131072])
def test_encode_backward_on_the_forward_simplex(dev, n):
    """At N where cuBLAS rounds E @ s in another order than the encode
    kernel, the coordinate gradient is still formed on the rank the forward
    kernel kept: bit-equal (or within 1e-6 of the largest |dx|) to
    ``_lattice_levels_dx`` on the rank of ``elevate_as_kernel``."""
    from pagnerf_tpu_torch.profile_encode import backward_rank_check
    spec, x, ta, _ = _encode_case(dev, 2, n, torch.float32, levels=24, log2_c=18)
    g = torch.randn((24, 2, n), generator=torch.Generator(device=dev).manual_seed(n),
                    device=dev)
    r = backward_rank_check(ta, x, spec.scales, g)
    assert r["dx_bit_equal"] or r["dx_err_over_max"] <= 1e-6, r


def test_encode_backward_unchanged_at_the_flagship_n(dev):
    """At a training microbatch's N cuBLAS rounds el in the kernel's order:
    the kept rank is the recomputed one, so dx is what it was."""
    from pagnerf_tpu_torch.profile_encode import backward_rank_check
    from pagnerf_tpu_torch.profile_scatter import training_coords
    spec, x = training_coords(dev)
    ta = torch.randn((24, spec.capacity, 2), generator=torch.Generator(device=dev)
                     .manual_seed(0), device=dev)
    g = torch.randn((24, 2, x.shape[1]), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    r = backward_rank_check(ta, x, spec.scales, g)
    assert r["dx_bit_equal"] and r["rank_cublas_mismatches"] == 0, r
    assert r["dx_cublas_rank_err_over_max"] == 0.0, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_kernel_matches_plain_at_packed_b(dev, dtype):
    spec, x, ta, tb = _encode_case(dev, 2, PACKED_B, dtype, levels=24, log2_c=18)
    _assert_encode_matches_plain(spec, x, ta, tb, dtype, False)


TUNED_N = 4096 * 96      # the tuned config's dense microbatch and validation chunk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_kernel_matches_plain_at_the_tuned_n(dev, dtype):
    """N = 393,216, the tuned flagship config's (``cli``): cuBLAS's order of
    the plain lattice's E @ s at this N is not probed, so the boundary rule
    holds the vertices."""
    spec, x, ta, tb = _encode_case(dev, 2, TUNED_N, dtype, levels=24, log2_c=18,
                                   finest=0.04)
    _assert_encode_matches_plain(spec, x, ta, tb, dtype, False)


# best.yaml's validation chunks over a 320x180 BUP20-format tree
# (render_batch 8000 rays x 512 steps): a full chunk, an 80x45 image at
# val_mip 2 in one chunk, the last chunk of a 320x180 image at mip 0
BUP20_VALIDATION_N = (8000 * 512, 3600 * 512, 1600 * 512)


@pytest.mark.parametrize("n", BUP20_VALIDATION_N)
def test_encode_kernel_matches_plain_at_the_bup20_validation_n(dev, n):
    """The dual encode without idx/bary, as validation runs it, equals the
    one that keeps them, and both hold to the plain encode (boundary rule)
    at the N of best.yaml's validation chunks."""
    spec, x, ta, tb = _encode_case(dev, 2, n, torch.float32, levels=24, log2_c=18)
    _assert_encode_matches_plain(spec, x, ta, tb, torch.float32, False)


# ------------------------------------------ every layout, tail and level count
def _launch_into(x, tables, st, lattice, layout, offset):
    """The C entry with outputs (and idx/bary/rank) that start ``offset``
    elements into their buffers: (outs, idx, bary, rank)."""
    import ctypes
    l, c, f = tables[0].shape
    n = x.shape[1]

    def alloc(shape, dt):
        return torch.empty(int(np.prod(shape)) + offset, dtype=dt,
                           device=x.device)[offset:].view(shape)
    outs = [alloc((l, f, n), tables[0].dtype) for _ in (tables if layout == 1 else (0, 1))]
    idx = bary = rank = None
    if lattice:
        idx, bary = alloc((l, 4, n), torch.int32), alloc((l, 4, n), torch.float32)
        rank = alloc((l, n), torch.uint8)
    src = (pe.packed_tables(*tables),) if layout == 3 else tables
    as_c = lambda a, t: (t * len(a))(*a)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = pe._encode_kernel()(
        x.data_ptr(), src[0].data_ptr(), src[-1].data_ptr(), outs[0].data_ptr(),
        outs[-1].data_ptr(), ptr(idx), ptr(bary), ptr(rank),
        as_c(np.asarray(pe._E, dtype=np.float32).reshape(-1), ctypes.c_float),
        as_c(st.inv_scales, ctypes.c_float), as_c(st.mm, ctypes.c_int32),
        as_c(st.dm, ctypes.c_int32), as_c(st.direct.astype(np.int32), ctypes.c_int32),
        l, c, n, f, layout, tg._DTYPE_CODE[tables[0].dtype], tg._stream(x.device))
    assert err == 0
    return outs, idx, bary, rank


def _assert_every_layout_matches_plain(spec, x, ta, tb, dtype, offset=0):
    """Single, packed dual and dual with two loads, each without and with
    idx/bary, against the plain lattice and gathers (the boundary rule and
    per-level bounds of ``_assert_encode_matches_plain``); every run's
    outputs and lattice bit-equal to the others', the rank the one of
    ``elevate_as_kernel``'s el."""
    from pagnerf_tpu_torch.profile_encode import kernel_order_rank
    st = pe.level_statics(spec.scales, spec.capacity, spec.feature_dim)
    idx_p, bary_p = pe.lattice(ta, x, spec.scales)
    ulps = _el_ulps(spec, x)
    pa, pb = tg.dual_gather_plain(ta, tb, idx_p, bary_p.to(dtype))
    tols = _encode_tol(ulps, (ta, tb), torch.stack([pa, pb]).float().abs().amax(0), dtype)
    first = lat = None
    for layout, tables in ((1, (ta,)), (3, (ta, tb)), (2, (ta, tb))):
        for lattice in (False, True):
            outs, idx, bary, rank = _launch_into(x, tables, st, lattice, layout, offset)
            torch.cuda.synchronize()
            for got, want in zip(outs, (pa, pb)):
                assert got.dtype == dtype and got.shape == want.shape
                for lv, tol in enumerate(tols):
                    assert float((got[lv].float() - want[lv].float()).abs().max()) <= tol, lv
            first = outs[0] if first is None else first
            assert torch.equal(outs[0], first)
            if lattice:
                bad = idx != idx_p
                for lv, ulp in enumerate(ulps):
                    assert bool((bary_p[lv][bad[lv]].abs() <= ulp).all()), lv
                assert torch.equal(rank, kernel_order_rank(x, st.inv_scales))
                lat = lat or (idx, bary, rank)
                assert all(torch.equal(a, b) for a, b in zip(lat, (idx, bary, rank)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 3, 255, 4096, 4097, 4098, 4099, 65537])
def test_encode_every_layout_at_each_tail(dev, dtype, f, n):
    """N of every residue mod 4 and N below, at and above a block (256)."""
    _assert_every_layout_matches_plain(*_encode_case(dev, f, n, dtype), dtype)


@pytest.mark.parametrize("levels", [1, 24, 64])
def test_encode_every_layout_at_each_level_count(dev, levels):
    """One level (a group of one), an even count and the most the kernel
    takes: every level's blocks run once, in the kernel's level order."""
    spec, x, ta, tb = _encode_case(dev, 2, 4099, torch.float32, levels=levels, log2_c=14,
                                   finest=1e-4 if levels > 1 else 0.5)
    _assert_every_layout_matches_plain(spec, x, ta, tb, torch.float32)
    group, order = pe.encode_level_order(levels)
    assert group == 2 and sorted(order) == list(range(levels))


@pytest.mark.parametrize("levels", [5, 7])
def test_encode_odd_level_counts(dev, levels):
    """An odd count leaves the last group with one level."""
    spec, x, ta, tb = _encode_case(dev, 1, 3000, torch.float32, levels=levels)
    _assert_every_layout_matches_plain(spec, x, ta, tb, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_outputs_at_any_offset_bit_equal(dev, dtype):
    """Outputs that start one element into their buffers hold what outputs
    at the allocator's alignment hold, bit for bit."""
    spec, x, ta, tb = _encode_case(dev, 2, 8192, dtype, levels=24, log2_c=14)
    st = pe.level_statics(spec.scales, spec.capacity, 2)
    _assert_every_layout_matches_plain(spec, x, ta, tb, dtype, offset=1)
    for layout, tables in ((1, (ta,)), (3, (ta, tb)), (2, (ta, tb))):
        aligned = _launch_into(x, tables, st, True, layout, 0)
        shifted = _launch_into(x, tables, st, True, layout, 1)
        assert all(torch.equal(a, b) for a, b in zip(aligned[0], shifted[0]))
        assert all(torch.equal(a, b) for a, b in zip(aligned[1:], shifted[1:]))


# The direct level with the most reachable rows that 227 KB of shared memory
# would hold as 8-byte rows (4 Dm^3 <= 29,056: Dm = 19, scale 0.22 at C = 2^18),
# and a schedule without a direct level (C = 2^8 holds none)
FIT_SCHEDULES = {"largest_direct_level_that_would_fit": (2 ** 18, 1.0, 0.22),
                 "no_direct_level": (2 ** 8, 0.1, 1e-4)}


@pytest.mark.parametrize("schedule", list(FIT_SCHEDULES))
def test_encode_direct_level_schedules(dev, schedule):
    c, coarsest, finest = FIT_SCHEDULES[schedule]
    st = pe.level_statics(np.geomspace(coarsest, finest, 6), c, 2)
    if schedule == "no_direct_level":
        assert not st.direct.any()
    else:
        rows = [4 * int(d) ** 3 for d, dr in zip(st.dm, st.direct) if dr]
        assert max(rows) * 8 <= 232448 < 4 * (max(st.dm[st.direct]) + 2) ** 3 * 8
    spec = pe.PermutoEncodingSpec(6, 2, int(np.log2(c)), coarsest, finest)
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.rand((3, 20000), generator=g, device=dev) * 2 - 1).contiguous()
    ta, tb = (torch.randn((6, c, 2), generator=g, device=dev) for _ in range(2))
    _assert_every_layout_matches_plain(spec, x, ta, tb, torch.float32)


def test_encode_backward_on_the_forward_simplex_at_the_tuned_n(dev):
    from pagnerf_tpu_torch.profile_encode import backward_rank_check
    spec, x, ta, _ = _encode_case(dev, 2, TUNED_N, torch.float32, levels=24, log2_c=18,
                                  finest=0.04)
    g = torch.randn((24, 2, TUNED_N), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    r = backward_rank_check(ta, x, spec.scales, g)
    assert r["dx_bit_equal"] or r["dx_err_over_max"] <= 1e-6, r


def test_dual_scatter_matches_plain_at_packed_b(dev):
    spec, x, ta, tb = _encode_case(dev, 2, PACKED_B, torch.float32, levels=24, log2_c=18)
    st = pe.level_statics(spec.scales, spec.capacity, 2)
    _, idx, bary, _ = pe._launch_encode(x, (ta, tb), st, True, True)
    gen = torch.Generator(device=dev).manual_seed(2)
    g_a, g_b = (torch.randn((24, 2, PACKED_B), generator=gen, device=dev) for _ in range(2))
    for ga, gb in ((g_a, g_b), (g_a.abs(), g_b.abs())):
        da, db = tg.dual_multilevel_table_grad(idx, bary, ga, gb, spec.capacity,
                                               st.rows_used, st.modes)
        _assert_scatter_close(da, idx, bary, ga, spec.capacity, st.rows_used)
        _assert_scatter_close(db, idx, bary, gb, spec.capacity, st.rows_used)


def test_packed_trace_matches_dense_trace_on_card(dev):
    """The tiny flagship on the card (float32 decoders): the packed trace of
    a voxel march through an occupancy with empty space, with a budget that
    covers every valid sample, equals the dense trace under the same jitter
    (channels within 1e-5, gradients at rtol 1e-4 / atol 1e-6 of each
    tensor's largest entry, the pose gradient within 1e-3 of its largest)."""
    import dataclasses

    from pagnerf_tpu_torch.core.rays import Rays
    from pagnerf_tpu_torch.entry import flagship
    from pagnerf_tpu_torch.ops.occupancy import OccupancyGrid
    pipe, ds = flagship(tiny=True, device=dev, compute_dtype=torch.float32)
    pipe.requires_grad_(True)
    batch = ds.sample_batch(np.random.default_rng(2), 4, 48)
    m = int(np.nonzero(batch["cam_idx"] != 0)[0][0])
    base = Rays(origins=torch.from_numpy(batch["base_rays_origins"][m:m + 1]).to(dev),
                dirs=torch.from_numpy(batch["base_rays_dirs"][m:m + 1]).to(dev),
                dist_min=0.0, dist_max=6.0)
    cam = torch.from_numpy(batch["cam_idx"][m:m + 1]).long().to(dev)
    c = (torch.arange(8, device=dev) + 0.5) / 4 - 1
    gx, gy, gz = torch.meshgrid(c, c, c, indexing="ij")
    occ = OccupancyGrid(occupancy=torch.zeros(512, device=dev),
                        mask=((gx ** 2 + gy ** 2 + gz ** 2) < 0.5).reshape(-1), level=3)
    jitter = torch.rand((48, 16), generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    dense = dataclasses.replace(pipe.tracer_cfg, raymarch_type="voxel", num_steps=16)
    runs = []
    for cfg in (dense, dataclasses.replace(dense, pack_steps=16)):
        pipe.zero_grad(set_to_none=True)
        rb = pipe(base, frozenset({"rgb", "depth", "semantics", "inst_embedding"}), occ,
                  stage="train", cam_idx=cam, jitter=jitter, tracer_cfg=cfg)
        outs = [rb.rgb, rb.depth, rb.semantics, rb.inst_embedding, rb.alpha]
        sum(torch.sum(o ** 2) for o in outs).backward()
        runs.append(([o.detach() for o in outs],
                     {n: p.grad.clone() for n, p in pipe.named_parameters()
                      if p.grad is not None}))
    (out_d, g_d), (out_p, g_p) = runs
    for a, b in zip(out_p, out_d):
        assert float((a - b).abs().max()) <= 1e-5
    for name, want in g_d.items():
        if name == "extrinsics":
            assert float((g_p[name] - want).abs().max()) <= 1e-3 * float(want.abs().max())
            continue
        atol = 1e-6 * max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(g_p[name].cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=atol, err_msg=name)


def test_packed_backward_is_the_same_on_every_run(dev):
    """The packed layout's gradients at the post-prune B, from a march with
    empty rays (repeated segment boundaries), are bit-equal over repeats:
    its prefix sums and boundary differences add in a fixed order."""
    from pagnerf_tpu_torch.ops import packed as pk
    from pagnerf_tpu_torch.ops.raymarch import RaymarchResult
    r, s = 4096, 256

    def grads():
        gen = torch.Generator(device=dev).manual_seed(5)
        mask = torch.rand((r, s), generator=gen, device=dev) < 0.13
        mask[::7] = False
        t0 = torch.rand((r,), generator=gen, device=dev).requires_grad_()
        span = (1 + torch.rand((r,), generator=gen, device=dev)).requires_grad_()
        o, d = (torch.rand((3, r), generator=gen, device=dev).requires_grad_()
                for _ in range(2))
        u = (torch.arange(s, device=dev) + 0.5) / s
        depths = t0.detach()[:, None] + u * span.detach()[:, None]
        rm = RaymarchResult(positionsT=None, depths=depths, deltas=depths / s, mask=mask,
                            t0=t0, span=span)
        ps = pk.pack_samples(rm, o, d, PACKED_B)
        tau = torch.rand((PACKED_B,), generator=gen, device=dev) * ps.positionsT.sum(0).abs()
        w, alpha = pk.packed_integration_weights(tau, ps)
        comp = pk.packed_composite(torch.rand((5, PACKED_B), generator=gen, device=dev)
                                   * ps.depths[None], w, ps)
        loss = ((comp * torch.randn(comp.shape, generator=gen, device=dev)).sum()
                + (alpha * torch.randn(alpha.shape, generator=gen, device=dev)).sum())
        return [t.detach() for t in (w, alpha, comp)], torch.autograd.grad(loss, (t0, span, o, d))

    outs, ref = grads()
    for _ in range(10):
        o2, g2 = grads()
        assert all(torch.equal(a, b) for a, b in zip(o2, outs))
        assert all(torch.equal(a, b) for a, b in zip(g2, ref))


@pytest.mark.parametrize("when", ["pre_prune", "final"])
def test_validate_kernels_match_plain_encodes(dev, when):
    """The flagship's validation on the card through the fused encodes
    against the same validation with the plain encodes patched in: every
    rendered channel within the render phase's 1e-2 (depth: of its largest
    value), PSNR within 0.05 dB, the flipped argmax pixels of the semantic
    and gated instance maps counted (untrained bf16 decoders: near-equal
    logits may flip). 'pre_prune' is the schedule's first validation (mip 2,
    dense ray march, single encode), 'final' the one after a prune, a
    panoptic and a val-pose step (mip 0, voxel march, packed, dual encode,
    synthetic predictions). No validation encode writes idx/bary, though
    the parameters require grad."""
    import contextlib
    from unittest import mock

    from pagnerf_tpu_torch import entry
    from pagnerf_tpu_torch.data.synthetic import add_synthetic_predictions
    from pagnerf_tpu_torch.train.trainer import PanopticTrainer
    from pagnerf_tpu_torch.train.validation import validate

    trainer = entry.schedule_trainer(dev)
    cfg = trainer.cfg
    if when == "pre_prune":
        epoch = cfg.valid_every - 1
        trainer.epoch = epoch + 1
        chans = ("rgb", "depth")
    else:
        entry.run_past_prune(trainer, steps=1)
        trainer.dataset.data = add_synthetic_predictions(trainer.dataset.data)
        epoch = trainer.epoch = cfg.epochs
        chans = ("rgb", "depth", "semantics", "inst_embedding")
    render = PanopticTrainer.batch_render
    runs = []
    for plain in (False, True):
        seen = []

        def spy(self, *args, **kwargs):
            rb = render(self, *args, **kwargs)
            seen.append(rb)
            return rb
        tg.reset_launches()
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(PanopticTrainer, "batch_render", spy))
            if plain:
                stack.enter_context(mock.patch.object(pe, "fused_encode", pe.encode_plain))
                stack.enter_context(mock.patch.object(pe, "fused_encode_dual",
                                                      pe.dual_encode_plain))
            metrics = validate(trainer, epoch)
        torch.cuda.synchronize()
        if not plain:
            kernel = "encode" if when == "pre_prune" else "dual_encode"
            assert tg.KERNELS[kernel].launches == len(seen) == 4
            assert tg.KERNELS[kernel].launches_with_idx_bary == 0
        runs.append((metrics, seen))
    (m_k, rb_k), (m_p, rb_p) = runs
    d_max = max(float(rb.depth.abs().max()) for rb in rb_p)
    stuff = trainer.dataset.semantic_info["stuff_ids"]
    flips = 0
    for a, b in zip(rb_k, rb_p):
        for ch in chans:
            tol = 1e-2 * (d_max if ch == "depth" else 1.0)
            assert float((getattr(a, ch).float() - getattr(b, ch).float()).abs().max()) <= tol, ch
        if when == "final":      # counted, reported on a failure
            sem_a, sem_b = a.semantics.argmax(-1), b.semantics.argmax(-1)
            things = ~torch.isin(sem_b, torch.tensor(stuff, device=dev))
            flips += int((sem_a != sem_b).sum()) + int(
                (things & (a.inst_embedding[:, 1:].argmax(-1)
                           != b.inst_embedding[:, 1:].argmax(-1))).sum())
    assert abs(m_k["val/psnr"] - m_p["val/psnr"]) <= 0.05, (m_k, m_p, flips)
    assert sorted(m_k) == sorted(m_p)


def test_dd_nef_through_the_kernels_matches_plain(dev):
    """A ``PanopticDDensityNeF`` at the flagship's width on the card: every
    channel through the fused dual encode against the same NeF with the
    plain encodes patched in (1e-4 of each channel's largest value), one
    dual encode and, in the backward of the panoptic channels, one dual
    scatter; ``panoptic_density`` sends no gradient to the coordinates."""
    from unittest import mock

    from pagnerf_tpu_torch.models.nefs import GridConfig, PanopticDDensityNeF

    nef = PanopticDDensityNeF(grid=GridConfig(), num_classes=8, num_instances=200,
                              panoptic_features_type="delta")
    nef.reset_parameters(torch.Generator().manual_seed(0))
    nef = nef.to(dev).requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.rand((3, 65536), generator=g, device=dev) * 2 - 1).requires_grad_(True)
    d = torch.nn.functional.normalize(torch.randn((3, 65536), generator=g, device=dev), dim=0)
    chans = frozenset({"density", "rgb", "panoptic_density", "semantics", "inst_embedding"})
    tg.reset_launches()
    out = nef(x, d, chans)
    out["panoptic_density"].sum().backward()
    torch.cuda.synchronize()
    assert tg.KERNELS["dual_encode"].launches == 1
    assert tg.KERNELS["dual_table_grad"].launches == 1
    assert x.grad is None or not x.grad.any()
    with torch.no_grad(), mock.patch.object(pe, "fused_encode_dual", pe.dual_encode_plain):
        plain = nef(x, d, chans)
    for ch in chans:
        tol = 1e-4 * max(1.0, float(plain[ch].abs().max()))
        assert float((out[ch].detach() - plain[ch]).abs().max()) <= tol, ch


def test_sup_contrastive_on_card_matches_cpu(dev):
    """The contrastive loss of a full-width batch (6 images x 4096 rays x
    200 embedding dims, an image with every pixel masked) on the card
    against the CPU's, within 1e-4 relative; finite gradients."""
    from pagnerf_tpu_torch.losses.sup_contrastive import sup_contrastive_loss

    g = torch.Generator().manual_seed(2)
    feats = torch.randn((6, 4096, 200), generator=g)
    labels = torch.randint(0, 30, (6, 4096), generator=g)
    mask = torch.rand((6, 4096), generator=g) < 0.8
    mask[3] = False
    want = sup_contrastive_loss(feats, labels, mask)
    x = feats.to(dev).requires_grad_(True)
    got = sup_contrastive_loss(x, labels.to(dev), mask.to(dev))
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
    assert bool(torch.isfinite(x.grad).all()) and not x.grad[3].any()


# ------------------------------------------------------------ V = 8 (hash grid)
def _hash_case(dev, n, levels=14, log2_c=19, seed=0):
    """The hash grid's idx/bary at n random coordinates, random tables."""
    from pagnerf_tpu_torch.ops import hash_encoding as he
    spec = he.HashEncodingSpec(levels, 2, log2_c, 16, 512)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((3, n), generator=g, device=dev) * 2 - 1
    idx, w = he.hash_indices(x, spec.resolutions, log2_c)
    ta = torch.randn((levels, spec.capacity, 2), generator=g, device=dev)
    tb = torch.randn((levels, spec.capacity, 2), generator=g, device=dev)
    return spec, x, idx.contiguous(), w.contiguous(), ta, tb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 255, 4097])
def test_v8_gather_kernels_match_plain(dev, dtype, f, n):
    l, c = 5, 1 << 12
    g = torch.Generator(device=dev).manual_seed(n)
    ta = torch.randn((l, c, f), generator=g, device=dev).to(dtype)
    tb = torch.randn((l, c, f), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, c, (l, 8, n), generator=g, device=dev, dtype=torch.int32)
    bary = torch.rand((l, 8, n), generator=g, device=dev).to(dtype)
    tg.reset_launches()
    out = tg.multilevel_table_gather(ta, idx, bary)
    oa, ob = tg.dual_multilevel_table_gather(ta, tb, idx, bary)
    torch.cuda.synchronize()
    assert tg.multilevel_table_gather.launches == 1
    assert tg.dual_multilevel_table_gather.launches == 1
    ref = tg.multilevel_gather_plain(ta, idx, bary)
    ref_b = tg.multilevel_gather_plain(tb, idx, bary)
    assert out.dtype == dtype and out.shape == (l, f, n)
    for got, want in ((out, ref), (oa, ref), (ob, ref_b)):
        # 8 fused multiply-adds: twice the V = 4 bound
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2 * _tol((ta, tb), want, dtype)
    assert torch.equal(oa, out)


@pytest.mark.parametrize("modes", ["shared", "float", "global", "hash"])
@pytest.mark.parametrize("pattern", ["random", "hot"])
def test_v8_scatter_and_dbary_match_plain(dev, modes, pattern):
    from pagnerf_tpu_torch.ops import hash_encoding as he
    spec, _, idx, bary, ta, _ = _hash_case(dev, 1 << 15, levels=4, log2_c=12)
    l, c = spec.num_levels, spec.capacity
    g = torch.Generator(device=dev).manual_seed(7)
    g_a = torch.randn((l, 2, idx.shape[2]), generator=g, device=dev)
    g_b = torch.randn((l, 2, idx.shape[2]), generator=g, device=dev)
    if pattern == "hot":
        idx, g_a, g_b = (idx % 7).contiguous(), g_a.abs(), g_b.abs()
    mode = {"shared": (tg.SHARED,) * l, "float": (tg.FLOAT,) * l,
            "global": (tg.GLOBAL,) * l,
            "hash": he.scatter_modes(spec.resolutions, c)}[modes]
    tg.reset_launches()
    single = tg.multilevel_table_grad(idx, bary, g_a, c, modes=mode)
    da, db = tg.dual_multilevel_table_grad(idx, bary, g_a, g_b, c, modes=mode)
    dbary = tg.multilevel_gather_dbary(ta, idx, g_a)
    torch.cuda.synchronize()
    assert (tg.multilevel_table_grad.launches, tg.dual_multilevel_table_grad.launches,
            tg.multilevel_gather_dbary.launches) == (1, 1, 1)
    _assert_scatter_close(single, idx, bary, g_a, c)
    _assert_scatter_close(da, idx, bary, g_a, c)
    _assert_scatter_close(db, idx, bary, g_b, c)
    want = tg.gather_dbary_plain(ta, idx, g_a)
    mag = tg.gather_dbary_plain(ta.abs(), idx, g_a.abs())
    assert dbary.shape == (l, 8, idx.shape[2])
    assert bool(((dbary - want).abs() <= 4 * F32_EPS * mag).all())


def test_v8_kernels_match_plain_at_the_hash_path_n(dev):
    """The hash grid's shapes on panoptic_nerf.yaml's microbatch (14 levels x
    2^19 x F=2, N = 2048 rays x 512 steps): gather single and dual, scatter
    with the grid's modes, dbary."""
    from pagnerf_tpu_torch.ops import hash_encoding as he
    spec, _, idx, bary, ta, tb = _hash_case(dev, 1 << 20)
    l, c = spec.num_levels, spec.capacity
    out = tg.multilevel_table_gather(ta, idx, bary)
    oa, ob = tg.dual_multilevel_table_gather(ta, tb, idx, bary)
    for got, want in ((out, tg.multilevel_gather_plain(ta, idx, bary)),
                      (ob, tg.multilevel_gather_plain(tb, idx, bary))):
        assert float((got - want).abs().max()) <= 2 * _tol((ta, tb), want, torch.float32)
    assert torch.equal(oa, out)
    del oa, ob, out
    g = torch.Generator(device=dev).manual_seed(9)
    g_a = torch.randn((l, 2, idx.shape[2]), generator=g, device=dev).abs()
    got = tg.multilevel_table_grad(idx, bary, g_a, c,
                                   modes=he.scatter_modes(spec.resolutions, c))
    _assert_scatter_close(got, idx, bary, g_a, c)
    del got
    dbary = tg.multilevel_gather_dbary(ta, idx, g_a)
    want = tg.gather_dbary_plain(ta, idx, g_a)
    mag = tg.gather_dbary_plain(ta.abs(), idx, g_a.abs())
    assert bool(((dbary - want).abs() <= 4 * F32_EPS * mag).all())


def test_hash_encode_on_card_matches_plain_with_gradients(dev):
    """``hash_encode_dual_T`` through the kernels against the same encode
    with the plain gathers on the card: features within the gather bound,
    table gradients within the scatter contract, coordinate gradients within
    1e-5 of their largest entry; the launches of one forward and backward."""
    from unittest import mock

    from pagnerf_tpu_torch.ops import hash_encoding as he
    spec, x, _, _, ta, tb = _hash_case(dev, 50000, levels=6, log2_c=14)
    g = torch.Generator(device=dev).manual_seed(4)
    w = torch.randn((6 * 2, x.shape[1]), generator=g, device=dev)
    runs = []
    for plain in (False, True):
        a, b, xx = (t.clone().requires_grad_() for t in (ta, tb, x))
        tg.reset_launches()
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(mock.patch.object(
                    tg, "dual_multilevel_table_gather",
                    lambda *args, **kw: _PlainDual.apply(*args[:4])))
            fa, fb = he.hash_encode_dual_T(a, b, xx, spec.resolutions)
            ((fa * w).sum() + (fb * w.flip(0)).sum()).backward()
        torch.cuda.synchronize()
        runs.append((fa.detach(), fb.detach(), a.grad, b.grad, xx.grad,
                     {k: f.launches for k, f in tg.KERNELS.items()}))
    (ka, kb, kda, kdb, kdx, launches), (pa, pb, pda, pdb, pdx, _) = runs
    assert launches["dual_gather"] == 1 and launches["dual_table_grad"] == 1
    assert launches["dbary"] == 1 and launches["gather"] == 0
    for got, want in ((ka, pa), (kb, pb)):
        assert float((got - want).abs().max()) <= 2 * _tol((ta, tb), want, torch.float32)
    for got, want in ((kda, pda), (kdb, pdb)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((kdx - pdx).abs().max()) <= 1e-5 * float(pdx.abs().max())


class _PlainDual(torch.autograd.Function):
    """The dual gather with the plain versions forward and backward (on
    CUDA tensors, where the wrappers launch the kernels)."""

    @staticmethod
    def forward(ctx, ta, tb, idx, bary):
        ctx.save_for_backward(ta, idx, bary)
        ctx.capacity = tb.shape[1]
        return tg.dual_gather_plain(ta, tb, idx, bary)

    @staticmethod
    def backward(ctx, ga, gb):
        ta, idx, bary = ctx.saved_tensors
        da, db = tg.dual_table_grad_plain(idx, bary.float(), ga.float().contiguous(),
                                          gb.float().contiguous(), ctx.capacity)
        return da, db, None, tg.gather_dbary_plain(ta, idx, ga.float())


# ---------------------------------------------------- the window merge (WINDOW)
def _ray_case(dev, rays, steps, levels=5, log2_c=14, along_x=False, seed=0):
    """The hash grid's idx/bary at ``rays`` rays of ``steps`` samples each,
    ray-major, as a training microbatch lays them out: origins in the box,
    random directions (or all along +x, where neighbouring samples share
    faces and the x pairs (2k, 2k + 1) of rows), steps of 1/256, so the
    finest level (resolution 512) sees about one sample a voxel and the
    coarsest about eight; samples past the box clamp onto its faces."""
    from pagnerf_tpu_torch.ops import hash_encoding as he
    spec = he.HashEncodingSpec(levels, 2, log2_c, 16, 512)
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.rand((rays, 3), generator=g, device=dev) * 2 - 1
    d = (torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(rays, 3) if along_x
         else torch.randn((rays, 3), generator=g, device=dev))
    d = d / d.norm(dim=1, keepdim=True)
    t = torch.arange(steps, device=dev, dtype=torch.float32) / 256
    x = (o[:, None, :] + t[None, :, None] * d[:, None, :]).reshape(-1, 3).T.contiguous()
    idx, w = he.hash_indices(x, spec.resolutions, log2_c)
    return spec, idx.contiguous(), w.contiguous()


def _window_modes(name, spec):
    from pagnerf_tpu_torch.ops import hash_encoding as he
    l = spec.num_levels
    return {"hash": he.scatter_modes(spec.resolutions, spec.capacity),
            "window": (tg.WINDOW,) * l,
            "window_global": tuple(tg.WINDOW if lv % 2 else tg.GLOBAL for lv in range(l))}[name]


@pytest.mark.parametrize("modes", ["hash", "window", "window_global"])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("rays,steps,along_x", [(64, 512, False), (64, 512, True),
                                                 (63, 509, False), (3, 7, True)],
                         ids=["rays", "along_x", "odd_n", "tiny"])
def test_window_scatter_on_ray_ordered_events_matches_plain(dev, modes, f, rays, steps,
                                                            along_x):
    """Consecutive samples of a few rays through a 5-level hash grid, so
    events of neighbouring samples meet at one row in other vertex slots
    (the window merges them) and at one slot over consecutive lanes (the
    warp merge): single and dual, random and same-signed cotangents, a third
    of the samples masked (zero cotangents); N odd or below a segment."""
    spec, idx, bary = _ray_case(dev, rays, steps, along_x=along_x, seed=f)
    l, c, n = spec.num_levels, spec.capacity, idx.shape[2]
    mode = _window_modes(modes, spec)
    g = torch.Generator(device=dev).manual_seed(11)
    g_a = torch.randn((l, f, n), generator=g, device=dev)
    g_b = torch.randn((l, f, n), generator=g, device=dev)
    g_a[:, :, ::3] = 0.0
    for ga, gb in ((g_a, g_b), (g_a.abs(), g_b.abs())):
        tg.reset_launches()
        single = tg.multilevel_table_grad(idx, bary, ga, c, modes=mode)
        da, db = tg.dual_multilevel_table_grad(idx, bary, ga, gb, c, modes=mode)
        torch.cuda.synchronize()
        assert (tg.multilevel_table_grad.launches,
                tg.dual_multilevel_table_grad.launches) == (1, 1)
        _assert_scatter_close(single, idx, bary, ga, c)
        _assert_scatter_close(da, idx, bary, ga, c)
        _assert_scatter_close(db, idx, bary, gb, c)


@pytest.mark.parametrize("modes", ["window", "window_global"])
@pytest.mark.parametrize("pattern", ["hot", "one_row", "distinct", "pairs"])
@pytest.mark.parametrize("v", [4, 8])
def test_window_scatter_patterns_match_plain_same_signed(dev, modes, pattern, v):
    """The window mode on patterns that push its bounds, same-signed
    cotangents, at V = 8 and V = 4, on every level or every other one:
    "hot" sends ~1e5 events to 7 rows (the rows pass their count and are
    summed again in float64); "one_row" puts every event of a level on one
    row (each window entry takes its most addends, every lane of a warp
    merges); "distinct" gives every event a row of its own (no merge
    anywhere); "pairs" walks rows 2k, 2k + 1, 2k + 2, ... in every slot, so
    each entry continues in another slot. Live-row bounds drop events at
    rows beyond."""
    l, c, n, f = 4, 1 << 16, (1 << 15) + 3, 2
    g = torch.Generator(device=dev).manual_seed(v)
    s = torch.arange(n, device=dev)
    if pattern == "hot":
        idx = torch.randint(0, 7, (l, v, n), generator=g, device=dev)
    elif pattern == "one_row":
        idx = torch.full((l, v, n), 5, device=dev)
    elif pattern == "distinct":
        idx = (s[None, None, :] * v + torch.arange(v, device=dev)[None, :, None]) % c
        idx = idx.expand(l, v, n)
    else:
        idx = (s[None, None, :] // 3 + torch.arange(v, device=dev)[None, :, None]) % c
        idx = idx.expand(l, v, n)
    idx = idx.to(torch.int32).contiguous()
    bary = torch.rand((l, v, n), generator=g, device=dev)
    g_a = torch.randn((l, f, n), generator=g, device=dev).abs()
    g_b = torch.rand((l, f, n), generator=g, device=dev)
    mode = tuple(tg.WINDOW if modes == "window" or lv % 2 else tg.GLOBAL for lv in range(l))
    for rows_used in (None, (3, 0, 40000, 0)):
        (single,) = tg._launch_grad(idx, bary, (g_a,), c, rows_used, mode)
        da, db = tg._launch_grad(idx, bary, (g_a, g_b), c, rows_used, mode)
        torch.cuda.synchronize()
        _assert_scatter_close(single, idx, bary, g_a, c, rows_used)
        _assert_scatter_close(da, idx, bary, g_a, c, rows_used)
        _assert_scatter_close(db, idx, bary, g_b, c, rows_used)
        if rows_used is not None:
            assert not bool(single[0, 3:].any()) and not bool(single[2, 40000:].any())


@pytest.mark.parametrize("f", [1, 2, 4])
def test_v4_scatter_keeps_its_contract_beside_the_window_modes(dev, f):
    """The permutohedral (V = 4) scatter under its default per-level modes
    (SHARED, GLOBAL, FLOAT), with run patterns and live-row bounds, in one
    call that also holds window levels (the plan groups them apart)."""
    l, c, n = 5, 1 << 12, 20001
    idx, bary, g_a, g_b = _grad_inputs(dev, l, c, f, n, seed=f, runs=True)
    rows_used = (64, 0, 4096, 0, 0)
    idx[0] %= 64
    modes = (tg.SHARED, tg.FLOAT, tg.GLOBAL, tg.WINDOW, tg.WINDOW)
    for mode in (tg.level_modes(tg.live_rows(rows_used, l, c), c), modes):
        (single,) = tg._launch_grad(idx, bary, (g_a,), c, rows_used, mode)
        da, db = tg._launch_grad(idx, bary, (g_a, g_b), c, rows_used, mode)
        torch.cuda.synchronize()
        _assert_scatter_close(single, idx, bary, g_a, c, rows_used)
        _assert_scatter_close(da, idx, bary, g_a, c, rows_used)
        _assert_scatter_close(db, idx, bary, g_b, c, rows_used)


# ------------------------------------------------ optimizers, activations, viewer
def _rel_close(a, b, tol, what):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    bound = tol * torch.clamp(b.abs(), min=1.0)
    assert bool(((a - b).abs() <= bound).all()), (what, float((a - b).abs().max()))


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 1e-2}, {"optimizer_type": "sgd"},
                                {"optimizer_type": "rmsprop"}],
                         ids=["adam", "adamw", "sgd", "rmsprop"])
def test_optimizer_update_on_card_matches_cpu(dev, kw):
    """Four masked steps (the second skipped on a non-finite gradient, the
    third with the extrinsics frozen, all under a global-norm clip) on the
    card and on CPU copies: parameters and state within 1e-6 relative; the
    skipped step bit-equal."""
    from pagnerf_tpu_torch.train.optimizer import MOMENTS, MaskedOptimizer, OptimizerConfig
    cfg = OptimizerConfig(clip_grad_norm=50.0, **kw)
    g = torch.Generator().manual_seed(0)
    shapes = {"nef.grid.tables": (4, 4096, 2), "nef.delta_grid.tables": (4, 4096, 2),
              "nef.decoder_color.hidden_0.kernel": (32, 64), "extrinsics": (8, 9)}
    init = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    p_c = {n: v.clone().to(dev) for n, v in init.items()}
    p_h = {n: v.clone() for n, v in init.items()}
    opt_c, opt_h = MaskedOptimizer(cfg, p_c), MaskedOptimizer(cfg, p_h)
    for step in range(4):
        grads = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
        if step == 1:
            grads["nef.grid.tables"][0, 0, 0] = float("nan")
            before = {n: p.clone() for n, p in p_c.items()}
        frozen = (lambda n: n.startswith("extrinsics")) if step == 2 else None
        applied = opt_c.update({n: v.to(dev) for n, v in grads.items()}, frozen, 50.0)
        assert applied == opt_h.update(grads, frozen, 50.0) == (step != 1)
        if step == 1:
            assert all(torch.equal(p_c[n], before[n]) for n in p_c)
        for n in shapes:
            _rel_close(p_c[n], p_h[n], 1e-6, f"{opt_c.kind} step {step} {n}")
            for key in MOMENTS[cfg.optimizer_type]:
                _rel_close(getattr(opt_c, key)[n], getattr(opt_h, key)[n], 1e-6, key)
    assert opt_c.count == opt_h.count == {grp: 3 for grp in opt_c.count}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["sin", "selu", "gelu"])
def test_decoder_activation_on_card_matches_cpu(dev, activation, dtype):
    """The activation on the same pre-activations within one bfloat16 ulp,
    or 4 float32 ulp (CUDA's ``sinf`` / ``tanhf`` are within 2, the CPU's
    within 1), of the larger of output and input (gelu's ``1 + tanh``
    cancels where tanh saturates); the decoder within 1e-5 of its largest
    output (float32) or the bf16 matmul bound of 3e-2."""
    from pagnerf_tpu_torch.models.decoder import BasicDecoder
    dec = BasicDecoder(32, 8, 64, 2, activation=activation, compute_dtype=dtype)
    dec.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn(32, 4096, generator=torch.Generator().manual_seed(2)) * 2
    pre = (torch.randn(64, 4096, generator=torch.Generator().manual_seed(3)) * 3).to(dtype)
    want, got = dec.act(pre).float(), dec.act(pre.to(dev)).float().cpu()
    eps = 2.0 ** -7 if dtype == torch.bfloat16 else 4 * 2.0 ** -23
    scale = torch.maximum(want.abs(), pre.float().abs()).clamp(min=2.0 ** -126)
    ulp = eps * torch.exp2(torch.floor(torch.log2(scale)))
    assert bool(((got - want).abs() <= ulp).all()), activation
    with torch.no_grad():
        out_h = dec(x)
        out_c = dec.to(dev)(x.to(dev)).cpu()
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5 * float(out_h.abs().max())
    assert float((out_c - out_h).abs().max()) <= tol, activation


def test_viewer_frame_on_card_matches_cpu(dev, tmp_path):
    """One viewer frame per channel of the tiny flagship served from the
    card: a PNG equal to the rendered array, rgb within 1 level and depth
    colours within 2 of the same trainer on the CPU."""
    import threading
    import urllib.request

    from pagnerf_tpu_torch import entry
    from pagnerf_tpu_torch.app.viewer_server import make_server
    from pagnerf_tpu_torch.data.image_io import read_png
    from pagnerf_tpu_torch.train.trainer import PanopticTrainer, TrainerConfig
    trainers = [PanopticTrainer(*entry.flagship(tiny=True, device=d,
                                                compute_dtype=torch.float32),
                                TrainerConfig(epochs=2)) for d in (dev, "cpu")]
    server, state = make_server(trainers[0], host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/api/frame?view=1&channel="
        for channel, tol in (("rgb", 1), ("depth", 2)):
            with urllib.request.urlopen(url + channel, timeout=300) as r:
                (tmp_path / "f.png").write_bytes(r.read())
            img = read_png(str(tmp_path / "f.png"))
            assert np.array_equal(img, state.frame(1, channel))
            from pagnerf_tpu_torch.app.orbit_renderer import render_channels_for_view
            want = render_channels_for_view(trainers[1], 1)[channel]
            assert np.abs(img.astype(int) - want.astype(int)).max() <= tol, channel
    finally:
        server.shutdown()
        server.server_close()


def _assign_inputs(b, k, m, seed, quant=None, frac=0.8):
    g = torch.Generator().manual_seed(seed)
    cost = -torch.rand((b, k, m), generator=g)
    if quant:
        cost = torch.round(cost / quant) * quant
    present = torch.rand((b, k), generator=g) < frac
    return cost, present


@pytest.mark.parametrize("b,k,m,quant,frac", [(1, 5, 5, None, 1.0), (3, 12, 8, None, 0.8),
                                              (2, 8, 30, 0.25, 0.8), (4, 40, 40, 0.1, 1.0),
                                              (1, 60, 60, None, 0.9), (2, 200, 200, None, 0.1),
                                              (1, 40, 40, 1.0, 1.0)])
def test_lap_assign_kernel_matches_plain(dev, b, k, m, quant, frac):
    """The assignment kernel against its plain version on the same card
    tensors: the same columns exactly, ties included (random, quantised
    and all-equal costs, absent rows, more rows than columns)."""
    from pagnerf_tpu_torch.ops import assignment
    cost, present = _assign_inputs(b, k, m, k + m, quant, frac)
    cost, present = cost.to(dev), present.to(dev)
    before = assignment.lap_assign.launches
    got = assignment.lap_assign(cost, present)
    torch.cuda.synchronize()
    assert assignment.lap_assign.launches == before + 1
    want = assignment.lap_assign_plain(cost, present)
    assert torch.equal(got, want)
    # [K, M] as a batch of one
    assert torch.equal(assignment.lap_assign(cost[0], present[0]), want[0])


def test_fused_step_graph_replay_matches_host_loop(dev):
    """The tiny flagship's panoptic step on the card: the fused step's
    eager first step, its capture and replay, and a second replay, each
    from the same state, against the host loop: parameters and moments
    within the host loop's own spread of two runs (its scatter's float
    atomics), losses and counts equal; then the voxel packed stage after a
    prune. The wrappers count no launch at the capture or the replays."""
    import dataclasses

    from pagnerf_tpu_torch import entry
    from pagnerf_tpu_torch.ops import table_gather as tg
    from pagnerf_tpu_torch.train.trainer import PanopticTrainer
    pipe, ds = entry.flagship(tiny=True, device=dev, compute_dtype=torch.float32)
    pipe.requires_grad_(True)
    cfg = dataclasses.replace(entry.train_config("panoptic", tiny=True), batch_size=3,
                              voxel_raymarch_epoch_start=1)
    t = PanopticTrainer(pipe, ds, cfg, occ_level=5)

    def snapshot():
        return ([p.detach().clone() for p in t.params.values()],
                [m.clone() for m in list(t.opt.mu.values()) + list(t.opt.nu.values())],
                t.opt.counts.clone())

    def restore(snap):
        with torch.no_grad():
            for x, v in zip(list(t.params.values()) + list(t.opt.mu.values())
                            + list(t.opt.nu.values()) + [t.opt.counts],
                            snap[0] + snap[1] + [snap[2]]):
                x.copy_(v)

    for epoch in (0, 2):
        if epoch:
            t.prune(seed=True)
        stage = t.stage_for_epoch(epoch)
        batch = ds.sample_batch(np.random.default_rng(epoch), 3, 32)
        gen, snap = t.generator.get_state(), snapshot()
        runs = []
        for i, fused in enumerate((False, False, True, True, True)):
            restore(snap)
            t.generator.set_state(gen)
            if i == 3:        # the capture and replay, then a replay
                before = {k: f.launches for k, f in tg.KERNELS.items()}
            losses = (t.fused_train_step if fused else t.train_step)(stage, batch)
            torch.cuda.synchronize()
            runs.append(({n: p.detach().clone() for n, p in t.params.items()},
                         {n: m.clone() for n, m in t.opt.mu.items()},
                         {k: v.clone() for k, v in losses.items()}, t.opt.count))
        rec = t.fused_log[-1]
        assert (rec["steps"], rec["replays"]) == (3, 2) and rec["capture_ms"] > 0
        assert {k: f.launches for k, f in tg.KERNELS.items()} == before
        host, host2 = runs[0], runs[1]
        for graph in runs[2:]:
            assert graph[3] == host[3]
            assert all(torch.equal(graph[2][k], host[2][k]) for k in host[2])
            for i in (0, 1):
                for n in host[i]:
                    spread = float((host2[i][n] - host[i][n]).abs().max())
                    scale = float(host[i][n].abs().max())
                    d = float((graph[i][n] - host[i][n]).abs().max())
                    assert d <= max(spread, 1e-6 * scale), (stage.label, n, d, spread)


def _assign_case_names():
    from pagnerf_tpu_torch import profile_assign as pa
    return [n for n, _, _ in pa.assignment_cases() + pa.tie_cases()]


@pytest.mark.parametrize("name", _assign_case_names())
def test_lap_assign_kernel_on_the_cases_and_ties(dev, name):
    """The warp-per-image kernel against its plain version, column for
    column, on ``chip_smoke.py``'s assignment cases and on small-integer
    ties across the 32-column chunks of a warp (K, M of 33 to 70)."""
    from pagnerf_tpu_torch import profile_assign as pa
    from pagnerf_tpu_torch.ops import assignment
    cost, present = {n: (c, p) for n, c, p in pa.assignment_cases() + pa.tie_cases()}[name]
    c, p = torch.from_numpy(cost).to(dev), torch.from_numpy(present).to(dev)
    got = assignment.lap_assign(c, p)
    torch.cuda.synchronize()
    assert torch.equal(got, assignment.lap_assign_plain(c[None], p[None])[0])


@pytest.mark.parametrize("name", ["penalties_0", "near_ties_0.01", "plateau_2", "two_tier"])
def test_lap_assign_kernel_uncut_200_matches_scipy(dev, name):
    """The uncut 200 x 200 cases (the plain version is too slow there): a
    valid matching of scipy's optimal cost, within ``cost_tolerance``."""
    from pagnerf_tpu_torch import profile_assign as pa
    from pagnerf_tpu_torch.ops import assignment
    cost, present = {n: (c, p) for n, c, p in pa.large_cases()}[name]
    got = assignment.lap_assign(torch.from_numpy(cost).to(dev),
                                torch.from_numpy(present).to(dev)).cpu().numpy()
    rows = np.nonzero(present)[0][:200]
    assert len(set(got[rows].tolist())) == len(rows)
    assert (pa.matched_cost(cost, present, got) - pa.scipy_cost(cost, present)
            <= pa.cost_tolerance(name, cost, present))


@pytest.mark.parametrize("b,k,m,quant,frac", [(9, 40, 40, 0.25, 0.9),
                                              (2, 300, 300, 0.25, 0.1),
                                              (3, 1000, 240, 0.1, 0.05),
                                              (5, 33, 65, 1.0, 1.0)])
def test_lap_assign_kernel_plans_match_plain(dev, b, k, m, quant, frac):
    """Every plan of ``launch_geometry``: four images a block with a part
    block, columns in shared memory (M > 256) unstaged, unstaged rows with
    register columns, and M past two chunks; quantised ties."""
    from pagnerf_tpu_torch.ops import assignment
    cost, present = _assign_inputs(b, k, m, 7 * k + m, quant, frac)
    cost, present = cost.to(dev), present.to(dev)
    got = assignment.lap_assign(cost, present)
    torch.cuda.synchronize()
    assert torch.equal(got, assignment.lap_assign_plain(cost, present))
    assignment.empty_launch(cost, present)
    torch.cuda.synchronize()


@pytest.mark.parametrize("v", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 2, 4])
def test_packed_dual_gather_matches_plain(dev, v, dtype, f):
    """The dual gather on packed [L, C, 2F] rows: within the gathers' bound
    of the two-table plain version (bit-equal to the plain version on the
    packed rows' tolerance alike), bit-equal to two single gathers, and
    after a table's in-place update the copy is made again and the outputs
    follow."""
    from pagnerf_tpu_torch.ops import table_pack
    g = torch.Generator(device=dev).manual_seed(v + f)
    l, c, n = 5, 1 << 12, 4097
    ta = torch.randn((l, c, f), generator=g, device=dev).to(dtype)
    tb = torch.randn((l, c, f), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, c, (l, v, n), generator=g, device=dev, dtype=torch.int32)
    bary = torch.rand((l, v, n), generator=g, device=dev).to(dtype)
    for _ in range(2):
        before = tg.dual_multilevel_table_gather.launches
        oa, ob = tg.dual_multilevel_table_gather(ta, tb, idx, bary)
        torch.cuda.synchronize()
        assert tg.dual_multilevel_table_gather.launches == before + 1
        assert torch.equal(table_pack._packed_copy[2], torch.cat((ta, tb), dim=2))
        assert torch.equal(oa, tg.multilevel_table_gather(ta, idx, bary))
        assert torch.equal(ob, tg.multilevel_table_gather(tb, idx, bary))
        ref = tg.dual_gather_plain(ta, tb, idx, bary)
        packed_ref = tg.dual_gather_packed_plain(table_pack._packed_copy[2], idx, bary)
        tol = (v // 2) * _tol((ta, tb), ref[0], dtype)
        for got, want, want_p in zip((oa, ob), ref, packed_ref):
            assert torch.equal(want, want_p)
            assert float((got.float() - want.float()).abs().max()) <= tol
        with torch.no_grad():
            tb.mul_(-2)
