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
single encode bit-equal to the dual's A side."""
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
