"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these tests build ``ops/csrc/permuto_gather.cu`` and
``ops/csrc/permuto_scatter.cu`` with nvcc and launch them, so on a host
without a card they skip. Run them on the card
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
of |g * T| (a fused multiply-add chain against separate products)."""
import numpy as np
import pytest
import torch

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
        "dbary": 0}
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
