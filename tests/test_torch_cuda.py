"""The CUDA gather kernel against its plain version, on the card.

Marked ``cuda``: these tests build ``ops/csrc/permuto_gather.cu`` with nvcc
and launch it, so on a host without a card they skip. Run them on the card
with ``python -m pytest tests/test_torch_cuda.py -q --noconftest``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).

Tolerance: float32, 8 ulp of the largest table entry (fused vs separate
multiply-adds over 4 vertices); bfloat16, that plus one bf16 ulp of the
largest output (the float32 sums may round to neighbouring bf16 values)."""
import numpy as np
import pytest
import torch

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
