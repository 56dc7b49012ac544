"""The benchmark's own tests (CPU, and ``cuda``-marked ones that skip without
a card): ``python -m pytest h100bench/tests -q`` from the repository's root."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips on a host without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)


def _tf32_round(x):
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    import torch
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.fixture
def tf32_on_cpu(monkeypatch):
    """The control's TF32 on the CPU, where it does not exist: while
    ``allow_tf32`` is set, the reference's decoders round their matmul
    operands to TF32, as the card does to every float32 matmul's."""
    import torch
    from h100bench.reference.models.decoder import DenseT
    plain = DenseT.forward

    def forward(self, x):
        if x.device.type != "cpu" or not torch.backends.cuda.matmul.allow_tf32:
            return plain(self, x)
        y = _tf32_round(self.kernel.to(self.dtype)).t() @ _tf32_round(x.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)[:, None]
    monkeypatch.setattr(DenseT, "forward", forward)
