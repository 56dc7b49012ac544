"""Shallow MLP decoder, feature-major (counterpart of
``pagnerf_tpu/models/decoder.py``).

``DenseT`` keeps the JAX package's parameter layout (kernel ``[Cin, Cout]``,
bias ``[Cout]``) so converted weights load as they are; it computes
``kernel^T @ x`` on ``[Cin, N]`` activations in ``compute_dtype`` (bfloat16 on
the flagship, where the matmul rounds its output to bfloat16 as XLA's
``preferred_element_type`` does). ``BasicDecoder`` returns float32.

The activations are the JAX package's ``get_activation``: ``relu``,
``sin``, ``selu`` and ``gelu`` (flax's tanh approximation), each applied in
the decoder's ``compute_dtype``. ``selu`` and ``gelu`` repeat flax's
operations one by one, their constants in the input's dtype as JAX's weak
types make them: in bfloat16 ``F.gelu(approximate="tanh")`` and
``torch.selu`` round once in float32 and land up to 1.6e-2 / 6.3e-2 from
flax's, where this order is bit-equal to it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn



def _const(v: float, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def selu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.selu``: ``scale * where(x > 0, x, alpha * expm1(x))``."""
    neg = _const(1.6732632423543772, x) * torch.expm1(torch.where(x > 0, _const(0.0, x), x))
    return _const(1.0507009873554805, x) * torch.where(x > 0, x, neg)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` (``approximate=True``, the tanh approximation):
    ``x * 0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 x^3)))``."""
    inner = _const(math.sqrt(2 / math.pi), x) * (x + _const(0.044715, x) * (x * x * x))
    return x * (_const(0.5, x) * (_const(1.0, x) + torch.tanh(inner)))


_ACTIVATIONS = {"relu": torch.relu, "sin": torch.sin, "selu": selu, "gelu": gelu,
                "none": lambda x: x, None: lambda x: x}


class DenseT(nn.Module):
    """x [Cin, N] -> [Cout, N]; without ``use_bias`` it has no ``bias``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator, zero_kernel: bool = False,
                         bias_init: Optional[Sequence[float]] = None) -> None:
        """LeCun-normal kernel (truncated at two standard deviations, the
        JAX package's ``lecun_normal``) or zeros; zero bias, optionally with
        its leading entries set from ``bias_init``."""
        with torch.no_grad():
            if zero_kernel:
                self.kernel.zero_()
            else:
                # truncated normal on [-2, 2] has std 0.8796; rescale to 1/sqrt(fan_in)
                std = math.sqrt(1.0 / self.kernel.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            if self.bias is not None:
                self.bias.zero_()
                for i, v in enumerate(bias_init or ()):
                    self.bias[i] = v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.kernel.to(self.dtype).t() @ x.to(self.dtype)        # [Cout, N]
        return y if self.bias is None else y + self.bias.to(self.dtype)[:, None]


class BasicDecoder(nn.Module):
    """``num_layers`` hidden layers with an activation, then the linear output
    layer ``lout``; submodules are named ``hidden_<i>`` and ``lout`` like the
    JAX package's parameters. Hidden layer ``i`` in ``skip`` reads the
    previous activations with the decoder's input appended."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 64,
                 num_layers: int = 1, activation: str = "relu",
                 output_bias_init: Optional[Sequence[float]] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 zero_init_output: bool = False, skip: Sequence[int] = ()):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise KeyError(activation)
        self.act = _ACTIVATIONS[activation]
        self.compute_dtype = compute_dtype
        self.num_layers = num_layers
        self.output_bias_init = output_bias_init
        self.zero_init_output = zero_init_output
        self.skip = tuple(skip)
        cin = input_dim
        for i in range(num_layers):
            if i in self.skip:
                cin += input_dim
            self.add_module(f"hidden_{i}", DenseT(cin, hidden_dim, compute_dtype))
            cin = hidden_dim
        self.lout = DenseT(cin, output_dim, compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.num_layers):
            getattr(self, f"hidden_{i}").reset_parameters(generator)
        self.lout.reset_parameters(generator, zero_kernel=self.zero_init_output,
                                   bias_init=self.output_bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = h = x.to(self.compute_dtype)
        for i in range(self.num_layers):
            if i in self.skip:
                h = torch.cat([h, x], dim=0)
            h = self.act(getattr(self, f"hidden_{i}")(h))
        return self.lout(h).float()
