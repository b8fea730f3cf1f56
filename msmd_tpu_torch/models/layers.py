"""Layers that keep parameters in float32 and compute in a chosen dtype.

The JAX package builds every module with ``dtype`` (the compute dtype,
bfloat16 in production) and ``param_dtype`` (float32): a dense layer
casts its input and its weights to ``dtype`` at use, and a LayerNorm
takes its statistics in float32 and returns ``dtype``. These layers do
the same, so a bfloat16 model here rounds where the JAX one does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the product is rounded to compute_dtype before the bias is
        # added, as flax adds it: at bf16 the two differ by an ulp
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, output in ``compute_dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class Conv1d(nn.Conv1d):
    """Channels-last 1-D convolution: takes and returns (N, L, C) like
    ``flax.linen.Conv``; computes in ``compute_dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, bias: bool = True, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding, groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Operands are rounded to compute_dtype and the sum is taken in
        # f32, then rounded once: what a bf16 convolution with f32
        # accumulation gives; the bias is added after that rounding, as
        # flax adds it. (PyTorch's CPU bf16 grouped convolution does not
        # accumulate in f32: its error reached the size of the output on
        # the positional conv.)
        dt = self.compute_dtype
        rnd = lambda t: t.to(dt).float()
        y = F.conv1d(rnd(x).transpose(1, 2), rnd(self.weight), None,
                     self.stride, self.padding, self.dilation, self.groups)
        y = y.transpose(1, 2).to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, flax ``nn.gelu(approximate=False)``."""
    return F.gelu(x, approximate="none")


@torch.no_grad()
def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights with the JAX package's initialisers in
    distribution: LeCun-normal kernels (std 1/sqrt(fan_in)), zero biases,
    unit norm scales, and N(0, 1) for free parameters (PE, null and start
    embeddings). Draws on the CPU from one ``torch.Generator``, so a
    seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    for mod in module.modules():
        own = dict(mod.named_parameters(recurse=False))
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            own["weight"].fill_(1.0)
            own["bias"].zero_()
            continue
        if isinstance(mod, (nn.Linear, nn.Conv1d)):
            w = own["weight"]
            fan_in = w.shape[1] * (w.shape[2] if w.ndim == 3 else 1)
            normal(w, 1.0 / math.sqrt(fan_in))
            if own.get("bias") is not None:
                own["bias"].zero_()
            continue
        for p in own.values():
            normal(p, 1.0)
    return module
