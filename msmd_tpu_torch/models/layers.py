"""Layers that keep parameters in float32 and compute in a chosen dtype.

The JAX package builds every module with ``dtype`` (the compute dtype,
bfloat16 in production) and ``param_dtype`` (float32): a dense layer
casts its input and its weights to ``dtype`` at use, and a LayerNorm
takes its statistics in float32 and returns ``dtype``. These layers do
the same, so a bfloat16 model here rounds where the JAX one does.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from msmd_tpu_torch.parallel.tp import TPShard, copy_to_group, reduce_from_group


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``. Sharded by
    ``parallel.tp.shard_model`` it holds a ``TPShard`` in ``tp``: a column
    shard takes the whole input (its gradient summed over the group), a
    row shard sums its partial product over the group (in f32) before
    the bias."""

    tp: Optional[TPShard] = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the product is rounded to compute_dtype before the bias is
        # added, as flax adds it: at bf16 the two differ by an ulp
        dt = self.compute_dtype
        if self.tp is not None and self.tp.mode == "col":
            x = copy_to_group(x, self.tp)
        y = F.linear(x.to(dt), self.weight.to(dt))
        if self.tp is not None and self.tp.mode == "row":
            y = reduce_from_group(y, self.tp)
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, output in ``compute_dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class _Conv1dFn(torch.autograd.Function):
    """``F.conv1d`` whose backward takes cuDNN's deterministic algorithms:
    its default weight-gradient algorithm sums with atomics, so on the card
    a train step's gradients changed between runs (the style encoder's
    first convolution's by up to 6e-5 of the step's largest gradient, on
    an H100), and ranks that must agree drifted apart."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, dilation, groups)
        return F.conv1d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conv
        cudnn = torch.backends.cudnn
        before, cudnn.deterministic = cudnn.deterministic, True
        try:
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, stride, padding, dilation, False, [0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        finally:
            cudnn.deterministic = before
        return gx, gw, None, None, None, None


class Conv1d(nn.Conv1d):
    """Channels-last 1-D convolution: takes and returns (N, L, C) like
    ``flax.linen.Conv``; computes in ``compute_dtype``; its backward is
    deterministic (``_Conv1dFn``)."""

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
        y = _Conv1dFn.apply(rnd(x).transpose(1, 2), rnd(self.weight), self.stride, self.padding, self.dilation,
                            self.groups)
        y = y.transpose(1, 2).to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, flax ``nn.gelu(approximate=False)``."""
    return F.gelu(x, approximate="none")


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (a scalar operand of a product in
    that dtype), as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def uniform(shape, rng: torch.Generator, device, tp: Optional[TPShard] = None, dim: int = -1) -> torch.Tensor:
    """U[0, 1) f32 draws from ``rng`` (on its own device), on ``device``.
    With ``tp``, ``shape`` is a rank's shard along ``dim`` of a tensor
    sharded over the group: the whole tensor's draws are made and the
    rank's slice kept, so they are those of one device."""
    if tp is None:
        return torch.rand(shape, generator=rng, device=rng.device).to(device)
    shape = list(shape)
    n = shape[dim]
    shape[dim] = n * tp.size
    return torch.rand(shape, generator=rng, device=rng.device).narrow(dim, tp.rank * n, n).to(device)


def dropout(x: torch.Tensor, p: float, rng: Optional[torch.Generator], tp: Optional[TPShard] = None,
            dim: int = -1) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - p and scale by
    1 / (1 - p), with the keep mask drawn from ``rng``. ``rng`` None is
    eval mode (the identity). ``F.dropout`` takes no generator, so the
    draws here are explicit. ``tp``/``dim``: ``x`` is a shard (``uniform``)."""
    if rng is None or p == 0.0:
        return x
    keep = uniform(x.shape, rng, x.device, tp, dim) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


@dataclass(frozen=True)
class SampleRows:
    """A rank's rows of a global batch, for the per-sample draws (timestep,
    noise, CFG drop, the style sample): each is drawn for all ``total``
    rows from the shared ``generator`` and the rows at ``index`` (int64)
    kept, so a sample's draws do not depend on how many ranks share the
    batch. ``generator`` is in the same state on every rank."""

    generator: torch.Generator
    index: torch.Tensor
    total: int

    def draw(self, fn: Callable[[int, torch.Generator], torch.Tensor], dim: int = 0) -> torch.Tensor:
        """``fn(n, generator)`` draws for n rows along ``dim``."""
        out = fn(self.total, self.generator)
        return out.index_select(dim, self.index.to(out.device))

    def twice(self) -> "SampleRows":
        """The rows of two global batches stacked on the batch axis."""
        return SampleRows(self.generator, torch.cat([self.index, self.index + self.total]), 2 * self.total)


def per_sample(n: int, generator: Optional[torch.Generator], rows: Optional[SampleRows],
               fn: Callable[[int, Optional[torch.Generator]], torch.Tensor], dim: int = 0) -> torch.Tensor:
    """``fn(n, generator)``, or under ``rows`` the rank's rows of the
    global draw from the shared generator."""
    return fn(n, generator) if rows is None else rows.draw(fn, dim)


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
