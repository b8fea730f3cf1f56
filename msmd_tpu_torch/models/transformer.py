"""Post-LN transformer blocks with torch ``nn.Transformer*`` algebra
(the port of ``msmd_tpu/models/transformer.py``; reference:
model.py:874-885, style_encoder.py:158-160).

Dropout (rate 0.1) runs when a ``torch.Generator`` is passed as ``rng``
(training); ``rng`` None is eval mode. Masks use torch's boolean
convention, True = disallowed. Two additions over the reference, as in
the JAX package:

- the cross-attention memory K/V is computed once per sampling window
  (``TransformerDecoder.cache_memory``) and reused at every step;
- under the width-1 alignment band every motion row's softmax is a
  one-hot on memory row i - 1, so cross-attention is an exact V-gather
  and only the person row (row 0) attends (``_identity_band``). In
  training, dropout of a one-hot weight row is a Bernoulli(1 - p) / (1 - p)
  scale of the gathered V row, drawn per (batch, row, head); the person
  row keeps real attention-weight dropout.

With ``fused_ffn_train`` a training layer's FFN block (FFN, dropout,
residual, LayerNorm) is the kernel K7 (``ops/kernels/ffn_train.py``),
with a fresh mask seed drawn from ``rng`` per layer call. The JAX package
takes its flax ops instead when no row tile of at most 2048 divides the
row count (a TPU VMEM limit, ``msmd_tpu/models/transformer.py``:307); the
port's kernel takes any row count, so it has no such fallback.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from msmd_tpu_torch.models.layers import Dense, LayerNorm, dropout, gelu, in_dtype, uniform
from msmd_tpu_torch.ops.kernels.ffn_train import fused_ffn_ln_train

Rng = Optional[torch.Generator]
KVCache = Tuple[torch.Tensor, torch.Tensor]  # (k, v): (B, L, H, Dh)


def _softmax_f32(logits: torch.Tensor, dtype) -> torch.Tensor:
    """Softmax promoted to at least float32, cast back to ``dtype``."""
    sm_dt = torch.promote_types(logits.dtype, torch.float32)
    return torch.softmax(logits.to(sm_dt), dim=-1).to(dtype)


class MultiHeadAttention(nn.Module):
    """``nn.MultiheadAttention`` with separate q/k/v/out projections."""

    def __init__(self, dim: int, n_heads: int, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dim, self.n_heads, self.dtype, self.dropout = dim, n_heads, dtype, dropout
        self.q_proj = Dense(dim, dim, dtype=dtype)
        self.k_proj = Dense(dim, dim, dtype=dtype)
        self.v_proj = Dense(dim, dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], t.shape[1], self.n_heads, self.head_dim)

    def project_kv(self, kv_input: torch.Tensor) -> KVCache:
        """K/V projections of a fixed memory."""
        return self._heads(self.k_proj(kv_input)), self._heads(self.v_proj(kv_input))

    def _scale(self) -> float:
        """1 / sqrt(head_dim) rounded to the compute dtype, as a Python
        number: a tensor made on the card would be a blocking copy."""
        return in_dtype(1.0 / math.sqrt(self.head_dim), self.dtype)

    def _identity_band(self, q: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, rng: Rng) -> torch.Tensor:
        B, Lq, _ = q.shape
        q0 = self._heads(self.q_proj(q[:, :1]))
        logits0 = torch.einsum("bqhd,bkhd->bhqk", q0 * self._scale(), kh.to(self.dtype))
        w0 = dropout(_softmax_f32(logits0, self.dtype), self.dropout, rng)
        person = torch.einsum("bhqk,bkhd->bqhd", w0, vh.to(self.dtype))
        motion = vh.to(self.dtype)
        if rng is not None and self.dropout > 0.0:
            keep = uniform((B, kh.shape[1], self.n_heads, 1), rng, q.device) < 1.0 - self.dropout
            motion = motion * keep.to(self.dtype) / in_dtype(1.0 - self.dropout, self.dtype)
        out = torch.cat([person, motion], dim=1)
        return self.out_proj(out.reshape(B, Lq, self.dim))

    def forward(
        self,
        q: torch.Tensor,
        k: Optional[torch.Tensor] = None,
        v: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        kv_cache: Optional[KVCache] = None,
        identity_band: bool = False,
        rng: Rng = None,
    ) -> torch.Tensor:
        B, Lq, _ = q.shape
        if kv_cache is not None:
            kh, vh = kv_cache
        else:
            k = q if k is None else k
            v = k if v is None else v
            kh, vh = self._heads(self.k_proj(k)), self._heads(self.v_proj(v))
        if identity_band:
            if kh.shape[1] != Lq - 1:
                raise ValueError(f"identity band needs Lm == Lq - 1, got {kh.shape[1]} and {Lq}")
            return self._identity_band(q, kh, vh, rng)
        qh = self._heads(self.q_proj(q))
        logits = torch.einsum("bqhd,bkhd->bhqk", qh * self._scale(), kh.to(self.dtype))
        if mask is not None:
            logits = logits.masked_fill(mask.to(logits.device), torch.finfo(torch.float32).min)
        weights = dropout(_softmax_f32(logits, self.dtype), self.dropout, rng)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, vh.to(self.dtype)).reshape(B, Lq, self.dim)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Dense(dim, hidden_dim, dtype=dtype)
        self.linear2 = Dense(hidden_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, rng: Rng = None) -> torch.Tensor:
        return self.linear2(dropout(gelu(self.linear1(x)), self.dropout, rng))


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attn, cross-attn on the memory, FFN,
    each followed by residual add and LayerNorm."""

    def __init__(self, dim: int, n_heads: int, ffn_dim: int, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.self_attn = MultiHeadAttention(dim, n_heads, dtype, dropout)
        self.cross_attn = MultiHeadAttention(dim, n_heads, dtype, dropout)
        self.ffn = FeedForward(dim, ffn_dim, dtype, dropout)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.norm3 = LayerNorm(dim, dtype=dtype)

    def memory_kv(self, memory: torch.Tensor) -> KVCache:
        return self.cross_attn.project_kv(memory)

    def _ffn_block_k7(self, x: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
        """LN(x + drop(FFN_drop(x))) through K7 (``_fused_ffn_ln_train`` of
        the JAX layer), with the seed of its masks drawn from ``rng``."""
        dt = self.dtype
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=rng, device=rng.device, dtype=torch.int32)
        l1, l2 = self.ffn.linear1, self.ffn.linear2
        return fused_ffn_ln_train(x.to(dt), l1.weight.to(dt), l1.bias.to(dt), l2.weight.to(dt), l2.bias.to(dt),
                                  self.norm3.weight, self.norm3.bias, seed.to(x.device), self.dropout)

    def forward(self, x, memory=None, memory_mask=None, memory_kv: Optional[KVCache] = None,
                cross_identity_band: bool = False, rng: Rng = None, fused_ffn_train: bool = False):
        x = self.norm1(x + dropout(self.self_attn(x, rng=rng), self.dropout, rng))
        ca = self.cross_attn(x, memory, memory, mask=memory_mask, kv_cache=memory_kv,
                             identity_band=cross_identity_band, rng=rng)
        x = self.norm2(x + dropout(ca, self.dropout, rng))
        if fused_ffn_train and rng is not None:
            return self._ffn_block_k7(x, rng)
        return self.norm3(x + dropout(self.ffn(x, rng), self.dropout, rng))


class TransformerDecoder(nn.Module):
    """Stack of decoder layers (torch ``nn.TransformerDecoder``, norm=None)."""

    def __init__(self, n_layers: int, dim: int, n_heads: int, ffn_dim: int, dtype=torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(dim, n_heads, ffn_dim, dtype) for _ in range(n_layers)
        )

    def cache_memory(self, memory: torch.Tensor) -> List[KVCache]:
        """Per-layer K/V of a fixed cross-attention memory."""
        return [layer.memory_kv(memory) for layer in self.layers]

    def forward(self, x, memory=None, memory_mask=None, memory_kv: Optional[List[KVCache]] = None,
                cross_identity_band: bool = False, rng: Rng = None, fused_ffn_train: bool = False):
        for i, layer in enumerate(self.layers):
            kv = memory_kv[i] if memory_kv is not None else None
            x = layer(x, memory, memory_mask, kv, cross_identity_band, rng, fused_ffn_train)
        return x


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (torch ``nn.TransformerEncoderLayer``, gelu)."""

    def __init__(self, dim: int, n_heads: int, ffn_dim: int, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(dim, n_heads, dtype, dropout)
        self.ffn = FeedForward(dim, ffn_dim, dtype, dropout)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, rng: Rng = None) -> torch.Tensor:
        x = self.norm1(x + dropout(self.self_attn(x, mask=mask, rng=rng), self.dropout, rng))
        return self.norm2(x + dropout(self.ffn(x, rng), self.dropout, rng))
