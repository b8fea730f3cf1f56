"""Post-LN transformer blocks with torch ``nn.Transformer*`` algebra
(the port of ``msmd_tpu/models/transformer.py``; reference:
model.py:874-885, style_encoder.py:158-160).

Inference only: dropout is the identity here. Masks use torch's boolean
convention, True = disallowed. Two additions over the reference, as in
the JAX package:

- the cross-attention memory K/V is computed once per sampling window
  (``TransformerDecoder.cache_memory``) and reused at every step;
- under the width-1 alignment band every motion row's softmax is a
  one-hot on memory row i - 1, so cross-attention is an exact V-gather
  and only the person row (row 0) attends (``_identity_band``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from msmd_tpu_torch.models.layers import Dense, LayerNorm, gelu

KVCache = Tuple[torch.Tensor, torch.Tensor]  # (k, v): (B, L, H, Dh)


def _softmax_f32(logits: torch.Tensor, dtype) -> torch.Tensor:
    """Softmax promoted to at least float32, cast back to ``dtype``."""
    sm_dt = torch.promote_types(logits.dtype, torch.float32)
    return torch.softmax(logits.to(sm_dt), dim=-1).to(dtype)


class MultiHeadAttention(nn.Module):
    """``nn.MultiheadAttention`` with separate q/k/v/out projections."""

    def __init__(self, dim: int, n_heads: int, dtype=torch.float32):
        super().__init__()
        self.dim, self.n_heads, self.dtype = dim, n_heads, dtype
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

    def _scale(self, device) -> torch.Tensor:
        return torch.tensor(1.0 / math.sqrt(self.head_dim), dtype=self.dtype, device=device)

    def _identity_band(self, q: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
        B, Lq, _ = q.shape
        q0 = self._heads(self.q_proj(q[:, :1]))
        logits0 = torch.einsum("bqhd,bkhd->bhqk", q0 * self._scale(q.device), kh.to(self.dtype))
        w0 = _softmax_f32(logits0, self.dtype)
        person = torch.einsum("bhqk,bkhd->bqhd", w0, vh.to(self.dtype))
        motion = vh.to(self.dtype)
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
            return self._identity_band(q, kh, vh)
        qh = self._heads(self.q_proj(q))
        logits = torch.einsum("bqhd,bkhd->bhqk", qh * self._scale(q.device), kh.to(self.dtype))
        if mask is not None:
            neg = torch.tensor(torch.finfo(torch.float32).min, dtype=logits.dtype, device=logits.device)
            logits = torch.where(mask.to(logits.device), neg, logits)
        weights = _softmax_f32(logits, self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, vh.to(self.dtype)).reshape(B, Lq, self.dim)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear1 = Dense(dim, hidden_dim, dtype=dtype)
        self.linear2 = Dense(hidden_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(gelu(self.linear1(x)))


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attn, cross-attn on the memory, FFN,
    each followed by residual add and LayerNorm."""

    def __init__(self, dim: int, n_heads: int, ffn_dim: int, dtype=torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, n_heads, dtype)
        self.cross_attn = MultiHeadAttention(dim, n_heads, dtype)
        self.ffn = FeedForward(dim, ffn_dim, dtype)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.norm3 = LayerNorm(dim, dtype=dtype)

    def memory_kv(self, memory: torch.Tensor) -> KVCache:
        return self.cross_attn.project_kv(memory)

    def forward(self, x, memory=None, memory_mask=None, memory_kv: Optional[KVCache] = None,
                cross_identity_band: bool = False):
        x = self.norm1(x + self.self_attn(x))
        ca = self.cross_attn(x, memory, memory, mask=memory_mask, kv_cache=memory_kv,
                             identity_band=cross_identity_band)
        x = self.norm2(x + ca)
        return self.norm3(x + self.ffn(x))


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
                cross_identity_band: bool = False):
        for i, layer in enumerate(self.layers):
            kv = memory_kv[i] if memory_kv is not None else None
            x = layer(x, memory, memory_mask, kv, cross_identity_band)
        return x


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (torch ``nn.TransformerEncoderLayer``, gelu)."""

    def __init__(self, dim: int, n_heads: int, ffn_dim: int, dtype=torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, n_heads, dtype)
        self.ffn = FeedForward(dim, ffn_dim, dtype)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, mask=mask))
        return self.norm2(x + self.ffn(x))
