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

With ``remat`` (``remat_denoiser``) each training layer is checkpointed and
recomputed in the backward, drawing the same masks (``_remat_layer``).
With ``fused_ffn_train`` a training layer's FFN block (FFN, dropout,
residual, LayerNorm) is the kernel K7 (``ops/kernels/ffn_train.py``),
with a fresh mask seed drawn from ``rng`` per layer call. In eval mode
(``rng`` None) a decoder layer takes the kernels of the JAX package's
XLA-decoder route (``msmd_tpu/models/transformer.py``:400-423):

- ``fused_ffn``: the FFN block LN(x + FFN(x)) is K6
  (``ops/kernels/ffn.py``; tanh GELU at bf16, where ``FeedForward`` is erf);
- ``attn_kernel``: the unmasked self-attention between the fused q/k/v
  product and the out-projection is K8 (``ops/kernels/attn.py``), the
  port's spelling of ``MSMD_ATTN_KERNEL=1``;
- ``fused_tail`` (with the identity band and a memory K/V cache): the
  self-attention stays plain up to its out-projection, the person rows
  take plain ops, and everything after that for the motion rows is K9
  (``ops/kernels/layer_tail.py``; erf GELU), the port's spelling of
  ``MSMD_FUSED_TAIL=1``. It takes the place of the whole layer, so
  ``attn_kernel`` and ``fused_ffn`` have no effect under it.

K6 and K9 take their weights as their modules' ``prepare_*_weights`` make
them (the f32 LayerNorm parameters, K9's stacked into tables, and the
weights' tensor maps; the weights themselves are the parameters, which
``sample`` has made bf16). A layer makes them once and keeps them until
one of the parameters changes (its data pointer or its version), so the
4000 K6 or K9 calls of a guided window cast none of the kernel's weights.

The JAX package keeps its flax or XLA ops where a TPU tile does not fit:
no row tile of at most 2048 dividing the rows (K6 and K7,
``msmd_tpu/models/transformer.py``:274 and :307; K9,
``msmd_tpu/models/diffusion.py``:648) or no 8-aligned tile of whole
entries (K8, ``attn_middle_viable``, :177). Those are VMEM and sublane
limits, not semantics, and the port's kernels take any row count, so the
port has no such fallback. The two packages then take different routes
where JAX's gate closes: for K6 and K9 at row counts above 2048 with no
divisor that is a multiple of 16 up to 512 (Be x lq = 96 x 111 = 10656
has 288, so JAX takes K6 at the guided batch-48 shapes; 37 x 111 = 4107
has none, so JAX keeps XLA there and the port runs K6); for K8 where no
tile of up to 8 entries divides B with an 8-aligned row count: at the
odd lq = 111, every B that is not a multiple of 8 (batch 1 with two CFG
entries, B = 2: JAX keeps XLA, the port runs K8), and in the style
encoders (``attn_kernel`` of ``models/style_encoder.py``) at a clip length
that is not a multiple of 8 over a batch with no such tile (the 100-frame
clip of ``inference.py`` at batch 1: JAX keeps XLA, the port runs K8).

The port has one gate of its own, ``attn_kernel_takes``
(``ops/kernels/attn.py``): K8 takes at most ``MAX_LQ`` = 256 rows an entry,
so a longer self-attention (a style clip over 10 s) takes the plain
attention with ``attn_kernel`` on. The route is chosen from the shape
before any launch, as JAX's ``attn_middle_viable`` chooses XLA, and the
launch counter shows it (no K8 launch).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from msmd_tpu_torch.models.layers import Dense, LayerNorm, dropout, gelu, in_dtype, uniform
from msmd_tpu_torch.ops.kernels.attn import attention_middle, attn_kernel_takes
from msmd_tpu_torch.ops.kernels.ffn import fused_ffn_ln, prepare_ffn_weights
from msmd_tpu_torch.ops.kernels.ffn_train import fused_ffn_ln_train
from msmd_tpu_torch.ops.kernels.layer_tail import fused_layer_tail, prepare_tail_weights
from msmd_tpu_torch.parallel.tp import copy_to_group

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
        # a tensor-parallel shard holds n_heads / tp of the heads
        return t.reshape(t.shape[0], t.shape[1], -1, self.head_dim)

    def project_kv(self, kv_input: torch.Tensor) -> KVCache:
        """K/V projections of a fixed memory."""
        return self._heads(self.k_proj(kv_input)), self._heads(self.v_proj(kv_input))

    def _scale(self) -> float:
        """1 / sqrt(head_dim) rounded to the compute dtype, as a Python
        number: a tensor made on the card would be a blocking copy."""
        return in_dtype(1.0 / math.sqrt(self.head_dim), self.dtype)

    def _fused_qkv(self, x: torch.Tensor):
        """q, k and v of a self-attention as one (F, 3F) product with the
        same parameters (``msmd_tpu/models/transformer.py``:71-83): three
        column slices of one (B, L, 3F) tensor."""
        dt, tp = self.dtype, self.q_proj.tp
        w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]).to(dt)
        b = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]).to(dt)
        if tp is not None:  # three column shards of one input
            x = copy_to_group(x, tp)
        return (torch.nn.functional.linear(x.to(dt), w) + b).split(self.q_proj.out_features, dim=-1)

    def _attend(self, qh, kh, vh, mask=None, rng: Rng = None) -> torch.Tensor:
        """Scaled-dot-product attention of (B, L, H, Dh) heads, merged to
        (B, Lq, F), before the out-projection."""
        logits = torch.einsum("bqhd,bkhd->bhqk", qh * self._scale(), kh.to(self.dtype))
        if mask is not None:
            logits = logits.masked_fill(mask.to(logits.device), torch.finfo(torch.float32).min)
        weights = dropout(_softmax_f32(logits, self.dtype), self.dropout, rng, self.q_proj.tp, dim=1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, vh.to(self.dtype))
        return out.reshape(qh.shape[0], qh.shape[1], -1)

    def self_attn_preproj(self, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode, unmasked self-attention without its out-projection
        (``msmd_tpu/models/transformer.py``:123-137), which K9 absorbs."""
        qp, kp, vp = self._fused_qkv(x)
        return self._attend(self._heads(qp), self._heads(kp), self._heads(vp))

    def person_attend(self, q0: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, rng: Rng = None) -> torch.Tensor:
        """The person row's cross-attention over the whole memory (the one
        row that attends under the width-1 band), before the out-projection:
        q0 (B, 1, F) -> (B, 1, F)."""
        return self._attend(self._heads(self.q_proj(q0)), kh, vh, rng=rng)

    def _identity_band(self, q: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, rng: Rng) -> torch.Tensor:
        B, Lq, _ = q.shape
        person = self.person_attend(q[:, :1], kh, vh, rng).reshape(B, 1, -1, self.head_dim)
        motion = vh.to(self.dtype)
        if rng is not None and self.dropout > 0.0:
            keep = uniform((B, kh.shape[1], vh.shape[2], 1), rng, q.device, self.q_proj.tp, dim=2) \
                < 1.0 - self.dropout
            motion = motion * keep.to(self.dtype) / in_dtype(1.0 - self.dropout, self.dtype)
        out = torch.cat([person, motion], dim=1)
        return self.out_proj(out.reshape(B, Lq, -1))

    def forward(
        self,
        q: torch.Tensor,
        k: Optional[torch.Tensor] = None,
        v: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        kv_cache: Optional[KVCache] = None,
        identity_band: bool = False,
        rng: Rng = None,
        attn_kernel: bool = False,
    ) -> torch.Tensor:
        """Attention of q over k, v (self-attention when both are None).
        ``attn_kernel``: an unmasked eval-mode self-attention runs its
        middle through K8 where ``attn_kernel_takes`` its shape."""
        Lq = q.shape[1]
        if kv_cache is None and k is None and v is None and not identity_band:
            qp, kp, vp = self._fused_qkv(q)
            heads = qp.shape[-1] // self.head_dim  # a tensor-parallel shard's heads
            if attn_kernel and mask is None and rng is None and attn_kernel_takes(q.shape[0], Lq, qp.shape[-1],
                                                                                 heads):
                return self.out_proj(attention_middle(qp, kp, vp, heads))
            return self.out_proj(self._attend(self._heads(qp), self._heads(kp), self._heads(vp), mask, rng))
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
        return self.out_proj(self._attend(self._heads(self.q_proj(q)), kh, vh, mask, rng))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Dense(dim, hidden_dim, dtype=dtype)
        self.linear2 = Dense(hidden_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, rng: Rng = None) -> torch.Tensor:
        return self.linear2(dropout(gelu(self.linear1(x)), self.dropout, rng, self.linear1.tp))


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
        self._kernel_weights = {}  # name -> (parameter state, prepared weights)

    def __getstate__(self):
        # a copy's parameters are other tensors, and the prepared weights'
        # tensor maps (ctypes pointers) cannot be copied: it prepares its own
        state = dict(super().__getstate__())
        state["_kernel_weights"] = {}
        return state

    def _prepared(self, name: str, params, prepare):
        """``prepare(*params)``, made again only when a parameter's data
        pointer or version has changed since the last call."""
        key = tuple((p.data_ptr(), p._version) for p in params)
        hit = self._kernel_weights.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, prepare(*params))
            self._kernel_weights[name] = hit
        return hit[1]

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

    def _fused_ffn_ln(self, x: torch.Tensor) -> torch.Tensor:
        """LN(x + FFN(x)) through K6 (``_fused_ffn_ln`` of the JAX layer)."""
        l1, l2 = self.ffn.linear1, self.ffn.linear2
        weights = self._prepared("k6", (l1.weight, l1.bias, l2.weight, l2.bias, self.norm3.weight, self.norm3.bias),
                                 lambda *p: prepare_ffn_weights(*p, dtype=self.dtype))
        return fused_ffn_ln(x, *weights)

    def _fused_tail(self, x: torch.Tensor, kv_cache: KVCache) -> torch.Tensor:
        """The layer under the width-1 band in eval mode (``_fused_tail`` of
        the JAX layer, ``msmd_tpu/models/transformer.py``:325-380): plain
        self-attention up to its out-projection; the person rows through
        the plain modules; the motion rows' tail through K9."""
        B, Lq, F = x.shape
        dt = self.dtype
        sa_pre = self.self_attn.self_attn_preproj(x)
        x1_p = self.norm1(x[:, :1] + self.self_attn.out_proj(sa_pre[:, :1]))
        kh, vh = kv_cache
        x2_p = self.norm2(x1_p + self.cross_attn.out_proj(self.cross_attn.person_attend(x1_p, kh, vh)))
        out_p = self.norm3(x2_p + self.ffn(x2_p))

        so, co, l1, l2 = self.self_attn.out_proj, self.cross_attn.out_proj, self.ffn.linear1, self.ffn.linear2
        norms = (self.norm1, self.norm2, self.norm3)
        params = (so.weight, so.bias, co.weight, co.bias, l1.weight, l1.bias, l2.weight, l2.bias,
                  *(n.weight for n in norms), *(n.bias for n in norms))
        weights = self._prepared("k9", params, lambda *p: prepare_tail_weights(*p[:8], p[8:11], p[11:], dtype=dt))
        out_m = fused_layer_tail(sa_pre[:, 1:].contiguous(), x[:, 1:].contiguous(),
                                 vh.reshape(B * kh.shape[1], F).to(dt), *weights)
        return torch.cat([out_p.to(out_m.dtype), out_m], dim=1)

    def forward(self, x, memory=None, memory_mask=None, memory_kv: Optional[KVCache] = None,
                cross_identity_band: bool = False, rng: Rng = None, fused_ffn_train: bool = False,
                fused_ffn: bool = False, fused_tail: bool = False, attn_kernel: bool = False):
        if fused_tail and rng is None and cross_identity_band and memory_kv is not None:
            return self._fused_tail(x, memory_kv)
        x = self.norm1(x + dropout(self.self_attn(x, rng=rng, attn_kernel=attn_kernel), self.dropout, rng))
        ca = self.cross_attn(x, memory, memory, mask=memory_mask, kv_cache=memory_kv,
                             identity_band=cross_identity_band, rng=rng)
        x = self.norm2(x + dropout(ca, self.dropout, rng))
        if fused_ffn and rng is None:
            return self._fused_ffn_ln(x)
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
                cross_identity_band: bool = False, rng: Rng = None, fused_ffn_train: bool = False,
                fused_ffn: bool = False, fused_tail: bool = False, attn_kernel: bool = False,
                remat: bool = False):
        """``remat`` (``remat_denoiser``): in a training forward that builds a
        graph, each layer is checkpointed (``_remat_layer``)."""
        remat = remat and rng is not None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            kv = memory_kv[i] if memory_kv is not None else None
            args = (memory, memory_mask, kv, cross_identity_band)
            flags = (fused_ffn_train, fused_ffn, fused_tail, attn_kernel)
            x = _remat_layer(layer, x, args, rng, flags) if remat else layer(x, *args, rng, *flags)
        return x


def _remat_layer(layer: nn.Module, x: torch.Tensor, args, rng: torch.Generator, flags) -> torch.Tensor:
    """One decoder layer under ``torch.utils.checkpoint`` (the port of
    ``nn.remat`` of each layer, ``msmd_tpu/models/transformer.py``:438-475):
    its activations are recomputed in the backward instead of kept. The
    layer's dropout masks and K7's seed come from ``rng``, which checkpoint
    does not restore, so the layer draws from a copy of ``rng``'s state
    taken before the call, in the forward and again in the recompute, and
    ``rng`` then moves on as far as the layer drew: the recompute draws the
    same masks, and the draws after the layer are those without remat."""
    from torch.utils.checkpoint import checkpoint

    state, used = rng.get_state(), []

    def run(x_):
        g = torch.Generator(device=rng.device)
        g.set_state(state)
        used.append(g)
        return layer(x_, *args, g, *flags)

    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    rng.set_state(used[0].get_state())
    return out


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (torch ``nn.TransformerEncoderLayer``, gelu)."""

    def __init__(self, dim: int, n_heads: int, ffn_dim: int, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(dim, n_heads, dtype, dropout)
        self.ffn = FeedForward(dim, ffn_dim, dtype, dropout)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, rng: Rng = None,
                attn_kernel: bool = False) -> torch.Tensor:
        """``attn_kernel``: the eval-mode, unmasked self-attention's middle
        through K8 (``MultiHeadAttention.forward``)."""
        sa = self.self_attn(x, mask=mask, rng=rng, attn_kernel=attn_kernel)
        x = self.norm1(x + dropout(sa, self.dropout, rng))
        return self.norm2(x + dropout(self.ffn(x, rng), self.dropout, rng))
