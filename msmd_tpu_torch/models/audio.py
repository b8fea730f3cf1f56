"""wav2vec2 / HuBERT-base audio encoder (the port of
``msmd_tpu/models/audio.py``; reference: utils/wav2vec2.py:66-119,
utils/hubert.py:9-51), and WavLM (Chen et al., arXiv:2110.13900; the
layout of HF's ``WavLMModel``), which the JAX package does not have.

The strided conv stack turns 16 kHz audio into 50 Hz features; they are
truncated to ``round(frame_num * 50 / output_fps)`` frames, resampled
linearly to ``frame_num``, projected, and run through a post-LN encoder
with a grouped positional convolution. With a ``torch.Generator`` as
``rng`` (training) dropout 0.1 runs in the feature projection and the
encoder (frozen layers included, as in the JAX package) and SpecAugment
replaces random time spans with the trained ``masked_spec_embed``.
``audio_param_trainable`` is the reference's freezing policy.

WavLM's layout (``AudioEncoderConfig``'s layout fields): a LayerNorm over
channels after every convolution ("layer"), convolution biases where
``conv_bias``, pre-LN layers with a final LayerNorm and none before the
first (``do_stable_layer_norm``), and the gated relative-position
attention (``num_buckets`` > 0): layer 0 holds the bucket table E
(``rel_attn_embed``, buckets x heads), from which the encoder gathers the
heads' table of offsets r (H, 2L - 1) once a call; each layer gates it
per query row from its own normalised input u (``gru_rel_pos_linear``,
``gru_rel_pos_const``), in f32, and runs K10
(``ops/kernels/relpos_attn.py``). The pre-LN residual stream is kept in
f32. Dropout sits where the HuBERT layers have it (after the projection,
the positional sum, the attention's output projection, the FFN's hidden
state and its output). Departures from HF's WavLM: no dropout on the
attention probabilities (HF's ``attention_dropout``) and no LayerDrop.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from msmd_tpu_torch.config import AudioEncoderConfig
from msmd_tpu_torch.models.layers import Conv1d, Dense, LayerNorm, dropout, gelu, in_dtype
from msmd_tpu_torch.ops.kernels.relpos_attn import relpos_attention
from msmd_tpu_torch.ops.seq import linear_interpolate
from msmd_tpu_torch.utils.profiling import count, span


class GroupNormPerChannel(nn.GroupNorm):
    """GroupNorm with one channel per group on channels-last (N, T, C),
    statistics over time in float32."""

    def __init__(self, channels: int, eps: float, dtype=torch.float32):
        super().__init__(channels, channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps) * self.weight.float() + self.bias.float()
        return y.to(self.compute_dtype)


class ConvFeatureExtractor(nn.Module):
    """Strided conv stack, 16 kHz waveform (N, L) -> (N, T50, C); GELU
    after every layer. The "group" layout: a per-channel GroupNorm after
    layer 0; the "layer" layout: a LayerNorm over channels after every
    layer (``layer_norm``)."""

    def __init__(self, c: AudioEncoderConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        dims_in = (1,) + tuple(c.conv_dim[:-1])
        self.conv = nn.ModuleList(
            Conv1d(i, o, k, stride=s, bias=c.conv_bias, dtype=dtype)
            for i, o, k, s in zip(dims_in, c.conv_dim, c.conv_kernel, c.conv_stride)
        )
        self.norm_each = c.feat_extract_norm == "layer"
        if self.norm_each:
            self.layer_norm = nn.ModuleList(LayerNorm(o, c.layer_norm_eps, dtype) for o in c.conv_dim)
        else:
            self.group_norm = GroupNormPerChannel(c.conv_dim[0], c.layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[..., None].to(self.dtype)
        for i, conv in enumerate(self.conv):
            h = conv(h)
            if self.norm_each:
                h = self.layer_norm[i](h)
            elif i == 0:
                h = self.group_norm(h)
            h = gelu(h)
        return h


class FeatureProjection(nn.Module):
    def __init__(self, c: AudioEncoderConfig, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = LayerNorm(c.conv_dim[-1], c.layer_norm_eps, dtype)
        self.projection = Dense(c.conv_dim[-1], c.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        return dropout(self.projection(self.layer_norm(x)), self.dropout, rng)


class PositionalConvEmbedding(nn.Module):
    """Grouped positional conv (kernel 128, 16 groups), 'same' padding
    with the trailing element dropped for an even kernel."""

    def __init__(self, c: AudioEncoderConfig, dtype=torch.float32):
        super().__init__()
        k = c.num_conv_pos_embeddings
        self.even = k % 2 == 0
        self.conv = Conv1d(c.hidden_size, c.hidden_size, k, padding=k // 2,
                           groups=c.num_conv_pos_embedding_groups, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        if self.even:
            h = h[:, :-1]
        return gelu(h)


class AudioEncoderLayer(nn.Module):
    """Post-LN encoder layer in the HF base layout."""

    def __init__(self, c: AudioEncoderConfig, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.c, self.dtype, self.dropout = c, dtype, dropout
        H = c.hidden_size
        self.q_proj = Dense(H, H, dtype=dtype)
        self.k_proj = Dense(H, H, dtype=dtype)
        self.v_proj = Dense(H, H, dtype=dtype)
        self.out_proj = Dense(H, H, dtype=dtype)
        self.layer_norm = LayerNorm(H, c.layer_norm_eps, dtype)
        self.intermediate_dense = Dense(H, c.intermediate_size, dtype=dtype)
        self.output_dense = Dense(c.intermediate_size, H, dtype=dtype)
        self.final_layer_norm = LayerNorm(H, c.layer_norm_eps, dtype)

    @property
    def n_heads(self) -> int:
        return self.c.num_heads

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        c, p = self.c, self.dropout
        B, L, _ = x.shape
        hd = c.hidden_size // c.num_heads
        split = lambda t: t.reshape(B, L, -1, hd)  # a tensor-parallel shard holds num_heads / tp heads
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scale = in_dtype(hd ** -0.5, self.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
        sm_dt = torch.promote_types(logits.dtype, torch.float32)
        weights = torch.softmax(logits.to(sm_dt), dim=-1).to(self.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, L, -1)
        x = self.layer_norm(x + dropout(self.out_proj(attn), p, rng))
        h = self.output_dense(dropout(gelu(self.intermediate_dense(x)), p, rng, self.intermediate_dense.tp))
        return self.final_layer_norm(x + dropout(h, p, rng))


def relative_bucket(offset: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """WavLM's bucket of a key's offset j - i from its query (HF's
    ``WavLMAttention._relative_positions_bucket``): num_buckets / 2 a
    side, positive offsets in the upper half; exact below a quarter of
    num_buckets, log-spaced up to ``max_distance``, the last bucket past
    it."""
    half = num_buckets // 2
    exact = half // 2
    out = (offset > 0).long() * half
    a = offset.abs()
    far = exact + (torch.log(a.float() / exact) / math.log(max_distance / exact) * (half - exact)).long()
    return out + torch.where(a < exact, a, far.clamp(max=half - 1))


_BUCKETS: Dict[tuple, torch.Tensor] = {}


def offset_buckets(L: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """The bucket of each offset -(L - 1) .. L - 1 (2L - 1 int64), cached
    per length and device."""
    key = (L, num_buckets, max_distance, str(device))
    if key not in _BUCKETS:
        d = torch.arange(-(L - 1), L)
        _BUCKETS[key] = relative_bucket(d, num_buckets, max_distance).to(device)
    return _BUCKETS[key]


class _TableGather(torch.autograd.Function):
    """r = E[bucket].T (H, 2L - 1) from the table E (buckets, H); the
    backward scatters dr to dE by bucket as a float64 one-hot product,
    which sums in a fixed order (``index_add_`` adds with atomics on the
    card)."""

    @staticmethod
    def forward(ctx, table, buckets):
        ctx.save_for_backward(buckets)
        ctx.n = table.shape[0]
        return table.float().index_select(0, buckets).t().contiguous()

    @staticmethod
    def backward(ctx, dr):
        (buckets,) = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(buckets, ctx.n).double()
        return (onehot.t() @ dr.t().double()).float(), None


class WavLMEncoderLayer(nn.Module):
    """Pre-LN WavLM layer: x + Drop(Attn(LN1(x))), then x + Drop(FFN(LN2(x)))
    with the gated relative-position attention (K10); layer 0 also holds
    the bucket table ``rel_attn_embed``. The residual stream is f32."""

    def __init__(self, c: AudioEncoderConfig, index: int, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.c, self.dtype, self.dropout = c, dtype, dropout
        H = c.hidden_size
        hd = H // c.num_heads
        self.q_proj = Dense(H, H, dtype=dtype)
        self.k_proj = Dense(H, H, dtype=dtype)
        self.v_proj = Dense(H, H, dtype=dtype)
        self.out_proj = Dense(H, H, dtype=dtype)
        self.layer_norm = LayerNorm(H, c.layer_norm_eps, dtype)
        self.intermediate_dense = Dense(H, c.intermediate_size, dtype=dtype)
        self.output_dense = Dense(c.intermediate_size, H, dtype=dtype)
        self.final_layer_norm = LayerNorm(H, c.layer_norm_eps, dtype)
        self.gru_rel_pos_linear = Dense(hd, 8, dtype=torch.float32)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(c.num_heads))
        if index == 0:
            self.rel_attn_embed = nn.Parameter(torch.randn(c.num_buckets, c.num_heads))

    def gate(self, u: torch.Tensor) -> torch.Tensor:
        """g (B, H, L) f32 from the normalised input u (B, L, hidden):
        sigmoid(a) (sigmoid(b) c_h - 1) + 2, with (a, b) the sums of the
        two groups of four of u_h's projection to 8."""
        B, L, _ = u.shape
        proj = self.gru_rel_pos_linear(u.float().reshape(B, L, self.c.num_heads, -1))
        a, b = torch.sigmoid(proj.reshape(B, L, self.c.num_heads, 2, 4).sum(-1)).unbind(-1)
        return (a * (b * self.gru_rel_pos_const - 1.0) + 2.0).transpose(1, 2).contiguous()

    def forward(self, x: torch.Tensor, r: torch.Tensor, rng=None) -> torch.Tensor:
        c, p = self.c, self.dropout
        if self.q_proj.tp is not None:
            raise NotImplementedError("tensor parallelism does not shard WavLM's relative-position attention")
        B, L, _ = x.shape
        split = lambda t: t.reshape(B, L, c.num_heads, -1)
        u = self.layer_norm(x)
        with span("msmd.audio_encoder.rel_bias"):
            g = self.gate(u)
        q, k, v = split(self.q_proj(u)), split(self.k_proj(u)), split(self.v_proj(u))
        a = relpos_attention(q, k, v, g, r).reshape(B, L, -1)
        x = x + dropout(self.out_proj(a), p, rng).float()
        h = self.output_dense(dropout(gelu(self.intermediate_dense(self.final_layer_norm(x))), p, rng))
        return x + dropout(h, p, rng).float()


class AudioTransformerEncoder(nn.Module):
    """The post-LN encoder (LayerNorm after the positional sum, post-LN
    layers), or with ``do_stable_layer_norm`` the pre-LN one (no LayerNorm
    before the layers, one after them); WavLM's layers where
    ``num_buckets`` > 0."""

    def __init__(self, c: AudioEncoderConfig, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.c, self.dropout = c, dropout
        self.pos_conv_embed = PositionalConvEmbedding(c, dtype)
        self.layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        if c.relative_position:
            if not c.do_stable_layer_norm:
                raise ValueError("the relative-position attention is WavLM's, whose layers are pre-LN "
                                 "(do_stable_layer_norm)")
            self.layers = nn.ModuleList(WavLMEncoderLayer(c, i, dtype, dropout) for i in range(c.num_layers))
        elif c.do_stable_layer_norm:
            raise ValueError("the port's pre-LN encoder layers are WavLM's: set num_buckets")
        else:
            self.layers = nn.ModuleList(AudioEncoderLayer(c, dtype, dropout) for _ in range(c.num_layers))

    def offset_table(self, L: int) -> torch.Tensor:
        """The heads' table of offsets r (H, 2L - 1) f32 from layer 0's
        bucket table, once an encoder call."""
        c = self.c
        E = self.layers[0].rel_attn_embed
        count("msmd.wavlm.bias_tables")
        return _TableGather.apply(E, offset_buckets(L, c.num_buckets, c.max_bucket_distance, E.device))

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        if not self.c.do_stable_layer_norm:
            x = dropout(self.layer_norm(x + self.pos_conv_embed(x)), self.dropout, rng)
            for layer in self.layers:
                x = layer(x, rng)
            return x
        x = dropout(x.float() + self.pos_conv_embed(x).float(), self.dropout, rng)
        with span("msmd.audio_encoder.rel_bias"):
            r = self.offset_table(x.shape[1])
        with span("msmd.audio_encoder.layers"):
            for layer in self.layers:
                x = layer(x, r, rng)
        return self.layer_norm(x)


def sample_time_masks(rng: torch.Generator, batch_size: int, seq_len: int, mask_prob: float,
                      mask_length: int) -> torch.Tensor:
    """SpecAugment spans (``msmd_tpu/models/audio.py``:191-199): the
    reference's expected span count (utils/wav2vec2.py:17-53) with uniform
    starts. Returns a (B, L) bool mask on ``rng``'s device, True = masked."""
    num_spans = max(2, int(mask_prob * seq_len / float(mask_length) + 0.5))
    starts = torch.randint(0, max(1, seq_len - mask_length), (batch_size, num_spans), generator=rng,
                           device=rng.device)
    pos = torch.arange(seq_len, device=rng.device)[None, None, :]
    spans = (pos >= starts[..., None]) & (pos < starts[..., None] + mask_length)
    return spans.any(dim=1)


class AudioEncoder(nn.Module):
    """The full encoder with the MSMD resampling head; wav2vec2 and
    hubert share the base layout, wavlm takes the layout fields of its
    config (``WAVLM_LARGE``)."""

    def __init__(self, config: Optional[AudioEncoderConfig] = None, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        c = config or AudioEncoderConfig()
        self.config = c
        self.feature_extractor = ConvFeatureExtractor(c, dtype)
        self.feature_projection = FeatureProjection(c, dtype, dropout)
        if c.apply_spec_augment and c.mask_time_prob > 0:
            self.masked_spec_embed = nn.Parameter(torch.zeros(c.hidden_size))
        self.encoder = AudioTransformerEncoder(c, dtype, dropout)

    def forward(self, input_values: torch.Tensor, output_fps: int = 25,
                frame_num: Optional[int] = None, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.config
        # the WavLM layout's sub-spans; the base layout's traces keep the spans they had
        with span("msmd.audio_encoder.features") if c.relative_position else contextlib.nullcontext():
            feats = self.feature_extractor(input_values)  # (N, T50, C)
        if frame_num is not None:
            keep = round(frame_num * 50 / output_fps)
            feats = feats[:, :keep]
            feats = linear_interpolate(feats.transpose(1, 2), frame_num).transpose(1, 2)
        hidden = self.feature_projection(feats, rng)
        if rng is not None and c.apply_spec_augment and c.mask_time_prob > 0:
            mask = sample_time_masks(rng, hidden.shape[0], hidden.shape[1], c.mask_time_prob,
                                     c.mask_time_length).to(hidden.device)
            hidden = torch.where(mask[..., None], self.masked_spec_embed.to(hidden.dtype), hidden)
        return self.encoder(hidden, rng)


def audio_param_trainable(audio_model: str, name: str) -> bool:
    """The reference freezing policy (model.py:93-110,
    ``msmd_tpu/models/audio.py``:264-278) on a parameter name of the audio
    encoder (``feature_extractor.conv.0.weight``, ``encoder.layers.1.q_proj.bias``):
    both backends freeze the conv feature extractor; hubert also freezes the
    feature projection and encoder layers 0-1."""
    parts: Tuple[str, ...] = tuple(name.split("."))
    if parts[0] == "feature_extractor":
        return False
    if audio_model == "hubert":
        if parts[0] == "feature_projection":
            return False
        if parts[:2] == ("encoder", "layers") and parts[2] in ("0", "1"):
            return False
    return True
