"""wav2vec2 / HuBERT-base audio encoder (the port of
``msmd_tpu/models/audio.py``; reference: utils/wav2vec2.py:66-119,
utils/hubert.py:9-51).

The strided conv stack turns 16 kHz audio into 50 Hz features; they are
truncated to ``round(frame_num * 50 / output_fps)`` frames, resampled
linearly to ``frame_num``, projected, and run through a post-LN encoder
with a grouped positional convolution. With a ``torch.Generator`` as
``rng`` (training) dropout 0.1 runs in the feature projection and the
encoder (frozen layers included, as in the JAX package) and SpecAugment
replaces random time spans with the trained ``masked_spec_embed``.
``audio_param_trainable`` is the reference's freezing policy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from msmd_tpu_torch.config import AudioEncoderConfig
from msmd_tpu_torch.models.layers import Conv1d, Dense, LayerNorm, dropout, gelu, in_dtype
from msmd_tpu_torch.ops.seq import linear_interpolate


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
    """Strided conv stack, 16 kHz waveform (N, L) -> (N, T50, C); the
    "group"-norm layout: per-channel GroupNorm after layer 0, GELU after
    every layer."""

    def __init__(self, c: AudioEncoderConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        dims_in = (1,) + tuple(c.conv_dim[:-1])
        self.conv = nn.ModuleList(
            Conv1d(i, o, k, stride=s, bias=False, dtype=dtype)
            for i, o, k, s in zip(dims_in, c.conv_dim, c.conv_kernel, c.conv_stride)
        )
        self.group_norm = GroupNormPerChannel(c.conv_dim[0], c.layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[..., None].to(self.dtype)
        for i, conv in enumerate(self.conv):
            h = conv(h)
            if i == 0:
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


class AudioTransformerEncoder(nn.Module):
    def __init__(self, c: AudioEncoderConfig, dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.pos_conv_embed = PositionalConvEmbedding(c, dtype)
        self.layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.layers = nn.ModuleList(AudioEncoderLayer(c, dtype, dropout) for _ in range(c.num_layers))

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        x = dropout(self.layer_norm(x + self.pos_conv_embed(x)), self.dropout, rng)
        for layer in self.layers:
            x = layer(x, rng)
        return x


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
    hubert share this architecture."""

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
