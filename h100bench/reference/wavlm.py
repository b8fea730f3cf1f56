"""A plain PyTorch reference of WavLM-Large as MSMD's speech encoder, written
from the published description (Chen et al., "WavLM: Large-Scale
Self-Supervised Pre-Training for Full Stack Speech Processing",
arXiv:2110.13900) and microsoft/wavlm-large's configuration, independent of
the program: it imports nothing of the port or of the JAX package.

The encoder: seven strided convolutions, each followed by a LayerNorm
over channels and GELU; the feature projection (LayerNorm, linear); the
grouped positional convolution added with no LayerNorm; pre-LN layers
``x + Attn(LN1(x))``, ``x + FFN(LN2(x))``; a final LayerNorm. Layer 0's
table E (buckets x heads) gives every layer the bias E[bucket(j - i), h],
gated per query row from the layer's own normalised input u:
``(a, b)`` are the sums of the two groups of four of ``u_h W_g + b_g``
(64 -> 8), ``g = sigmoid(a) (sigmoid(b) c_h - 1) + 2``, and the scores
are ``q_h k_h^T / sqrt(64) + g R_h``. The gate, the table and the softmax
are float32 always; the products take the ``Prec`` given.

Weights are read from the flat dict of the benchmark (``audio_encoder.*``
names as the benchmark loads them into the port). MSMD's head is the
HuBERT one of ``model.py``: the features of twice the motion frames,
truncated to ``round(2 n 50 / fps)`` and resampled to 2n before the
projection, the encoder's output resampled to n and mapped to the
denoiser's width. Departures from the published model, kept because the
program has them too: no dropout on the attention probabilities and no
LayerDrop in training.
"""

from __future__ import annotations

import math

import torch

from h100bench.reference import model as m
from h100bench.reference.precision import Prec
from h100bench.reference.train import P, dropout

PREFIX = "audio_encoder."


def bucket(offset: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """The bucket of a key at ``offset`` = j - i from its query: half the
    buckets a side (the later keys above), one bucket per offset below a
    quarter of the buckets, then logarithmic steps up to ``max_distance``,
    the side's last bucket beyond."""
    side = num_buckets // 2
    exact = side // 2
    a = offset.abs()
    steps = torch.log(a.float().clamp_min(1.0) / exact) / math.log(max_distance / exact) * (side - exact)
    far = torch.clamp(exact + steps.long(), max=side - 1)
    return (offset > 0).long() * side + torch.where(a < exact, a, far)


def position_table(w, L: int, arch: dict) -> torch.Tensor:
    """R (heads, L, L): layer 0's table at each pair's bucket."""
    pos = torch.arange(L)
    b = bucket(pos[None, :] - pos[:, None], arch["num_buckets"], arch["max_bucket_distance"])
    E = w[PREFIX + "encoder.layers.0.rel_attn_embed"].float()
    return E[b.to(E.device)].permute(2, 0, 1)


def gate(w, lp: str, u, heads: int) -> torch.Tensor:
    """g (N, heads, L) from a layer's normalised input u (N, L, hidden)."""
    N, L, _ = u.shape
    proj = torch.nn.functional.linear(u.float().reshape(N, L, heads, -1), w[lp + "gru_rel_pos_linear.weight"].float(),
                                      w[lp + "gru_rel_pos_linear.bias"].float())
    a, b = proj[..., :4].sum(-1), proj[..., 4:].sum(-1)
    g = torch.sigmoid(a) * (torch.sigmoid(b) * w[lp + "gru_rel_pos_const"].float() - 1.0) + 2.0
    return g.permute(0, 2, 1)


def layer(w, i: int, x, R, arch: dict, prec: Prec, g=None):
    """Encoder layer ``i`` (pre-LN) on the residual stream x (N, L, hidden);
    with a generator ``g``, dropout after the attention's output
    projection, the FFN's hidden state and its output."""
    lp = f"{PREFIX}encoder.layers.{i}."
    drop = (lambda t: t) if g is None else (lambda t: dropout(t, P, g))
    N, L, Hd = x.shape
    heads = arch["num_heads"]
    dh = Hd // heads
    u = m.layer_norm(w, lp + "layer_norm", x)
    q, k, v = (m.dense(w, lp + n, u, prec).reshape(N, L, heads, dh) for n in ("q_proj", "k_proj", "v_proj"))
    s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh) + gate(w, lp, u, heads)[..., None] * R[None]
    a = prec.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v).reshape(N, L, Hd)
    x = x + drop(m.dense(w, lp + "out_proj", a, prec))
    h = drop(m.gelu(m.dense(w, lp + "intermediate_dense", m.layer_norm(w, lp + "final_layer_norm", x), prec)))
    return x + drop(m.dense(w, lp + "output_dense", h, prec))


def front(w, audio, frame_num: int, fps: int, arch: dict, prec: Prec):
    """Padded 16 kHz audio (N, L) -> the conv front's features (N,
    frame_num, 512): every convolution (with its bias where the
    configuration has one) followed by a LayerNorm over channels and GELU,
    the first ``frame_num * 50 / fps`` frames resampled to ``frame_num``."""
    h = audio[:, None].float()
    for i, s in enumerate(arch["conv_stride"]):
        p = f"{PREFIX}feature_extractor."
        h = prec.conv1d(h, w[f"{p}conv.{i}.weight"], w.get(f"{p}conv.{i}.bias"), stride=s)
        h = m.gelu(m.layer_norm(w, f"{p}layer_norm.{i}", h.transpose(1, 2)).transpose(1, 2))
    return m.resample(h.transpose(1, 2)[:, :round(frame_num * 50 / fps)], frame_num)


def projection(w, h, prec: Prec):
    return m.dense(w, PREFIX + "feature_projection.projection",
                   m.layer_norm(w, PREFIX + "feature_projection.layer_norm", h), prec)


def pos_conv(w, h, arch: dict, prec: Prec):
    """The grouped positional convolution with GELU, 'same' length."""
    k = arch["num_conv_pos_embeddings"]
    pc = prec.conv1d(h.transpose(1, 2), w[PREFIX + "encoder.pos_conv_embed.conv.weight"],
                     w[PREFIX + "encoder.pos_conv_embed.conv.bias"], padding=k // 2,
                     groups=arch["num_conv_pos_embedding_groups"]).transpose(1, 2)
    return m.gelu(pc[:, :-1] if k % 2 == 0 else pc)


def encoder(w, h, arch: dict, prec: Prec, g=None):
    """The projected features (N, L, hidden) through the positional sum,
    the layers and the final LayerNorm (dropout after the sum with ``g``)."""
    x = h + pos_conv(w, h, arch, prec)
    if g is not None:
        x = dropout(x, P, g)
    R = position_table(w, x.shape[1], arch)
    for i in range(arch["num_layers"]):
        x = layer(w, i, x, R, arch, prec, g)
    return m.layer_norm(w, PREFIX + "encoder.layer_norm", x)


def wavlm(w, audio, frame_num: int, fps: int, arch: dict, prec: Prec):
    """Padded 16 kHz audio (N, L) -> (N, frame_num, hidden) in eval mode."""
    return encoder(w, projection(w, front(w, audio, frame_num, fps, arch, prec), prec), arch, prec)


def audio_features(w, audio, frame_num: int, fps: int, arch: dict, prec: Prec):
    """z-scored 16 kHz audio (N, L) -> (N, frame_num, feature_dim):
    WavLM at twice the frames, resampled, projected."""
    h = wavlm(w, m.pad_audio(audio.float()), 2 * frame_num, fps, arch, prec)
    return m.dense(w, "audio_feature_map", m.resample(h, frame_num), prec)


def audio_train(w, audio, frame_num: int, fps: int, arch: dict, g, prec: Prec):
    """``audio_features`` in training mode, making the program's draws in
    its order: dropout after the projection, SpecAugment's span starts,
    dropout after the positional sum, then each layer's three."""
    T2 = 2 * frame_num
    h = dropout(projection(w, front(w, m.pad_audio(audio.float()), T2, fps, arch, prec), prec), P, g)
    N, L = h.shape[:2]
    span = arch["mask_time_length"]
    n_spans = max(2, int(arch["mask_time_prob"] * L / float(span) + 0.5))
    starts = torch.randint(0, max(1, L - span), (N, n_spans), generator=g, device=g.device)
    pos = torch.arange(L, device=g.device)[None, None, :]
    masked = ((pos >= starts[..., None]) & (pos < starts[..., None] + span)).any(dim=1).to(h.device)
    h = torch.where(masked[..., None], w[PREFIX + "masked_spec_embed"], h)
    x = encoder(w, h, arch, prec, g)
    return m.dense(w, "audio_feature_map", m.resample(x, frame_num), prec)
