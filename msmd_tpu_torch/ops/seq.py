"""Sequence utilities: sinusoidal tables, alignment masks, audio padding
and linear feature resampling (the port of ``msmd_tpu/ops/seq.py``;
reference: utils/model_common.py:86-123, utils/wav2vec2.py:57-63).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def sinusoidal_table(d_model: int, max_len: int = 600, dtype=torch.float32, device=None) -> torch.Tensor:
    """Vanilla sinusoidal positional-encoding table ``(max_len, d_model)``
    (reference: utils/model_common.py:89-97), built in float32 NumPy.
    Cached per device: copying it to the card at every call would make the
    host wait for the card (a blocking copy), many times per step. The
    result is shared; do not write to it."""
    return _sinusoidal_table(d_model, max_len, dtype, torch.device(device) if device is not None else None)


@functools.lru_cache(maxsize=None)
def _sinusoidal_table(d_model: int, max_len: int, dtype, device) -> torch.Tensor:
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.as_tensor(pe, device=device).to(dtype)


def apply_pe_single_row(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The reference PositionalEncoding forward exactly: it adds
    ``pe[:, x.shape[1], :]``, the single row indexed by the sequence
    length, to every position (reference: utils/model_common.py:100, a
    released quirk kept for checkpoint parity). x: (N, L, d_model)."""
    return x + table[x.shape[1]][None, None, :]


def enc_dec_mask(T: int, S: int, frame_width: int = 2, expansion: int = 0) -> torch.Tensor:
    """Banded audio/motion cross-attention mask, True = masked
    (reference: utils/model_common.py:103-107)."""
    rows = np.arange(T)[:, None]
    cols = np.arange(S)[None, :]
    lo = np.maximum(0, (rows - expansion) * frame_width)
    hi = (rows + expansion + 1) * frame_width
    allowed = (cols >= lo) & (cols < hi)
    return torch.as_tensor(~allowed)


def alignment_mask(n_prev_motions: int, n_motions: int, align_mask_width: int) -> torch.Tensor:
    """The denoiser's memory mask: a width-``align_mask_width`` band over
    the (L_p+L, L_p+L) grid with an unmasked person row prepended
    (reference: model.py:879-883). Bool (1 + L_p + L, L_p + L)."""
    motion_len = n_prev_motions + n_motions
    band = enc_dec_mask(motion_len, motion_len, 1, align_mask_width - 1)
    person_row = torch.zeros((1, motion_len), dtype=torch.bool)
    return torch.cat([person_row, band], dim=0)


def pad_audio(audio: torch.Tensor, audio_unit: int = 320, pad_threshold: int = 80) -> torch.Tensor:
    """Symmetric padding so the strided conv stack emits enough 50 Hz
    frames: reflect ``side_len // 2`` twice per side, plus one replicate
    sample when ``side_len`` is odd (reference: utils/model_common.py:110-123).
    audio: (N, L)."""
    audio_len = audio.shape[1]
    n_units = audio_len // audio_unit
    side_len = math.ceil((audio_unit * n_units + pad_threshold - audio_len) / 2)
    if side_len >= 0:
        reflect_len = side_len // 2
        replicate_len = side_len % 2
        x = audio[:, None, :]
        if reflect_len > 0:
            x = F.pad(x, (reflect_len, reflect_len), mode="reflect")
            x = F.pad(x, (reflect_len, reflect_len), mode="reflect")
        if replicate_len > 0:
            x = F.pad(x, (1, 1), mode="replicate")
        audio = x[:, 0]
    return audio


def linear_interpolate(features: torch.Tensor, output_len: int) -> torch.Tensor:
    """Length-wise linear resampling of (N, C, L) to (N, C, output_len),
    ``F.interpolate(mode='linear', align_corners=False)`` semantics. The
    source coordinates are computed in float32 exactly as the JAX
    package computes them, so both packages pick the same lerp weights."""
    in_len = features.shape[-1]
    if output_len == in_len:
        return features
    w, i0, i1 = _lerp_table(in_len, output_len, features.dtype, features.device)
    f0 = features[..., i0]
    f1 = features[..., i1]
    return f0 + (f1 - f0) * w


@functools.lru_cache(maxsize=None)
def _lerp_table(in_len: int, output_len: int, dtype, device):
    """(weights, left index, right index) of ``linear_interpolate``, cached
    per device like ``sinusoidal_table``."""
    scale = np.float32(in_len / output_len)
    src = (np.arange(output_len, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    src = np.clip(src, np.float32(0.0), np.float32(in_len - 1))
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_len - 1)
    w = torch.as_tensor(src - i0.astype(np.float32), device=device).to(dtype)
    return w, torch.as_tensor(i0, device=device), torch.as_tensor(i1, device=device)


def linear_interpolation_fps(features: torch.Tensor, input_fps: int, output_fps: int, output_len=None) -> torch.Tensor:
    """FPS-style wrapper over :func:`linear_interpolate`
    (reference: utils/wav2vec2.py:57-63)."""
    if output_len is None:
        output_len = int(features.shape[2] / float(input_fps) * output_fps)
    return linear_interpolate(features, output_len)
