"""Motion clip -> style VAE encoder (the port of
``msmd_tpu/models/style_encoder.py``; reference: style_encoder.py:119-213).

``StyleEncoderVAE2``, the factory default: two (Conv1d k3, ELU,
LayerNorm) blocks, the sinusoidal PE with the single-row quirk, one
post-LN encoder layer (512 wide, 8 heads, FFN 512), an ELU conv head,
temporal mean-pool and a (mu, logvar) split.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msmd_tpu_torch.models.layers import Conv1d, LayerNorm
from msmd_tpu_torch.models.transformer import TransformerEncoderLayer
from msmd_tpu_torch.ops.seq import apply_pe_single_row, sinusoidal_table


def style_input_dim(dataset_type: str) -> int:
    if dataset_type[:9] == "HDTF_TFHP" or dataset_type == "flame_mead_ravdess":
        return 54
    return 67


class _ConvStem(nn.Module):
    """conv1d(k3, same) -> ELU -> LayerNorm, twice."""

    def __init__(self, in_dim: int, feature_dim: int, dtype=torch.float32):
        super().__init__()
        self.conv = nn.ModuleList([
            Conv1d(in_dim, feature_dim, 3, padding=1, dtype=dtype),
            Conv1d(feature_dim, feature_dim, 3, padding=1, dtype=dtype),
        ])
        self.norm = nn.ModuleList([LayerNorm(feature_dim, dtype=dtype) for _ in range(2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.conv, self.norm):
            x = norm(F.elu(conv(x)))
        return x


class StyleEncoderVAE2(nn.Module):
    """The production style encoder; names follow the JAX parameter tree
    (``input_layers``, ``encoder``, ``out_conv_{0,1}``, ``out_norm``)."""

    def __init__(self, d_style: int, input_dim: int = 67, conv_feature_dim: int = 512, dtype=torch.float32):
        super().__init__()
        self.d_style, self.dtype = d_style, dtype
        self.output_size = d_style * 2
        self.conv_feature_dim = conv_feature_dim
        self.input_layers = _ConvStem(input_dim, conv_feature_dim, dtype)
        self.encoder = TransformerEncoderLayer(conv_feature_dim, 8, conv_feature_dim, dtype)
        self.out_conv = nn.ModuleList([
            Conv1d(conv_feature_dim, self.output_size, 3, padding=1, dtype=dtype),
            Conv1d(self.output_size, self.output_size, 3, padding=1, dtype=dtype),
        ])
        self.out_norm = LayerNorm(self.output_size, dtype=dtype)

    def encode(self, motion_coef: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, T, input_dim) -> (mu, logvar), each (N, d_style)."""
        x = self.input_layers(motion_coef.to(self.dtype))
        table = sinusoidal_table(self.conv_feature_dim, 600, self.dtype, x.device)
        x = self.encoder(apply_pe_single_row(x, table))
        x = self.out_norm(F.elu(self.out_conv[0](x)))
        x = self.out_conv[1](x)
        out = x.mean(dim=1)
        return out[:, : self.d_style], out[:, self.d_style :]

    def forward(self, motion_coef: torch.Tensor):
        return self.encode(motion_coef)

    def encode_mean(self, motion_coef: torch.Tensor) -> torch.Tensor:
        """Posterior mean, the deterministic style embedding."""
        return self.encode(motion_coef)[0]

    def sample(self, motion_coef: torch.Tensor, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One reparameterised draw ``mu + eps * exp(logvar / 2)``. ``eps``
        may be given (tests hand both packages the same draw); otherwise
        it comes from ``generator``."""
        mu, logvar = self.encode(motion_coef)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=torch.float32)
        return mu + eps.to(device=mu.device, dtype=mu.dtype) * torch.exp(0.5 * logvar)


def get_style_encoder(cfg, dtype=torch.float32) -> StyleEncoderVAE2:
    """The factory's default, VAE2 (reference: style_encoder.py:7-12);
    the VAE is not ported yet."""
    return StyleEncoderVAE2(d_style=cfg.d_style, input_dim=style_input_dim(cfg.dataset_type), dtype=dtype)
