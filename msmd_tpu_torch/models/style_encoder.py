"""Motion clip -> style VAE encoders (the port of
``msmd_tpu/models/style_encoder.py``; reference: style_encoder.py:22-213).

One trunk: two (Conv1d k3, ELU, LayerNorm) blocks, the sinusoidal PE with
the single-row quirk, one post-LN encoder layer (512 wide, 8 heads, FFN
512), a conv head, temporal mean-pool and a (mu, logvar) split. With a
``torch.Generator`` as ``rng`` (training) dropout runs at 0.2 in the conv
stem and at 0.1 after the PE, in the encoder layer and in the head
(``msmd_tpu/models/style_encoder.py``:41-105). Two heads, as in the
reference:

- ``StyleEncoderVAE2``, the factory default: ELU head, output
  2 * d_style (z is d_style wide);
- ``StyleEncoderVAE``: ReLU head, output 4 * d_style, a ReLU after the
  last conv (z is 2 * d_style wide).

``attn_kernel`` (eval mode) runs the encoder layer's self-attention
middle through K8 (``ops/kernels/attn.py``; at f32 its f32 mode), the
port's spelling of the JAX package's ``MSMD_ATTN_KERNEL=1``, which reaches
every ``TransformerEncoderLayer``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msmd_tpu_torch.config import is_hdtf
from msmd_tpu_torch.models.layers import Conv1d, LayerNorm, dropout
from msmd_tpu_torch.models.transformer import TransformerEncoderLayer
from msmd_tpu_torch.ops.seq import apply_pe_single_row, sinusoidal_table


def style_input_dim(dataset_type: str) -> int:
    return 54 if is_hdtf(dataset_type) else 67


class _ConvStem(nn.Module):
    """conv1d(k3, same) -> dropout(0.2) -> ELU -> LayerNorm, twice."""

    def __init__(self, in_dim: int, feature_dim: int, dtype=torch.float32):
        super().__init__()
        self.conv = nn.ModuleList([
            Conv1d(in_dim, feature_dim, 3, padding=1, dtype=dtype),
            Conv1d(feature_dim, feature_dim, 3, padding=1, dtype=dtype),
        ])
        self.norm = nn.ModuleList([LayerNorm(feature_dim, dtype=dtype) for _ in range(2)])

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        for conv, norm in zip(self.conv, self.norm):
            x = norm(F.elu(dropout(conv(x), 0.2, rng)))
        return x


class _StyleVAEBase(nn.Module):
    """The shared trunk; a subclass picks the head's activation, the
    output width (``output_multiplier``) and the ReLU after the last conv.
    Names follow the JAX parameter tree (``input_layers``, ``encoder``,
    ``out_conv_{0,1}``, ``out_norm``), the same for both heads."""

    head_activation = staticmethod(F.elu)
    output_multiplier = 1
    final_activation = False

    def __init__(self, d_style: int, input_dim: int = 67, conv_feature_dim: int = 512, dtype=torch.float32):
        super().__init__()
        self.d_style, self.dtype = d_style, dtype
        self.output_size = d_style * 2 * self.output_multiplier
        self.conv_feature_dim = conv_feature_dim
        self.input_layers = _ConvStem(input_dim, conv_feature_dim, dtype)
        self.encoder = TransformerEncoderLayer(conv_feature_dim, 8, conv_feature_dim, dtype)
        self.out_conv = nn.ModuleList([
            Conv1d(conv_feature_dim, self.output_size, 3, padding=1, dtype=dtype),
            Conv1d(self.output_size, self.output_size, 3, padding=1, dtype=dtype),
        ])
        self.out_norm = LayerNorm(self.output_size, dtype=dtype)

    @property
    def z_dim(self) -> int:
        """The width of z, mu and logvar."""
        return self.output_size // 2

    def encode(self, motion_coef: torch.Tensor, rng: Optional[torch.Generator] = None, attn_kernel: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, T, input_dim) -> (mu, logvar), each (N, z_dim)."""
        x = self.input_layers(motion_coef.to(self.dtype), rng)
        table = sinusoidal_table(self.conv_feature_dim, 600, self.dtype, x.device)
        x = self.encoder(dropout(apply_pe_single_row(x, table), 0.1, rng), rng=rng, attn_kernel=attn_kernel)
        x = self.out_norm(self.head_activation(dropout(self.out_conv[0](x), 0.1, rng)))
        x = self.out_conv[1](x)
        if self.final_activation:
            x = F.relu(x)
        out = x.mean(dim=1)
        return out[:, :self.z_dim], out[:, self.z_dim:]

    def forward(self, motion_coef: torch.Tensor, generator: Optional[torch.Generator] = None, train: bool = False,
                eps: Optional[torch.Tensor] = None, attn_kernel: bool = False):
        """(z, mu, logvar) with ``z = mu + eps * exp(logvar / 2)``
        (``msmd_tpu/models/style_encoder.py``:102-106). ``eps`` comes from
        ``generator`` unless given; dropout draws from it when ``train``."""
        mu, logvar = self.encode(motion_coef, generator if train else None, attn_kernel)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=generator.device if generator else mu.device)
        return mu + eps.to(device=mu.device, dtype=mu.dtype) * torch.exp(0.5 * logvar), mu, logvar

    def encode_mean(self, motion_coef: torch.Tensor, attn_kernel: bool = False) -> torch.Tensor:
        """Posterior mean, the deterministic style embedding."""
        return self.encode(motion_coef, attn_kernel=attn_kernel)[0]

    def sample(self, motion_coef: torch.Tensor, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, attn_kernel: bool = False) -> torch.Tensor:
        """One reparameterised draw ``mu + eps * exp(logvar / 2)``. ``eps``
        may be given (tests hand both packages the same draw); otherwise
        it comes from ``generator``."""
        mu, logvar = self.encode(motion_coef, attn_kernel=attn_kernel)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=torch.float32)
        return mu + eps.to(device=mu.device, dtype=mu.dtype) * torch.exp(0.5 * logvar)


class StyleEncoderVAE2(_StyleVAEBase):
    """The production style encoder (reference: style_encoder.py:119-213)."""


class StyleEncoderVAE(_StyleVAEBase):
    """The legacy VAE (reference: style_encoder.py:22-117): ReLU head,
    doubled output width, ReLU after the last conv."""

    head_activation = staticmethod(F.relu)
    output_multiplier = 2
    final_activation = True


STYLE_ENCODERS = {"vae2": StyleEncoderVAE2, "vae": StyleEncoderVAE}


def get_style_encoder(cfg, style: str = "vae2", dtype=torch.float32, input_dim: Optional[int] = None
                      ) -> _StyleVAEBase:
    """The factory (reference: style_encoder.py:7-12; the JAX package's
    also builds ``"vae"``). ``input_dim`` defaults to the reference's width
    for the dataset (54 on the HDTF / FLAME layouts, else 67); the JAX
    package's flax convolutions take theirs from the motion they first
    see, so its training step's encoder reads the 67-wide motion on every
    layout, and the port's trainer asks for that width."""
    if style not in STYLE_ENCODERS:
        raise ValueError(f"Style encoder model style {style} not recognized")
    input_dim = style_input_dim(cfg.dataset_type) if input_dim is None else input_dim
    return STYLE_ENCODERS[style](d_style=cfg.d_style, input_dim=input_dim, dtype=dtype)


def check_style_width(cfg, style_enc: _StyleVAEBase) -> None:
    """Raise unless the encoder's z is as wide as the denoiser's style
    input (``cfg.d_style``). The VAE's z is 2 * d_style wide: the JAX
    package builds the same pair and fails in its first train step
    (broadcasting ``null_style_feat``) and in ``sample`` (concatenating the
    person rows), so the port refuses the pair when it is built."""
    if style_enc.z_dim != cfg.d_style:
        raise ValueError(f"style encoder {cfg.style_enc_model_style!r} gives a z of width {style_enc.z_dim}, "
                         f"but the denoiser takes a style of width d_style = {cfg.d_style}")
