"""The MSMD denoising network (the port of ``msmd_tpu/models/denoiser.py``;
reference: model.py:820-996).

Person (shape + style) token plus diffusion-step embedding, the
noisy motion with its indicator channel projected to ``feature_dim``,
previous-window motion prepended, a learnable PE, an N-layer post-LN
decoder cross-attending to the audio memory, and a motion decoder whose
last ``num_of_basis`` channels weight per-basis static offsets (head-pose
channels outside the alpha weighting, the MSMD default).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from msmd_tpu_torch.config import MSMDConfig
from msmd_tpu_torch.models.layers import Dense, gelu
from msmd_tpu_torch.models.transformer import KVCache, TransformerDecoder
from msmd_tpu_torch.ops.seq import alignment_mask, apply_pe_single_row, sinusoidal_table


class DiffusionStepEmbedding(nn.Module):
    """Sinusoidal-table row by timestep, then a 2-layer GELU MLP
    (reference: model.py:855-860)."""

    def __init__(self, feature_dim: int, n_diff_steps: int, dtype=torch.float32):
        super().__init__()
        self.feature_dim, self.n_diff_steps, self.dtype = feature_dim, n_diff_steps, dtype
        self.linear1 = Dense(feature_dim, feature_dim, dtype=dtype)
        self.linear2 = Dense(feature_dim, feature_dim, dtype=dtype)

    def forward(self, step: torch.Tensor) -> torch.Tensor:
        table = sinusoidal_table(self.feature_dim, self.n_diff_steps + 1, self.dtype, step.device)
        return self.linear2(gelu(self.linear1(table[step])))


class StyleBasisMLP(nn.Module):
    """style (N, 1, d_style) -> static motion offset (N, 1, d_motion)
    (reference: model.py:890-899)."""

    def __init__(self, d_style: int, feature_dim: int, motion_feat_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear1 = Dense(d_style, feature_dim, dtype=dtype)
        self.linear2 = Dense(feature_dim, motion_feat_dim, dtype=dtype)

    def forward(self, style: torch.Tensor) -> torch.Tensor:
        return self.linear2(gelu(self.linear1(style)))


class DenoisingNetwork(nn.Module):
    def __init__(self, cfg: MSMDConfig, use_head_alpha: bool = False, dtype=torch.float32):
        super().__init__()
        self.cfg, self.use_head_alpha, self.dtype = cfg, use_head_alpha, dtype
        F_, D = cfg.feature_dim, cfg.motion_feat_dim
        self.diff_step_map = DiffusionStepEmbedding(F_, cfg.n_diff_steps, dtype)
        self.person_proj = Dense(cfg.shape_feat_dim + cfg.d_style, F_, dtype=dtype)
        self.feature_proj = Dense(D + int(cfg.use_indicator), F_, dtype=dtype)
        if not cfg.no_use_learnable_pe:
            self.PE = nn.Parameter(torch.zeros(1, 1 + cfg.n_prev_motions + cfg.n_motions, F_))
        self.transformer = TransformerDecoder(cfg.n_layers, F_, cfg.n_heads, cfg.mlp_ratio * F_, dtype)
        self.static_feature_mapping = nn.ModuleList(
            StyleBasisMLP(cfg.d_style, F_, D, dtype) for _ in range(cfg.num_of_basis)
        )
        self.motion_dec_1 = Dense(F_, F_ // 2, dtype=dtype)
        self.motion_dec_2 = Dense(F_ // 2, D + cfg.num_of_basis, dtype=dtype)

    def cache_memory_kv(self, prev_audio_feat: torch.Tensor, audio_feat: torch.Tensor) -> List[KVCache]:
        """Per-layer K/V of the audio memory, constant over a sampling run."""
        memory = torch.cat([prev_audio_feat, audio_feat], dim=1).to(self.dtype)
        return self.transformer.cache_memory(memory)

    def precompute_step_emb(self) -> torch.Tensor:
        """The step embedding of every timestep 0..T as one (T+1, F)
        table; ``table[t]`` equals ``diff_step_map(t)`` (rowwise MLP)."""
        return self.diff_step_map(torch.arange(self.cfg.n_diff_steps + 1, device=self.person_proj.weight.device))

    def forward(
        self,
        motion_feat: torch.Tensor,  # (N, L, d_motion) noisy motion
        audio_feat: torch.Tensor,  # (N, L, F)
        person_feat: torch.Tensor,  # (N, 1, d_person)
        static_style_feat: torch.Tensor,  # (N, 1, d_style)
        prev_motion_feat: torch.Tensor,  # (N, L_p, d_motion)
        prev_audio_feat: torch.Tensor,  # (N, L_p, F)
        step: torch.Tensor,  # (N,) int
        indicator: Optional[torch.Tensor] = None,  # (N, L) 0/1
        memory_kv: Optional[List[KVCache]] = None,
        fused_decoder: Optional[dict] = None,
        step_emb_table: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        n_prev, n_cur = prev_motion_feat.shape[1], motion_feat.shape[1]

        if step_emb_table is not None:
            step_emb = step_emb_table[step][:, None, :].to(dt)
        else:
            step_emb = self.diff_step_map(step)[:, None, :]
        person = self.person_proj(person_feat.to(dt)) + step_emb

        feats_in = torch.cat([prev_motion_feat, motion_feat], dim=1).to(dt)
        if cfg.use_indicator:
            if indicator is None:
                indicator = torch.ones(motion_feat.shape[0], n_cur, dtype=dt, device=motion_feat.device)
            zeros = torch.zeros(indicator.shape[0], n_prev, dtype=dt, device=motion_feat.device)
            ind = torch.cat([zeros, indicator.to(dt)], dim=1)[..., None]
            feats_in = torch.cat([feats_in, ind], dim=-1)
        feats_in = torch.cat([person, self.feature_proj(feats_in)], dim=1)  # (N, 1 + L_p + L, F)

        if not cfg.no_use_learnable_pe:
            feats_in = feats_in + self.PE.to(dt)
        else:
            feats_in = apply_pe_single_row(feats_in, sinusoidal_table(cfg.feature_dim, 600, dt, feats_in.device))

        identity_band = cfg.align_mask_width == 1
        memory_mask = None
        if cfg.align_mask_width > 0 and not identity_band:
            memory_mask = alignment_mask(n_prev, n_cur, cfg.align_mask_width)

        if fused_decoder is not None:
            from msmd_tpu_torch.ops.kernels.decoder import fused_decoder_forward

            feat_out = fused_decoder_forward(
                fused_decoder["pack"], fused_decoder["kmem"], fused_decoder["vmem"],
                feats_in.float(), fused_decoder["aux"], cfg.n_heads, fused_decoder["vmw"],
            ).to(dt)
        else:
            memory = None
            if memory_kv is None:
                memory = torch.cat([prev_audio_feat, audio_feat], dim=1).to(dt)
            feat_out = self.transformer(feats_in, memory, memory_mask, memory_kv, identity_band)

        decoded = self.motion_dec_2(gelu(self.motion_dec_1(feat_out[:, 1:])))  # (N, L_p + L, D + K)
        K = cfg.num_of_basis
        dynamic, alphas = decoded[..., :-K], decoded[..., -K:]
        if cfg.regularize_alpha == "sigmoid":
            alphas = torch.sigmoid(alphas)

        style = static_style_feat.to(dt)
        static = torch.stack([m(style) for m in self.static_feature_mapping], dim=2)  # (N, 1, K, D)
        static = static.expand(static.shape[0], decoded.shape[1], *static.shape[2:])
        alphas_e = alphas[..., None]
        if self.use_head_alpha:
            summed_static = (static * alphas_e).sum(dim=2)
        else:
            face = (static[..., :-3] * alphas_e).sum(dim=2)
            pose = static[..., -3:].sum(dim=2)
            summed_static = torch.cat([face, pose], dim=-1)
        return dynamic + summed_static
