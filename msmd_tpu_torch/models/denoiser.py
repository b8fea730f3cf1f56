"""The MSMD denoising network (the port of ``msmd_tpu/models/denoiser.py``;
reference: model.py:820-996).

Person (shape + style) token plus diffusion-step embedding, the
noisy motion with its indicator channel projected to ``feature_dim``,
previous-window motion prepended, a learnable PE, an N-layer post-LN
decoder cross-attending to the audio memory, and a motion decoder whose
last ``num_of_basis`` channels weight per-basis static offsets (head-pose
channels outside the alpha weighting, the MSMD default).

In training (a ``torch.Generator`` as ``rng``) the decoder runs its
dropout, the width-1 band stays an identity V-gather when
``cfg.identity_band_train`` (the default) and is a masked softmax
otherwise, the sinusoidal PE takes dropout 0.1 when the PE is not
learned, and ``cfg.fused_ffn_train`` sends every layer's FFN block through
K7 (``msmd_tpu/models/denoiser.py``:169-226); ``cfg.remat_denoiser``
checkpoints every decoder layer. In eval mode
``fused_decoder`` (the sampler's packed weights, memory K/V and masks)
runs the whole stack through K1 per-entry, K1 flat-mask or K2; otherwise
the decoder takes ``fused_ffn`` (K6), ``attn_kernel`` (K8) and
``fused_tail`` (K9, only with the identity band and a memory K/V cache,
as ``msmd_tpu/models/denoiser.py``:221-226 gates it); see
``models/transformer.py``. ``keep_separate`` returns the dynamic part, the
per-basis static offsets and the alphas apart (the style-basis
introspection sampler's view). A tensor-parallel model
(``parallel/tp.py``) runs the decoder modules without the kernels: they
take whole weights.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from msmd_tpu_torch.config import MSMDConfig
from msmd_tpu_torch.models.layers import Dense, dropout, gelu
from msmd_tpu_torch.models.transformer import KVCache, TransformerDecoder
from msmd_tpu_torch.ops.seq import alignment_mask, apply_pe_single_row, sinusoidal_table
from msmd_tpu_torch.parallel.tp import is_sharded


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
        rng: Optional[torch.Generator] = None,
        keep_separate: bool = False,
        fused_ffn: bool = False,
        fused_tail: bool = False,
        attn_kernel: bool = False,
    ):
        """The denoised motion (N, L_p + L, d_motion), or with
        ``keep_separate`` (dynamic (N, L_p + L, d_motion), static
        (N, L_p + L, K, d_motion), alphas (N, L_p + L, K))."""
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
            feats_in = dropout(feats_in, 0.1, rng)

        identity_band = cfg.align_mask_width == 1 and (rng is None or cfg.identity_band_train)
        memory_mask = None
        if cfg.align_mask_width > 0 and not identity_band:
            memory_mask = alignment_mask(n_prev, n_cur, cfg.align_mask_width)

        whole = not is_sharded(self)  # under tensor parallelism the whole-weight kernels stay closed
        if fused_decoder is not None and not whole:
            raise ValueError("the decoder kernels take whole weights: a tensor-parallel model runs the modules")
        if fused_decoder is not None:
            # the decoder-kernel path (``msmd_tpu/models/denoiser.py``:186-217):
            # K2 with ``layer_outer``, else K1 per-entry, or K1 flat-mask
            # with the dict's ``self_mask`` / ``cross_mask`` / ``tile_entries``
            from msmd_tpu_torch.ops.kernels import decoder, decoder_resident

            fd = fused_decoder
            args = (fd["pack"], fd["kmem"], fd["vmem"], feats_in.float(), fd["aux"], cfg.n_heads, fd["vmw"])
            if fd.get("layer_outer", False):
                feat_out = decoder_resident.fused_decoder_forward_resident(*args)
            else:
                feat_out = decoder.fused_decoder_forward(*args, self_mask=fd.get("self_mask"),
                                                         cross_mask=fd.get("cross_mask"),
                                                         tile_entries=fd.get("tile_entries", 0))
            feat_out = feat_out.to(dt)
        else:
            memory = None
            if memory_kv is None:
                memory = torch.cat([prev_audio_feat, audio_feat], dim=1).to(dt)
            feat_out = self.transformer(feats_in, memory, memory_mask, memory_kv, identity_band, rng,
                                        cfg.fused_ffn_train and whole, fused_ffn and rng is None and whole,
                                        fused_tail and identity_band and memory_kv is not None and whole,
                                        attn_kernel and whole, remat=cfg.remat_denoiser)

        decoded = self.motion_dec_2(gelu(self.motion_dec_1(feat_out[:, 1:])))  # (N, L_p + L, D + K)
        K = cfg.num_of_basis
        dynamic, alphas = decoded[..., :-K], decoded[..., -K:]
        if cfg.regularize_alpha == "sigmoid":
            alphas = torch.sigmoid(alphas)

        style = static_style_feat.to(dt)
        static = torch.stack([m(style) for m in self.static_feature_mapping], dim=2)  # (N, 1, K, D)
        static = static.expand(static.shape[0], decoded.shape[1], *static.shape[2:])
        if keep_separate:
            return dynamic, static, alphas
        alphas_e = alphas[..., None]
        if self.use_head_alpha:
            summed_static = (static * alphas_e).sum(dim=2)
        else:
            face = (static[..., :-3] * alphas_e).sum(dim=2)
            pose = static[..., -3:].sum(dim=2)
            summed_static = torch.cat([face, pose], dim=-1)
        return dynamic + summed_static
