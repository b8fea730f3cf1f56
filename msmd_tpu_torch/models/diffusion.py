"""MSMD, the conditional diffusion model for speech-driven facial motion,
and its DDPM sampler (the port of ``msmd_tpu/models/diffusion.py``;
reference: model.py:73-440).

The sampler stacks the classifier-free-guidance entries on the batch
axis ([null, +audio, +style], dropping the entries whose mixing
coefficient is exactly zero), caches the memory K/V once per window, and
runs t = T..1 as a Python loop. For a bf16 model with the width-1
alignment band the decoder stack of every step is one call of the
hand-written decoder kernel (``ops/kernels/decoder.py``); an f32 model
runs the plain modules, as the JAX f32 path runs the XLA decoder.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
from msmd_tpu_torch.device import resolve_device
from msmd_tpu_torch.models.audio import AudioEncoder
from msmd_tpu_torch.models.denoiser import DenoisingNetwork
from msmd_tpu_torch.models.layers import Dense, init_params
from msmd_tpu_torch.ops.kernels.decoder import build_vmw, pack_decoder_weights, pack_memory_kv, person_rows
from msmd_tpu_torch.ops.schedule import DiffusionSchedule
from msmd_tpu_torch.ops.seq import linear_interpolate, pad_audio


class MSMD(nn.Module):
    def __init__(self, cfg: MSMDConfig, use_head_alpha: bool = False,
                 audio_config: Optional[AudioEncoderConfig] = None, dtype=torch.float32):
        super().__init__()
        self.cfg, self.use_head_alpha, self.dtype = cfg, use_head_alpha, dtype
        audio_config = audio_config or AudioEncoderConfig()
        self.audio_encoder = AudioEncoder(audio_config, dtype)
        self.audio_feature_map = Dense(audio_config.hidden_size, cfg.feature_dim, dtype=dtype)
        self.start_motion_feat = nn.Parameter(torch.zeros(1, cfg.n_prev_motions, cfg.motion_feat_dim))
        self.start_audio_feat = nn.Parameter(torch.zeros(1, cfg.n_prev_motions, cfg.feature_dim))
        self.denoising_net = DenoisingNetwork(cfg, use_head_alpha, dtype)
        conds = cfg.guiding_condition_list
        if "style" in conds:
            self.null_style_feat = nn.Parameter(torch.zeros(1, 1, cfg.d_style))
        if "audio" in conds:
            self.null_audio_feat = nn.Parameter(torch.zeros(1, 1, cfg.feature_dim))

    @property
    def device(self) -> torch.device:
        return self.start_motion_feat.device

    def extract_audio_feature(self, audio: torch.Tensor, frame_num: Optional[int] = None) -> torch.Tensor:
        """Raw 16 kHz audio (N, L_a) -> (N, frame_num, feature_dim): the
        encoder at 2 * frame_num frames, resampled to frame_num, projected
        (reference: model.py:250-264)."""
        cfg = self.cfg
        frame_num = frame_num or cfg.n_motions
        hidden = self.audio_encoder(pad_audio(audio), cfg.fps, frame_num * 2)
        hidden = linear_interpolate(hidden.transpose(1, 2), frame_num).transpose(1, 2)
        return self.audio_feature_map(hidden)


def get_diffusion_model(cfg: MSMDConfig, audio_config: Optional[AudioEncoderConfig] = None,
                        dtype=torch.float32, device="cuda", seed: Optional[int] = None) -> MSMD:
    """Build MSMD on ``device`` (reference: model.py:7-17). ``seed`` gives
    seeded random weights (``layers.init_params``); without it the
    weights are left for ``interop.load_flax_params``."""
    dev = resolve_device(device)
    model = MSMD(cfg, use_head_alpha=False, audio_config=audio_config, dtype=dtype)
    if seed is not None:
        init_params(model, seed)
    return model.to(dev).eval()


# ===========================================================================
# sampling
# ===========================================================================

def _normalize_cfg(cfg: MSMDConfig, cfg_mode, cfg_cond, cfg_scale):
    """Sort conditions ('audio' before 'style') and align the scales
    (reference: model.py:294-303)."""
    if cfg_mode is None:
        cfg_mode = cfg.cfg_mode
    if cfg_cond is None:
        cfg_cond = cfg.guiding_condition_list
    cfg_cond = [c for c in cfg_cond if c in ("audio", "style")]
    if not isinstance(cfg_scale, (list, tuple)):
        cfg_scale = [cfg_scale] * len(cfg_cond)
    if cfg_cond:
        order = sorted(zip(cfg_cond, cfg_scale), key=lambda x: ["audio", "style"].index(x[0]))
        cfg_cond, cfg_scale = [c for c, _ in order], [s for _, s in order]
    else:
        cfg_cond, cfg_scale = [], []
    return cfg_mode, tuple(cfg_cond), tuple(float(s) for s in cfg_scale)


def _cfg_coefficients(cfg_mode: str, cfg_scale: Sequence[float], n_entries: int) -> Tuple[float, ...]:
    """The reference's sequential guidance mix (model.py:406-417) as one
    linear combination ``sum_i c_i r_i``. Incremental: c_0 = 1 - s_0,
    c_j = s_{j-1} - s_j, c_last = s_last. Independent: the reference's
    aliased in-place update gives the nested mix t <- (1 - s_i) t + s_i r_{i+1}.
    With equal incremental scales the middle coefficient is exactly 0."""
    if n_entries == 1:
        return (1.0,)
    s = list(cfg_scale)
    if cfg_mode == "incremental":
        c = [1.0 - s[0]] + [s[j - 1] - s[j] for j in range(1, n_entries - 1)] + [s[-1]]
    elif cfg_mode == "independent":
        c = [1.0]
        for s_i in s:
            c = [cj * (1.0 - s_i) for cj in c] + [s_i]
    else:
        raise NotImplementedError(f"Unknown cfg_mode {cfg_mode}")
    return tuple(c)


def _build_cfg_stacks(model: MSMD, audio_feat, shape_feat, style_feat, cfg_mode, cfg_cond, cfg_scale):
    """Stack the CFG entries on the batch axis, entry-major:
    [null, (+audio), (+style)] (reference: model.py:336-374), dropping
    entries whose coefficient is exactly zero. Returns (audio_in,
    person_in, n_entries_kept, coefficients_kept)."""
    B, n_motions = audio_feat.shape[0], audio_feat.shape[1]
    if "audio" in cfg_cond:
        null_audio = model.null_audio_feat.expand(B, n_motions, model.null_audio_feat.shape[-1])
    else:
        null_audio = audio_feat
    if "style" in cfg_cond:
        null_style = model.null_style_feat.expand(B, 1, model.null_style_feat.shape[-1])
        person_null = torch.cat([shape_feat, null_style], dim=-1)
    else:
        person_null = torch.cat([shape_feat, style_feat], dim=-1) if style_feat is not None else shape_feat

    audio_in, person_in = [null_audio], [person_null]
    for cond in cfg_cond:
        if cond == "audio":
            audio_in.append(audio_feat)
            person_in.append(person_null)
        elif cond == "style":
            audio_in.append(null_audio if cfg_mode == "independent" else audio_feat)
            person_in.append(torch.cat([shape_feat, style_feat], dim=-1))

    coeffs = _cfg_coefficients(cfg_mode, cfg_scale, len(audio_in))
    kept = [i for i, c in enumerate(coeffs) if c != 0.0] or [len(coeffs) - 1]
    return (
        torch.cat([audio_in[i].to(audio_feat.dtype) for i in kept], dim=0),
        torch.cat([person_in[i] for i in kept], dim=0),
        len(kept),
        tuple(coeffs[i] for i in kept),
    )


def _cfg_combine(results_entries: torch.Tensor, coefficients: Sequence[float], n_motions: int) -> torch.Tensor:
    """(n_kept, B, L_p + L, D) -> guided target (B, n_motions, D)."""
    tail = results_entries[:, :, -n_motions:]
    target = coefficients[0] * tail[0]
    for i in range(1, len(coefficients)):
        target = target + coefficients[i] * tail[i]
    return target


def _dynamic_threshold(results: torch.Tensor, n_motions: int, dynamic_threshold) -> torch.Tensor:
    """Per-sample quantile clamp (reference: model.py:396-402)."""
    dt_ratio, dt_min, dt_max = dynamic_threshold
    flat = results[:, -n_motions:].reshape(results.shape[0], -1).abs().float()
    s = torch.quantile(flat, float(dt_ratio), dim=1)
    s = torch.clamp(s.to(results.dtype), dt_min, dt_max)[:, None, None]
    return torch.clamp(results, -s, s)


def _prepare_sample_inputs(model: MSMD, audio_or_feat, shape_feat, style_feat, prev_motion_feat,
                           prev_audio_feat, motion_at_T, indicator, cfg_mode, cfg_cond, cfg_scale, generator):
    cfg = model.cfg
    B = audio_or_feat.shape[0]
    cfg_mode, cfg_cond, cfg_scale = _normalize_cfg(cfg, cfg_mode, cfg_cond, cfg_scale)
    if style_feat is None:
        if not hasattr(model, "null_style_feat"):
            raise ValueError("style_feat is required: this model has no null style embedding "
                             "('style' is not in guiding_conditions)")
        style_feat = model.null_style_feat.expand(B, 1, cfg.d_style)
    audio_feat = model.extract_audio_feature(audio_or_feat) if audio_or_feat.ndim == 2 else audio_or_feat
    n_motions = audio_feat.shape[1]
    if shape_feat.ndim == 2:
        shape_feat = shape_feat[:, None]
    if style_feat.ndim == 2:
        style_feat = style_feat[:, None]
    if prev_motion_feat is None:
        prev_motion_feat = model.start_motion_feat.expand(B, *model.start_motion_feat.shape[1:])
    if prev_audio_feat is None:
        prev_audio_feat = model.start_audio_feat.expand(B, *model.start_audio_feat.shape[1:])
    if motion_at_T is None:
        motion_at_T = _randn((B, n_motions, cfg.motion_feat_dim), generator, audio_feat.device)

    audio_in, person_in, n_entries, coefficients = _build_cfg_stacks(
        model, audio_feat, shape_feat, style_feat, cfg_mode, cfg_cond, cfg_scale)
    tile = lambda x: torch.cat([x] * n_entries, dim=0)
    stacks = dict(
        audio_in=audio_in, person_in=person_in,
        prev_motion_in=tile(prev_motion_feat), prev_audio_in=tile(prev_audio_feat),
        indicator_in=tile(indicator) if indicator is not None else None,
        style_in=tile(style_feat), n_entries=n_entries, coefficients=coefficients,
    )
    return audio_feat, motion_at_T, stacks


def _randn(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal draws from ``generator`` (on its own device),
    moved to ``device``."""
    gdev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gdev, dtype=torch.float32).to(device)


def _on(x, device, dtype=None):
    if x is None:
        return None
    t = torch.as_tensor(x, device=device)
    return t.to(dtype) if dtype is not None else t


def _check_model_device(model: nn.Module, dev: torch.device) -> None:
    have = next(model.parameters()).device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"the model is on {have} but device={dev} was requested; move it with .to(device)")


@torch.no_grad()
def sample(
    model: MSMD,
    audio_or_feat,
    shape_feat,
    style_feat=None,
    prev_motion_feat=None,
    prev_audio_feat=None,
    motion_at_T=None,
    indicator=None,
    cfg_mode: Optional[str] = None,
    cfg_cond: Optional[Sequence[str]] = None,
    cfg_scale=1.15,
    flexibility: float = 0.0,
    dynamic_threshold: Optional[Tuple[float, float, float]] = None,
    noise_override=None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
):
    """DDPM sampling over t = T..1 (reference: model.py:282-440).

    ``noise_override``: optional (T, B, n_motions, D) per-step z in place
    of the generator's draws (index 0 is the first step, t = T), so tests
    can hand both packages the same noise. A bf16 model with the width-1
    alignment band runs each step's decoder stack through the decoder
    kernel, at every batch size; any other model runs the plain modules.

    Returns (motion (B, n_motions, D) f32, motion_at_T, audio_feat).
    """
    dev = resolve_device(device)
    _check_model_device(model, dev)
    cfg = model.cfg
    sched = DiffusionSchedule.create(cfg.n_diff_steps, cfg.diff_schedule)
    audio_feat, motion_at_T, stacks = _prepare_sample_inputs(
        model, _on(audio_or_feat, dev), _on(shape_feat, dev, torch.float32), _on(style_feat, dev),
        _on(prev_motion_feat, dev), _on(prev_audio_feat, dev), _on(motion_at_T, dev, torch.float32),
        _on(indicator, dev), cfg_mode, cfg_cond, cfg_scale, generator,
    )
    noise_override = _on(noise_override, dev, torch.float32)
    B, n_motions = motion_at_T.shape[0], motion_at_T.shape[1]
    E = stacks["n_entries"]

    # At bf16, cast the denoiser's weights once for the whole loop (the
    # modules would cast them at every use; same numbers).
    dn = model.denoising_net
    if model.dtype == torch.bfloat16:
        dn = copy.deepcopy(dn).to(torch.bfloat16)

    memory_kv = dn.cache_memory_kv(stacks["prev_audio_in"], stacks["audio_in"])
    fused = None
    if model.dtype == torch.bfloat16 and cfg.align_mask_width == 1:
        lq = 1 + stacks["prev_motion_in"].shape[1] + n_motions
        pack = pack_decoder_weights(dn.transformer, dtype=model.dtype)
        kmem, vmem = pack_memory_kv(memory_kv, dtype=model.dtype)
        fused = dict(pack=pack, kmem=kmem, vmem=vmem, aux=person_rows(B * E, lq, dev),
                     vmw=build_vmw(vmem, pack["wco"], lq, out_dtype=model.dtype))
    step_emb_table = dn.precompute_step_emb()

    one = np.float32(1.0)
    motion = motion_at_T
    for i, t in enumerate(range(sched.num_steps, 0, -1)):
        z = noise_override[i] if noise_override is not None else _randn(motion.shape, generator, dev)
        if t <= 1:
            z = torch.zeros_like(z)
        alpha, alpha_bar, alpha_bar_prev = sched.alphas[t], sched.alpha_bars[t], sched.alpha_bars[t - 1]
        sigma = float(sched.get_sigmas(t, flexibility))

        motion_in = torch.cat([motion] * E, dim=0)
        step_in = torch.full((B * E,), t, dtype=torch.long, device=dev)
        results = dn(motion_in, stacks["audio_in"], stacks["person_in"], stacks["style_in"],
                     stacks["prev_motion_in"], stacks["prev_audio_in"], step_in, stacks["indicator_in"],
                     memory_kv=memory_kv, fused_decoder=fused, step_emb_table=step_emb_table)
        if dynamic_threshold:
            results = _dynamic_threshold(results, n_motions, dynamic_threshold)
        results = results.reshape((E, B) + results.shape[1:])
        target = _cfg_combine(results, stacks["coefficients"], n_motions).float()

        if cfg.target == "noise":
            c0 = float(one / np.sqrt(alpha))
            c1 = float((one - alpha) / np.sqrt(one - alpha_bar))
            motion = c0 * (motion - c1 * target) + sigma * z
        elif cfg.target == "sample":
            c0 = float((one - alpha_bar_prev) * np.sqrt(alpha) / (one - alpha_bar))
            c1 = float((one - alpha) * np.sqrt(alpha_bar_prev) / (one - alpha_bar))
            motion = c0 * motion + c1 * target + sigma * z
        else:
            raise ValueError(f"Unknown target type: {cfg.target}")
    return motion, motion_at_T, audio_feat
