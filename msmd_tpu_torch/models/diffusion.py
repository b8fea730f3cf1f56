"""MSMD, the conditional diffusion model for speech-driven facial motion,
its training forward and its DDPM samplers (the port of
``msmd_tpu/models/diffusion.py``; reference: model.py:73-818).

The training forward (``MSMD.forward``, ``msmd_tpu/models/diffusion.py``
:130-243) extracts the audio features, drops the CFG conditions at the
reference's rates, draws a timestep and the noise, q-samples, and runs the
denoiser once. Every draw comes from one ``torch.Generator``; dropout
draws from it too when ``train``. A data-parallel rank passes ``rows``
(``layers.SampleRows``): the per-sample draws are then the global batch's,
from the ranks' shared generator, and ``sample`` takes the same for
sharded ``infer_coeffs``.

The sampler stacks the classifier-free-guidance entries on the batch
axis ([null, +audio, +style], dropping the entries whose mixing
coefficient is exactly zero) and caches the memory K/V once per window.
It takes the routes of the JAX sampler (``msmd_tpu/models/diffusion.py``
:495-957), with the same gates:

- the decoder-kernel path (``fused_decoder``: None = on as below, True
  forces it, False turns it off; the JAX signature's switch, kept for
  parity. Callers leave it at None: True on an f32 model is a test hook
  that runs the kernels' f32 plain versions on the CPU, and raises on the
  card, whose kernels take bf16) at batch 1 with the width-1 band, without
  a dynamic threshold, with the learnable PE and no head alpha: the whole
  window is one call of the sampler kernel K3
  (``ops/kernels/sampler.py::fused_sampler_scan``), or with ``ret_traj``
  one call of K4 (``fused_sampler_step``) per step;
- the decoder-kernel path otherwise: t = T..1 as a Python loop whose
  decoder stack is one call of K1 (``ops/kernels/decoder.py``) per step,
  in the mode JAX picks (``msmd_tpu/models/diffusion.py``:555-612, see
  ``decoder_route``): per-entry at ``align_mask_width == 1`` and Be > 4
  (Be = batch x CFG entries), else flat-mask over tiles of whole entries
  (tile = Be at Be <= 4, else the largest divisor of Be up to 8), with the
  identity-band cross at width 1 and the full masked cross otherwise; or,
  with ``resident`` (the port of ``MSMD_DECODER_RESIDENT=1``) in the
  per-entry mode at Be > 4 with ``Be * lq * F * 4 <= 40 MiB``, one call of
  K2 (``ops/kernels/decoder_resident.py``) per step. ``fused_decoder``
  None is on for a bf16 model without guidance when Be <= 4 or the
  per-entry mode has a tile whose rows are a multiple of 8 (the TPU
  kernel's sublane rule, kept so that both packages route alike);
- otherwise the same loop through the decoder modules (the JAX
  XLA-decoder route). At bf16 every layer's FFN block is K6
  (``ops/kernels/ffn.py``), and two options open the JAX package's
  opt-in kernels: ``attn_kernel`` sends the self-attention middle through
  K8 (``ops/kernels/attn.py``), and ``fused_tail`` (width-1 band) sends
  each layer's motion-row tail through K9 (``ops/kernels/layer_tail.py``)
  in place of K6, with the self-attention plain, so that ``attn_kernel``
  has no effect under it. At f32 the modules are plain (and
  ``attn_kernel`` runs K8's f32 plain version on the CPU, as JAX's
  switch runs its kernel at f32).

Guided inpainting (``guidance_indice``/``guidance_values``,
``sample_with_guide``) always takes the last route, as the JAX gate
(``msmd_tpu/models/diffusion.py``:533, :686) turns the decoder kernel and
the batch-1 kernels off under guidance. ``sample_separate``, the
style-basis introspection sampler, runs the plain modules at every dtype,
as the JAX one passes no kernel flag.

The JAX package's ``MSMD_*`` environment switches are not ported; the
port takes their defaults, and spells the opt-in kernels K8
(``MSMD_ATTN_KERNEL=1``), K9 (``MSMD_FUSED_TAIL=1``) and K2
(``MSMD_DECODER_RESIDENT=1``) as the keyword arguments ``attn_kernel``,
``fused_tail`` and ``resident``. The TPU layout option
``MSMD_DECODER_PAD`` (rows padded to multiples of 8) is not ported. For
K3 the defaults are padded rows (implicit here: the attention kernel
masks the ragged edge), the f32 hoisted ``vmw``, concat row builds, no
merged heads and no block-diagonal self-attention; K4 is reached
through ``ret_traj`` only.
At batch <= 4 all T noise draws are taken up front, as the JAX sampler
precomputes them.
"""

from __future__ import annotations

import copy
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig, default_audio_config
from msmd_tpu_torch.device import resolve_device
from msmd_tpu_torch.models.audio import AudioEncoder
from msmd_tpu_torch.models.denoiser import DenoisingNetwork
from msmd_tpu_torch.models.layers import Dense, SampleRows, init_params, per_sample, uniform
from msmd_tpu_torch.ops.kernels import sampler as kernel_sampler
from msmd_tpu_torch.ops.kernels.decoder import (build_masks, build_person_mask, build_vmw, pack_decoder_weights,
                                                pack_memory_kv, person_rows)
from msmd_tpu_torch.ops.schedule import DiffusionSchedule
from msmd_tpu_torch.ops.seq import alignment_mask, linear_interpolate, pad_audio
from msmd_tpu_torch.parallel.tp import is_sharded
from msmd_tpu_torch.utils.profiling import span


class MSMD(nn.Module):
    def __init__(self, cfg: MSMDConfig, use_head_alpha: bool = False,
                 audio_config: Optional[AudioEncoderConfig] = None, dtype=torch.float32):
        super().__init__()
        self.cfg, self.use_head_alpha, self.dtype = cfg, use_head_alpha, dtype
        audio_config = audio_config or default_audio_config(cfg.audio_model)
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

    def extract_audio_feature(self, audio: torch.Tensor, frame_num: Optional[int] = None,
                              rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Raw 16 kHz audio (N, L_a) -> (N, frame_num, feature_dim): the
        encoder at 2 * frame_num frames, resampled to frame_num, projected
        (reference: model.py:250-264). ``rng``: training-mode dropout and
        SpecAugment."""
        cfg = self.cfg
        frame_num = frame_num or cfg.n_motions
        with span("msmd.audio_encoder"):
            hidden = self.audio_encoder(pad_audio(audio), cfg.fps, frame_num * 2, rng)
            hidden = linear_interpolate(hidden.transpose(1, 2), frame_num).transpose(1, 2)
            return self.audio_feature_map(hidden)

    def forward(
        self,
        motion_feat: torch.Tensor,  # (N, L, d_motion)
        audio_or_feat: torch.Tensor,  # (N, L_a) raw or (N, L, F) features
        shape_feat: torch.Tensor,  # (N, 100) or (N, 1, 100)
        style_feat: Optional[torch.Tensor] = None,  # (N, d_style) or (N, 1, d_style)
        prev_motion_feat: Optional[torch.Tensor] = None,
        prev_audio_feat: Optional[torch.Tensor] = None,
        time_step: Optional[torch.Tensor] = None,
        indicator: Optional[torch.Tensor] = None,
        train_with_cfg: bool = True,
        generator: Optional[torch.Generator] = None,
        train: bool = True,
        noise: Optional[torch.Tensor] = None,
        keep_separate: bool = False,
        rows: Optional[SampleRows] = None,
    ):
        """The training forward (reference: model.py:146-248). Returns (eps,
        target, motion_feat detached, the audio features before the CFG
        condition drop, detached), and with ``keep_separate`` also the
        denoiser's (dynamic, static, alpha) parts, the target then being
        their recombination with alpha on all channels, head pose too
        (reference: model.py:239-241). ``time_step`` and ``noise`` fix the
        draws (test hooks, as in the JAX package); the rest come from
        ``generator``, which also drives dropout when ``train``. With
        ``rows`` (this rank's rows of a data-parallel batch) the CFG drops,
        the timestep and the noise are drawn for the whole batch from its
        shared generator, and ``generator`` drives dropout only."""
        cfg = self.cfg
        B = motion_feat.shape[0]
        dev = motion_feat.device
        rng = generator if train else None
        if audio_or_feat.ndim == 2:
            if audio_or_feat.shape[1] != cfg.n_audio_samples:
                raise ValueError(f"Incorrect audio length {audio_or_feat.shape[1]} (expected {cfg.n_audio_samples})")
            audio_feat_saved = self.extract_audio_feature(audio_or_feat, rng=rng)
        elif audio_or_feat.ndim == 3:
            if audio_or_feat.shape[1] != cfg.n_motions:
                raise ValueError(f"Incorrect audio feature length {audio_or_feat.shape[1]}")
            audio_feat_saved = audio_or_feat
        else:
            raise ValueError(f"Incorrect audio input shape {tuple(audio_or_feat.shape)}")
        audio_feat = audio_feat_saved
        if shape_feat.ndim == 2:
            shape_feat = shape_feat[:, None]
        if style_feat is not None and style_feat.ndim == 2:
            style_feat = style_feat[:, None]
        if prev_motion_feat is None:
            prev_motion_feat = self.start_motion_feat.expand(B, *self.start_motion_feat.shape[1:])
        if prev_audio_feat is None:
            prev_audio_feat = self.start_audio_feat.expand(B, *self.start_audio_feat.shape[1:])

        conds = cfg.guiding_condition_list
        if conds and train_with_cfg:
            if len(conds) > 2:
                raise ValueError("Only support 1 or 2 CFG conditions!")
            u = lambda: per_sample(B, generator, rows, lambda n, g: uniform((n,), g, dev))[:, None, None]
            if len(conds) == 1 or cfg.cfg_mode == "independent":
                null_prob = 0.5 if len(conds) >= 2 else 0.1
                drop_style, drop_audio = u() < null_prob, u() < null_prob
            else:  # incremental: full 0.45 / without style 0.45 / without both 0.1
                flag = u()
                drop_style, drop_audio = flag > 0.55, flag > 0.9
            if "style" in conds:
                style_feat = torch.where(drop_style, self.null_style_feat.to(style_feat.dtype), style_feat)
            if "audio" in conds:
                audio_feat = torch.where(drop_audio, self.null_audio_feat.to(audio_feat.dtype), audio_feat)

        person_feat = shape_feat if style_feat is None else torch.cat([shape_feat, style_feat.to(shape_feat.dtype)],
                                                                      dim=-1)
        if time_step is None:
            sched = _schedule(cfg.n_diff_steps, cfg.diff_schedule)
            time_step = per_sample(B, generator, rows, lambda n, g: sched.uniform_sample_t(g, n))
        time_step = time_step.to(motion_feat.device)
        # q-sample: x_t = sqrt(ab) x_0 + sqrt(1 - ab) eps (model.py:231-236)
        alpha_bar = _alpha_bars(cfg.n_diff_steps, cfg.diff_schedule, motion_feat.device)[time_step]
        c0, c1 = torch.sqrt(alpha_bar)[:, None, None], torch.sqrt(1.0 - alpha_bar)[:, None, None]
        if noise is None:
            noise = per_sample(B, generator, rows, lambda n, g: _randn((n,) + tuple(motion_feat.shape[1:]), g, dev))
        eps = noise.to(device=motion_feat.device, dtype=motion_feat.dtype)
        out = self.denoising_net(c0 * motion_feat + c1 * eps, audio_feat, person_feat, style_feat,
                                 prev_motion_feat, prev_audio_feat, time_step, indicator, rng=rng,
                                 keep_separate=keep_separate)
        if keep_separate:
            dynamic, static, alpha_t = out
            target = dynamic + (static * alpha_t[..., None]).sum(dim=2)
            return eps, target, motion_feat.detach(), audio_feat_saved.detach(), dynamic, static, alpha_t
        return eps, out, motion_feat.detach(), audio_feat_saved.detach()


@functools.lru_cache(maxsize=None)
def _schedule(n_diff_steps: int, mode: str) -> DiffusionSchedule:
    return DiffusionSchedule.create(n_diff_steps, mode)


@functools.lru_cache(maxsize=None)
def _alpha_bars(n_diff_steps: int, mode: str, device) -> torch.Tensor:
    """The schedule's alpha-bar table on ``device``, made once: a copy to
    the card at every forward would make the host wait for the card."""
    return torch.as_tensor(_schedule(n_diff_steps, mode).alpha_bars, device=device)


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
                           prev_audio_feat, motion_at_T, indicator, cfg_mode, cfg_cond, cfg_scale, generator,
                           rows: Optional[SampleRows] = None):
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
        motion_at_T = per_sample(B, generator, rows,
                                 lambda n, g: _randn((n, n_motions, cfg.motion_feat_dim), g, audio_feat.device))

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


def _ddpm_table(sched: DiffusionSchedule, target: str, flexibility: float) -> np.ndarray:
    """Per-step [A, B, sigma, 0 x 5] (T+1, 8) f32 with
    x_{t-1} = A x_t + B target + sigma z for both target modes
    (``msmd_tpu/models/diffusion.py``:743-755)."""
    f32 = np.float32
    t_all = np.arange(sched.num_steps + 1)
    al, ab = sched.alphas[t_all], sched.alpha_bars[t_all]
    ab_prev = sched.alpha_bars[np.maximum(t_all - 1, 0)]
    sig = sched.get_sigmas(t_all, flexibility).astype(f32)
    denom = np.where(t_all > 0, f32(1.0) - ab, f32(1.0)).astype(f32)
    if target == "sample":
        A = (f32(1.0) - ab_prev) * np.sqrt(al) / denom
        B = (f32(1.0) - al) * np.sqrt(ab_prev) / denom
    elif target == "noise":
        A = f32(1.0) / np.sqrt(al)
        B = -A * (f32(1.0) - al) / np.sqrt(denom)
    else:
        raise ValueError(f"Unknown target type: {target}")
    z = np.zeros_like(A, dtype=f32)
    return np.stack([A, B, sig] + [z] * 5, axis=1).astype(f32)


DECODER_TILE = 8  # entries per row tile at most (MSMD_DECODER_TILE's default)
RESIDENT_MAX_BYTES = 40 * 1024 * 1024  # K2's gate on the f32 activations (diffusion.py:607-612)


def decoder_route(align_mask_width: int, Be: int, lq: int) -> Tuple[bool, int]:
    """(per_entry, tile) of the decoder-kernel path for Be entries of lq
    rows, as ``msmd_tpu/models/diffusion.py``:555-599 picks them:
    per-entry only at width 1 and Be > 4 with a tile of at most 8 entries
    whose rows are a multiple of 8 (the largest such); otherwise flat-mask
    mode with tile = Be at Be <= 4, else the largest divisor of Be up to 8."""
    if Be <= 4:
        return False, Be
    divisors = [d for d in range(1, DECODER_TILE + 1) if Be % d == 0]
    viable = [d for d in divisors if (d * lq) % 8 == 0]
    if align_mask_width == 1 and viable:
        return True, max(viable)
    return False, max(divisors)


@functools.lru_cache(maxsize=None)
def _flat_masks(tile: int, n_prev: int, n_motions: int, align_mask_width: int, device):
    """The flat-mask mode's (self mask, cross mask) on ``device``, made
    once: at width 1 the cross mask is the person mask (tile, tile*lm),
    otherwise the (tile*lq, tile*lm) block mask with the alignment band
    (none at width 0). Shared; do not write to them."""
    lm = n_prev + n_motions
    if align_mask_width == 1:
        return build_masks(tile, lm + 1, lm, None, device)[0], build_person_mask(tile, lm, device)
    align = alignment_mask(n_prev, n_motions, align_mask_width) if align_mask_width > 0 else None
    return build_masks(tile, lm + 1, lm, align, device)


def fused_decoder_args(dn: DenoisingNetwork, cfg: MSMDConfig, dtype, memory_kv, Be: int, n_prev: int,
                       n_motions: int, device, resident: bool = False) -> dict:
    """What the denoiser's decoder-kernel path takes for one window of Be
    entries (``msmd_tpu/models/diffusion.py``:591-621, :855-870): the
    packed weights and memory K/V, the tile and, per mode, the person rows
    and the hoisted ``vmw`` (width 1), the flat-mode masks, and
    ``layer_outer`` (K2) under JAX's resident gate."""
    lq = 1 + n_prev + n_motions
    per_entry, tile = decoder_route(cfg.align_mask_width, Be, lq)
    pack = pack_decoder_weights(dn.transformer, dtype=dtype)
    kmem, vmem = pack_memory_kv(memory_kv, dtype=dtype)
    fused = dict(pack=pack, kmem=kmem, vmem=vmem, aux=None, vmw=None, tile_entries=tile,
                 layer_outer=per_entry and resident and Be * lq * cfg.feature_dim * 4 <= RESIDENT_MAX_BYTES)
    if cfg.align_mask_width == 1:
        fused.update(aux=person_rows(Be, lq, device), vmw=build_vmw(vmem, pack["wco"], lq, out_dtype=dtype))
    if not per_entry:
        fused["self_mask"], fused["cross_mask"] = _flat_masks(tile, n_prev, n_motions, cfg.align_mask_width,
                                                              torch.device(device))
    return fused


def batch1_sampler_args(dn: DenoisingNetwork, cfg: MSMDConfig, dtype, stacks: dict, memory_kv, n_motions: int,
                        flexibility: float = 0.0) -> dict:
    """What the batch-1 sampler kernels K3 and K4 take, built in f32 as
    ``msmd_tpu/models/diffusion.py``:693-756 builds it, from ``dn`` (the
    denoiser with its weights already in ``dtype``) and the CFG stacks of
    one batch-1 window. Returns dict(pack, kmem, vmem, const, sc_tab
    (T+1, 8), emb_table (T+1, F) f32, kw) where ``kw`` holds the kernels'
    static arguments; ``const`` has no ``vmw`` (K3 adds it)."""
    f32 = torch.float32
    E, D = stacks["n_entries"], cfg.motion_feat_dim
    dev = dn.person_proj.weight.device
    lin = lambda layer, x: x @ layer.weight.to(f32).t() + layer.bias.to(f32)
    prev_rows = stacks["prev_motion_in"][0].to(f32)
    if cfg.use_indicator:  # the previous rows carry indicator channel 0
        prev_rows = torch.cat([prev_rows, torch.zeros(prev_rows.shape[0], 1, dtype=f32, device=dev)], dim=1)
    ind = stacks["indicator_in"]
    ind_row = ind[0].to(f32) if ind is not None else torch.ones(n_motions, dtype=f32, device=dev)
    persons_pre = lin(dn.person_proj, stacks["person_in"][:, 0, :].to(f32))
    style_e = stacks["style_in"][:, 0, :].to(f32)
    statics = [lin(m.linear2, torch.nn.functional.gelu(lin(m.linear1, style_e)))
               for m in dn.static_feature_mapping]
    kern = lambda layer: layer.weight.detach().t().to(dtype).contiguous()
    bias = lambda layer: layer.bias.detach().to(f32)[None].contiguous()
    const = dict(
        prev_rows=prev_rows.contiguous(), ind_col=ind_row[:, None].contiguous(),
        wfp=kern(dn.feature_proj), bfp=bias(dn.feature_proj),
        persons_pre=persons_pre.contiguous(), pe_flat=dn.PE.detach().to(f32)[0].repeat(E, 1).contiguous(),
        wd1=kern(dn.motion_dec_1), bd1=bias(dn.motion_dec_1),
        wd2=kern(dn.motion_dec_2), bd2=bias(dn.motion_dec_2),
        statics_rows=torch.stack([s.repeat_interleave(n_motions, dim=0) for s in statics]).contiguous(),
        pose_sum_rows=sum(statics)[:, -3:].repeat_interleave(n_motions, dim=0).contiguous(),
    )
    sched = DiffusionSchedule.create(cfg.n_diff_steps, cfg.diff_schedule)
    kmem, vmem = pack_memory_kv(memory_kv, dtype=dtype)
    return dict(
        pack=pack_decoder_weights(dn.transformer, dtype=dtype), kmem=kmem, vmem=vmem, const=const,
        sc_tab=torch.as_tensor(_ddpm_table(sched, cfg.target, flexibility), device=dev),
        emb_table=dn.precompute_step_emb().to(f32),
        kw=dict(n_heads=cfg.n_heads, n_entries=E, n_cur=n_motions, d_motion=D, num_basis=cfg.num_of_basis,
                use_indicator=cfg.use_indicator, sigmoid_alpha=cfg.regularize_alpha == "sigmoid",
                coefficients=tuple(float(c) for c in stacks["coefficients"])),
    )


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
    ret_traj: bool = False,
    noise_override=None,
    fused_decoder: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    guidance_indice=None,
    guidance_values=None,
    attn_kernel: bool = False,
    fused_tail: bool = False,
    resident: bool = False,
    rows: Optional[SampleRows] = None,
):
    """DDPM sampling over t = T..1 (reference: model.py:282-440), and with
    ``guidance_indice``/``guidance_values`` the naive inpainting of
    ``sample_with_guide`` (reference: model.py:653-818): at every step the
    denoiser's input is overwritten at the current window's motion rows
    ``guidance_indice`` by ``guidance_values`` (broadcast over the batch),
    while the DDPM update integrates the un-inpainted state.

    ``noise_override``: optional (T, B, n_motions, D) per-step z in place
    of the generator's draws (index 0 is the first step, t = T), so tests
    can hand both packages the same noise. ``fused_decoder``,
    ``attn_kernel``, ``fused_tail``, ``resident`` and the routes they open
    are in the module docstring. ``rows``: the batch is this rank's rows of
    a larger one (sharded ``infer_coeffs``): x_T and every z are drawn for
    all rows from the shared generator, as the unsharded call draws them,
    and the rank's rows kept. A tensor-parallel model (``parallel/tp.py``)
    takes the plain modules: the kernels take whole weights.

    Returns (motion (B, n_motions, D) f32, motion_at_T, audio_feat), with
    the full trajectory (T+1, B, n_motions, D; index t holds x_t) in place
    of the motion when ``ret_traj``.
    """
    with span("msmd.sample.setup"):
        dev = resolve_device(device)
        _check_model_device(model, dev)
        cfg = model.cfg
        sched = DiffusionSchedule.create(cfg.n_diff_steps, cfg.diff_schedule)
        audio_feat, motion_at_T, stacks = _prepare_sample_inputs(
            model, _on(audio_or_feat, dev), _on(shape_feat, dev, torch.float32), _on(style_feat, dev),
            _on(prev_motion_feat, dev), _on(prev_audio_feat, dev), _on(motion_at_T, dev, torch.float32),
            _on(indicator, dev), cfg_mode, cfg_cond, cfg_scale, generator, rows,
        )
        noise_override = _on(noise_override, dev, torch.float32)
        B, n_motions = motion_at_T.shape[0], motion_at_T.shape[1]
        E = stacks["n_entries"]
        T = sched.num_steps
        guided = guidance_indice is not None
        n_prev = stacks["prev_motion_in"].shape[1]
        Be, lq = B * E, 1 + n_prev + n_motions
        if is_sharded(model):  # tensor parallel: a gate on the layout, not on a failure
            if fused_decoder:
                raise ValueError("the decoder kernels take whole weights: a tensor-parallel model runs the modules")
            fused_decoder = False
        if fused_decoder is None:
            fused_decoder = (model.dtype == torch.bfloat16 and not guided
                             and (Be <= 4 or decoder_route(cfg.align_mask_width, Be, lq)[0]))
        z_shape = tuple(motion_at_T.shape[1:])
        if noise_override is None and (B if rows is None else rows.total) <= 4:
            noise_override = per_sample(B, generator, rows, lambda n, g: _randn((T, n) + z_shape, g, dev), dim=1)

        # At bf16, cast the denoiser's weights once for the whole loop (the
        # modules would cast them at every use; same numbers).
        dn = model.denoising_net
        if model.dtype == torch.bfloat16:
            dn = copy.deepcopy(dn).to(torch.bfloat16)
        memory_kv = dn.cache_memory_kv(stacks["prev_audio_in"], stacks["audio_in"])

        batch1 = (fused_decoder and B == 1 and cfg.align_mask_width == 1 and dynamic_threshold is None
                  and not cfg.no_use_learnable_pe and not model.use_head_alpha and not guided)
        if batch1:
            args = _batch1_args(dn, model, stacks, memory_kv, motion_at_T, noise_override, flexibility, ret_traj)
        else:
            fused = None
            if fused_decoder:
                fused = fused_decoder_args(dn, cfg, model.dtype, memory_kv, Be, n_prev, n_motions, dev, resident)
            # the XLA-decoder route's kernels (``msmd_tpu/models/diffusion.py``:627-650)
            fused_ffn = fused is None and model.dtype == torch.bfloat16
            fused_tail = fused_ffn and fused_tail and cfg.align_mask_width == 1
            fused_ffn = fused_ffn and not fused_tail
            if guided:
                guidance_indice = torch.as_tensor(guidance_indice, dtype=torch.long, device=dev)
                guidance_values = _on(guidance_values, dev, torch.float32)
            step_emb_table = dn.precompute_step_emb()
            sc_tab = _ddpm_table(sched, cfg.target, flexibility)

    with span("msmd.sample.steps"):
        if batch1:
            return _sample_batch1(args, motion_at_T, ret_traj), motion_at_T, audio_feat
        motion = motion_at_T
        traj = []
        for i, t in enumerate(range(T, 0, -1)):
            z = noise_override[i] if noise_override is not None else \
                per_sample(B, generator, rows, lambda n, g: _randn((n,) + z_shape, g, dev))
            if t <= 1:
                z = torch.zeros_like(z)

            motion_in = torch.cat([motion] * E, dim=0)
            if guided:
                motion_in[:, guidance_indice, :] = guidance_values
            step_in = torch.full((B * E,), t, dtype=torch.long, device=dev)
            results = dn(motion_in, stacks["audio_in"], stacks["person_in"], stacks["style_in"],
                         stacks["prev_motion_in"], stacks["prev_audio_in"], step_in, stacks["indicator_in"],
                         memory_kv=memory_kv, fused_decoder=fused, step_emb_table=step_emb_table,
                         fused_ffn=fused_ffn, fused_tail=fused_tail, attn_kernel=attn_kernel)
            if dynamic_threshold:
                results = _dynamic_threshold(results, n_motions, dynamic_threshold)
            results = results.reshape((E, B) + results.shape[1:])
            target = _cfg_combine(results, stacks["coefficients"], n_motions).float()
            A, B_t, sigma = (float(v) for v in sc_tab[t, :3])
            motion = A * motion + B_t * target + sigma * z
            if ret_traj:
                traj.append(motion)
        if ret_traj:
            return _trajectory(traj, motion_at_T), motion_at_T, audio_feat
        return motion, motion_at_T, audio_feat


def sample_with_guide(model: MSMD, audio_or_feat, shape_feat, *, guidance_indice, guidance_values, **kw):
    """Naive inpainting guidance (reference: model.py:653-818): ``sample``
    with the window's motion rows ``guidance_indice`` pinned to
    ``guidance_values`` in every denoiser input."""
    return sample(model, audio_or_feat, shape_feat, guidance_indice=guidance_indice,
                  guidance_values=guidance_values, **kw)


@torch.no_grad()
def sample_separate(
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
    alpha_t_modification=None,
    return_all_alpha: bool = False,
    noise_override=None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
):
    """The style-basis introspection sampler (reference: model.py:442-651;
    ``msmd_tpu/models/diffusion.py``:969-1075): ``sample`` with the
    denoiser's dynamic part, static offsets and alphas kept apart.
    ``alpha_t_modification`` (a function of the (B*E, L_p + L, K) alphas)
    may change the alphas in flight. Runs the plain modules at every dtype.

    Returns (motion (B, n_motions, D), motion_at_T, audio_feat, the last
    step's guided dynamic part, the accumulated static contribution
    sum_t c1(t) * guided static(t), and the last step's guided alphas, or
    with ``return_all_alpha`` every step's (T, B, n_motions, K), t = T..1).
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
    E, coeffs = stacks["n_entries"], stacks["coefficients"]
    dn = model.denoising_net
    if model.dtype == torch.bfloat16:
        dn = copy.deepcopy(dn).to(torch.bfloat16)
    memory_kv = dn.cache_memory_kv(stacks["prev_audio_in"], stacks["audio_in"])

    def combine_static(static, alpha_e):
        if model.use_head_alpha:
            return (static * alpha_e).sum(dim=2)
        return torch.cat([(static[..., :-3] * alpha_e).sum(dim=2), static[..., -3:].sum(dim=2)], dim=-1)

    def guided(x):
        return _cfg_combine(x.reshape((E, B) + x.shape[1:]), coeffs, n_motions)

    f32 = np.float32
    motion, cum_static, alphas = motion_at_T, torch.zeros_like(motion_at_T), []
    for i, t in enumerate(range(sched.num_steps, 0, -1)):
        z = noise_override[i] if noise_override is not None else _randn(motion.shape, generator, dev)
        if t <= 1:
            z = torch.zeros_like(z)
        step_in = torch.full((B * E,), t, dtype=torch.long, device=dev)
        dynamic, static, alpha_t = dn(torch.cat([motion] * E, dim=0), stacks["audio_in"], stacks["person_in"],
                                      stacks["style_in"], stacks["prev_motion_in"], stacks["prev_audio_in"], step_in,
                                      stacks["indicator_in"], memory_kv=memory_kv, keep_separate=True)
        if alpha_t_modification is not None:
            alpha_t = alpha_t_modification(alpha_t)
        static_sum = combine_static(static, alpha_t[..., None])
        results = dynamic + static_sum
        if dynamic_threshold:
            results = _dynamic_threshold(results, n_motions, dynamic_threshold)
        target = guided(results).float()
        target_dynamic, target_static = guided(dynamic), guided(static_sum).float()
        alphas.append(guided(alpha_t))

        al, ab, ab_prev = (f32(sched.alphas[t]), f32(sched.alpha_bars[t]), f32(sched.alpha_bars[t - 1]))
        sigma = float(sched.get_sigmas(t, flexibility))
        if cfg.target == "noise":
            c0, c1 = f32(1.0) / np.sqrt(al), (f32(1.0) - al) / np.sqrt(f32(1.0) - ab)
            motion = float(c0) * (motion - float(c1) * target) + sigma * z
        elif cfg.target == "sample":
            c0 = (f32(1.0) - ab_prev) * np.sqrt(al) / (f32(1.0) - ab)
            c1 = (f32(1.0) - al) * np.sqrt(ab_prev) / (f32(1.0) - ab)
            motion = float(c0) * motion + float(c1) * target + sigma * z
        else:
            raise ValueError(f"Unknown target type: {cfg.target}")
        cum_static = cum_static + float(c1) * target_static
    alpha_out = torch.stack(alphas) if return_all_alpha else alphas[-1]
    return motion, motion_at_T, audio_feat, target_dynamic, cum_static, alpha_out


def _trajectory(steps, motion_at_T):
    """Per-step outputs x_{T-1} .. x_0 and x_T -> (T+1, ...) with index t
    holding x_t (``msmd_tpu/models/diffusion.py``:953-957)."""
    return torch.stack(steps[::-1] + [motion_at_T])


def _batch1_args(dn, model, stacks, memory_kv, motion_at_T, noise, flexibility, ret_traj) -> dict:
    """What the batch-1 window's launches take: ``batch1_sampler_args``
    and the per-step rows (K3: all T at once, with ``vmw``; K4: one a
    step). ``noise`` (T, 1, N, D) is unmasked; the last step's z is 0."""
    cfg = model.cfg
    a = batch1_sampler_args(dn, cfg, model.dtype, stacks, memory_kv, motion_at_T.shape[1], flexibility)
    T = cfg.n_diff_steps
    ts = torch.arange(T, 0, -1, device=motion_at_T.device)
    a.update(ts=ts, z=noise[:, 0].float() * (ts > 1).float()[:, None, None],  # (T, N, D), 0 at t = 1
             m_T=motion_at_T[0].float().contiguous())
    if not ret_traj:
        lq = a["const"]["pe_flat"].shape[0] // a["kw"]["n_entries"]
        a.update(const=dict(a["const"], vmw=build_vmw(a["vmem"], a["pack"]["wco"], lq, out_dtype=torch.float32)),
                 emb_rows=a["emb_table"][ts][:, None].contiguous(), sc_rows=a["sc_tab"][ts][:, None].contiguous())
    return a


def _sample_batch1(a: dict, motion_at_T, ret_traj):
    """The batch-1 window through K3, or through K4 once per step for a
    trajectory, from ``_batch1_args``."""
    if not ret_traj:
        m0 = kernel_sampler.fused_sampler_scan(a["pack"], a["kmem"], a["vmem"], a["m_T"], a["emb_rows"],
                                               a["sc_rows"], a["z"], a["const"], **a["kw"])
        return m0[None]
    m, steps = a["m_T"], []
    for i, t in enumerate(range(len(a["ts"]), 0, -1)):
        m = kernel_sampler.fused_sampler_step(
            a["pack"], a["kmem"], a["vmem"], m, a["emb_table"][t][None].contiguous(),
            a["sc_tab"][t][None].contiguous(), a["z"][i].contiguous(), a["const"], **a["kw"])
        steps.append(m[None])
    return _trajectory(steps, motion_at_T)
