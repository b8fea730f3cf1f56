"""Windowed long-form inference and model loading (the port of
``msmd_tpu/inference_lib.py``; reference: inference.py:35-75, 85-103 and
109-183).

Audio features of the whole clip are extracted once; fixed
``n_motions``-frame windows then slide with stride ``n_motions``, each
conditioned on the previous window's last ``n_prev_motions`` frames of
motion and audio features. The first window's initial noise is reused
by every later window, the padded tail is masked through the indicator
and trimmed, and the ``n_repetitions`` seeds run as one batch, or, over a
process group, split over its ranks.
"""

from __future__ import annotations

import math
import pickle
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig, audio_config_from_dict
from msmd_tpu_torch.device import resolve_device
from msmd_tpu_torch.models.diffusion import MSMD, get_diffusion_model, sample
from msmd_tpu_torch.models.layers import SampleRows
from msmd_tpu_torch.utils.profiling import count


@torch.no_grad()
def infer_coeffs(
    model: MSMD,
    audio,  # (L_audio,) 16 kHz, z-scored
    shape_coef,  # (1 or R, 100)
    audio_unit: float = 640.0,
    style_feats=None,  # (1 or R, d_style), or a list with one per window
    n_repetitions: int = 1,
    cfg_mode: Optional[str] = None,
    cfg_cond: Optional[Sequence[str]] = None,
    cfg_scale: float = 1.15,
    dynamic_threshold: Optional[Tuple[float, float, float]] = (0, 1, 4),
    motion_at_T=None,
    noise_override=None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    resident: bool = False,
    process_group=None,
) -> torch.Tensor:
    """Returns motion coefficients (n_repetitions, clip_frames, 67).

    ``motion_at_T`` / ``noise_override`` optionally pin the initial noise
    and the (T, R, n_motions, D) per-step z, reused across windows as the
    reference reuses its noise. ``resident`` is ``sample``'s (K2 where its
    gate holds).

    ``process_group`` (a ``torch.distributed`` group, e.g. the layout's
    data group; the port of ``mesh=``, ``msmd_tpu/inference_lib.py``:47,
    :76-93): each of its ranks samples ``n_repetitions / world`` of the
    repetitions (``n_repetitions`` must be a multiple of the group's size,
    as JAX asserts) and every rank returns all of them. Every rank draws
    the noise of all repetitions from ``generator`` (in the same state on
    every rank) and keeps its rows, so the draws are the unsharded call's.
    Each rank runs its own kernels: the route its batch picks may differ
    from the unsharded call's (K1's per-entry or flat mode, K3 at one
    repetition a rank), which then agree to bf16 rounding."""
    dev = resolve_device(device)
    cfg = model.cfg
    audio = torch.as_tensor(audio, dtype=torch.float32, device=dev)
    clip_len = int(len(audio) / 16000 * cfg.fps)
    stride = cfg.n_motions
    n_audio_samples = round(audio_unit * cfg.n_motions)
    n_subdivision = 1 if clip_len <= cfg.n_motions else math.ceil(clip_len / stride)
    n_padding_audio_samples = n_audio_samples * n_subdivision - len(audio)
    n_padding_frames = math.ceil(n_padding_audio_samples / audio_unit)
    if n_padding_audio_samples > 0:
        audio = torch.nn.functional.pad(audio, (0, n_padding_audio_samples))

    audio_feat = model.extract_audio_feature(audio[None], cfg.n_motions * n_subdivision)

    R = n_repetitions
    rows = None
    if process_group is not None:
        import torch.distributed as dist

        world, rank = dist.get_world_size(process_group), dist.get_rank(process_group)
        if generator is None:
            raise ValueError("sharded sampling draws every rank's noise from one generator: pass generator")
        if R % world:
            raise ValueError(f"n_repetitions={R} is not a multiple of the {world} ranks of the process group")
        rows = SampleRows(generator, torch.arange(rank * (R // world), (rank + 1) * (R // world)), R)
        if motion_at_T is not None:
            motion_at_T = torch.as_tensor(motion_at_T)[rows.index]
        if noise_override is not None:
            noise_override = torch.as_tensor(noise_override)[:, rows.index]

    def expand(x):
        x = torch.as_tensor(x, device=dev)
        x = x.expand(R, *x.shape[1:]) if x.shape[0] == 1 and R > 1 else x
        return x if rows is None else x[rows.index.to(dev)]

    shape_in = expand(torch.as_tensor(shape_coef, dtype=torch.float32))
    coef_list = []
    prev_motion = prev_audio = noise = None
    for i in range(n_subdivision):
        start = i * stride
        audio_in = expand(audio_feat[:, start: start + cfg.n_motions])
        indicator = None
        if cfg.use_indicator:
            indicator = torch.ones(R if rows is None else len(rows.index), cfg.n_motions, device=dev)
            if i == n_subdivision - 1 and n_padding_frames > 0:
                indicator[:, -n_padding_frames:] = 0
        style = style_feats[i] if isinstance(style_feats, (list, tuple)) else style_feats
        if style is not None:
            style = expand(style)
        motion, noise, prev_audio_full = sample(
            model, audio_in, shape_in, style, prev_motion_feat=prev_motion, prev_audio_feat=prev_audio,
            motion_at_T=motion_at_T if i == 0 else noise, indicator=indicator,
            cfg_mode=cfg_mode, cfg_cond=cfg_cond, cfg_scale=cfg_scale, dynamic_threshold=dynamic_threshold,
            noise_override=noise_override, generator=generator, device=dev, resident=resident, rows=rows,
        )
        prev_motion = motion[:, -cfg.n_prev_motions:]
        prev_audio = prev_audio_full[:, -cfg.n_prev_motions:]
        if i == n_subdivision - 1 and n_padding_frames > 0:
            motion = motion[:, :-n_padding_frames]
        count("msmd.frames.sampled", motion.shape[0] * cfg.n_motions)
        count("msmd.frames.kept", motion.shape[0] * motion.shape[1])
        coef_list.append(motion)
    coefs = torch.cat(coef_list, dim=1)
    if rows is None:
        return coefs
    from msmd_tpu_torch.parallel.mesh import gather_rows

    return gather_rows(coefs, R, process_group)


def load_model(model_root, model_name: str, iter_num: str, audio_config: Optional[AudioEncoderConfig] = None,
               device="cuda"):
    """Load ``args.json`` and a reference checkpoint from the experiment
    layout ``<root>/DPT/<name>/{args.json, checkpoints/iter_<it>.pt}``
    (or ``<root>/<name>/...``). The model is built in f32, as the JAX
    package builds it, and the style encoder is the one
    ``cfg.style_enc_model_style`` names (``check_style_width`` refuses the
    VAE, whose z is wider than the denoiser's style input).

    Returns (model, style_enc, cfg), both modules on ``device`` in eval
    mode."""
    from msmd_tpu_torch.interop import (load_flax_params, load_reference_pt, reference_msmd_to_flax,
                                        reference_style_enc_to_flax)
    from msmd_tpu_torch.models.style_encoder import check_style_width, get_style_encoder

    dev = resolve_device(device)
    exp_dir = Path(model_root) / "DPT" / model_name
    if not exp_dir.exists():
        exp_dir = Path(model_root) / model_name
    cfg = MSMDConfig.load_args_json(exp_dir)
    if audio_config is None and cfg.audio_encoder_config is not None:
        audio_config = audio_config_from_dict(cfg.audio_encoder_config)
    ckpt_path = exp_dir / "checkpoints" / f"iter_{iter_num}.pt"
    if not ckpt_path.exists():
        available = sorted(p.name for p in (exp_dir / "checkpoints").glob("iter_*.pt"))
        raise FileNotFoundError(
            f"Checkpoint not found: {ckpt_path}"
            + (f" — available: {available}" if available else " — no iter_*.pt checkpoints in this experiment"))
    _, model_sd, style_sd, _ = load_reference_pt(ckpt_path)
    model = get_diffusion_model(cfg, audio_config=audio_config, device=dev)
    load_flax_params(model, reference_msmd_to_flax(model_sd, cfg))
    style_tree = reference_style_enc_to_flax(style_sd)
    in_dim = style_tree["input_layers"]["conv_0"]["kernel"].shape[1]  # 54 or 67, as the checkpoint was trained
    style_enc = get_style_encoder(cfg, cfg.style_enc_model_style, input_dim=in_dim).to(dev).eval()
    check_style_width(cfg, style_enc)
    load_flax_params(style_enc, style_tree)
    return model, style_enc, cfg


def load_style_clip(expression_code_path, head_rot_path, coef_stats: dict, original_fps: float = 30,
                    target_fps: float = 25):
    """Load, normalise and fps-resample a style clip. Returns
    (motion (1, T, 67) np.float32, shape (1, 100) zeros)."""

    def load_arr(path):
        with open(path, "rb") as f:
            arr = pickle.load(f)
        if hasattr(arr, "detach"):
            arr = arr.detach().cpu().numpy()
        return np.asarray(arr, np.float32)

    exp = load_arr(expression_code_path)
    head = load_arr(head_rot_path)
    to_np = lambda v: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
    exp = (exp - to_np(coef_stats["exp_mean"])) / (to_np(coef_stats["exp_std"]) + 1e-9)
    head = (head - to_np(coef_stats["pose_mean"])) / (to_np(coef_stats["pose_std"]) + 1e-9)
    if original_fps is not None and original_fps != target_fps:
        n = exp.shape[0]
        new_n = int(round(n / original_fps * target_fps))
        x = np.linspace(0, 1, n)
        xnew = np.linspace(0, 1, new_n)
        interp = lambda a: np.stack([np.interp(xnew, x, a[:, j]) for j in range(a.shape[1])], axis=1)
        exp, head = interp(exp), interp(head)
    motion = np.concatenate([exp, head], axis=-1)[None].astype(np.float32)
    return motion, np.zeros((1, 100), np.float32)


def load_audio_16k(path) -> np.ndarray:
    """Load audio at 16 kHz mono (librosa if present, else soundfile,
    else scipy's wavfile with linear resampling)."""
    try:
        import librosa

        return librosa.load(path, sr=16000)[0].astype(np.float32)
    except ImportError:
        pass
    try:
        import soundfile as sf

        data, sr = sf.read(path, dtype="float32")
    except ImportError:
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if sr != 16000:
        n_new = int(round(len(data) / sr * 16000))
        x = np.linspace(0, 1, len(data))
        data = np.interp(np.linspace(0, 1, n_new), x, data).astype(np.float32)
    return data
