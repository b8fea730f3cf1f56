"""The two-clip training step (the port of ``msmd_tpu/train/loop.py``;
reference: training_script.py:49-241).

One step: the VAE style of both windows (+ KL); per clip a cross-style
swap and an end-truncation with indicator masks; two chained MSMD
forwards, where clip 0's full-window motion and audio features seed
clip 1's previous window; the weighted loss sum; one Adam update of the
trainable parameters (the audio encoder's frozen parts stay as they are).

Random draws. The batch-level flags (cross-style swap, whether a clip is
truncated) and the per-sample truncation ends come from a host
``torch.Generator``, as the reference draws them with ``np.random``
(training_script.py:115-128), so no step waits on the device to branch.
Everything else (dropout, SpecAugment, CFG drops, timesteps, noise, the
style draw) comes from the model's ``torch.Generator`` on the device. The
no-grad re-extract of clip 0's full audio for the carry runs only when
clip 0 was truncated.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from msmd_tpu_torch.config import MSMDConfig
from msmd_tpu_torch.losses import (compute_kl_loss, compute_loss_no_vert, load_loss_weights,
                                   truncate_motion_coef_and_audio)
from msmd_tpu_torch.models.audio import audio_param_trainable
from msmd_tpu_torch.train.scheduler import make_schedule

Batch = Dict[str, torch.Tensor]


def trainable(cfg: MSMDConfig, name: str) -> bool:
    """Whether MSMD parameter ``name`` trains (``loop.py::trainable_mask``):
    everything but the audio encoder's frozen parts."""
    prefix = "audio_encoder."
    if name.startswith(prefix):
        return audio_param_trainable(cfg.audio_model, name[len(prefix):])
    return True


def freeze(cfg: MSMDConfig, model: nn.Module) -> None:
    """``requires_grad=False`` on the frozen parameters of ``model``."""
    for name, p in model.named_parameters():
        p.requires_grad_(trainable(cfg, name))


class TrainOptimizer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) on the trainable parameters. The
    gradients of ``gradient_accumulation_steps`` micro-steps are summed
    (the reference's plain ``loss.backward()`` per micro-step,
    training_script.py:195-201), and update u (0-based) runs at the rate
    the scheduler has after ``u * accum + accum - 1`` micro-steps
    (``loop.py::stretched_schedule``)."""

    def __init__(self, cfg: MSMDConfig, params: Iterable[torch.nn.Parameter]):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_schedule(cfg)
        self.accum = max(int(cfg.gradient_accumulation_steps), 1)
        self.adam = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.micro = 0
        self.updates = 0

    def lr(self, update: int) -> float:
        return float(self.schedule(update * self.accum + self.accum - 1))

    def step(self) -> bool:
        """Count one micro-step whose gradients are in ``.grad``; every
        ``accum``-th call applies the update and clears them."""
        self.micro += 1
        if self.micro % self.accum:
            return False
        for group in self.adam.param_groups:
            group["lr"] = self.lr(self.updates)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "micro": self.micro, "updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.micro, self.updates = int(state["micro"]), int(state["updates"])


def two_clip_loss(
    cfg: MSMDConfig,
    model: nn.Module,
    style_enc: nn.Module,
    batch: Batch,
    generator: torch.Generator,
    host_generator: Optional[torch.Generator] = None,
    train: bool = True,
    do_ignore_style: bool = False,
    eval_always_cross_style: bool = False,
    noise_pair: Optional[Sequence[torch.Tensor]] = None,
    time_steps: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, per-term dict) of the two-clip loop of train() / test()
    (training_script.py:109-196, 270-340). ``noise_pair`` and
    ``time_steps`` fix each clip's q-sample noise and timesteps (test
    hooks)."""
    if cfg.two_clip_batch:
        raise NotImplementedError("two_clip_batch is not ported; the sequential two-clip loss is")
    is_hdtf = cfg.dataset_type[:9] == "HDTF_TFHP" or cfg.dataset_type == "flame_mead_ravdess"
    if cfg.use_vertex_space and is_hdtf:
        raise NotImplementedError("the vertex-space loss (use_vertex_space on HDTF layouts) is not ported")
    if train and host_generator is None:
        raise ValueError("training draws its batch-level flags from host_generator")
    weights = load_loss_weights(cfg)
    B = batch["motion_0"].shape[0]
    dev = batch["motion_0"].device

    motions = [batch["motion_0"], batch["motion_1"]]
    style_out = [style_enc(torch.zeros_like(m) if do_ignore_style else m, generator, train) for m in motions]
    shape_coef = batch["shape_0"][:, 0]  # first frame (training_script.py:91-93)
    input_shape = torch.zeros_like(shape_coef) if cfg.do_ignore_shape else shape_coef

    losses = {k: torch.zeros((), device=dev) for k in weights}
    prev_motion = prev_audio = None
    for i in range(2):
        audio, motion = batch[f"audio_{i}"], motions[i]
        style = style_out[i][0]
        if cfg.use_cross_style:  # one flag per batch (training_script.py:115-118)
            if train:
                if float(torch.rand((), generator=host_generator)) < cfg.prob_cross_style:
                    style = style_out[1 - i][0]
            elif eval_always_cross_style:
                style = style_out[1 - i][0]

        # truncation, one flag per batch (training_script.py:123-128); never in eval
        audio_in, motion_in, end_idx, do_trunc = audio, motion, None, False
        if train:
            end_rand = torch.randint(1, cfg.n_motions, (B,), generator=host_generator)
            do_trunc = float(torch.rand((), generator=host_generator)) < (cfg.trunc_prob1 if i == 0 else cfg.trunc_prob2)
            if do_trunc:
                end_idx = end_rand.to(dev, non_blocking=True)
                audio_in, motion_in = truncate_motion_coef_and_audio(audio, motion, end_idx, cfg.audio_unit,
                                                                     cfg.pad_mode)
        if end_idx is None:
            end_idx = torch.full((B,), cfg.n_motions, dtype=torch.int64, device=dev)
        indicator = None
        if cfg.use_indicator:
            indicator = (torch.arange(cfg.n_motions, device=dev)[None, :] < end_idx[:, None]).to(torch.float32)

        kw = dict(indicator=indicator, train_with_cfg=not cfg.do_ignore_cfg, generator=generator, train=train,
                  noise=noise_pair[i] if noise_pair is not None else None,
                  time_step=time_steps[i] if time_steps is not None else None)
        if i == 0:
            eps, target, _, audio_feat_det = model(motion_in, audio_in, input_shape, style, **kw)
            # the carry (training_script.py:148-158): the FULL window's last
            # frames; its audio features re-extracted when clip 0 was cut
            prev_motion = motion[:, -cfg.n_prev_motions:].detach()
            full_audio_feat = audio_feat_det
            if do_trunc:
                with torch.no_grad():
                    full_audio_feat = model.extract_audio_feature(audio)
            prev_audio = full_audio_feat[:, -cfg.n_prev_motions:]
        else:
            eps, target, _, _ = model(motion_in, audio_in, input_shape, style, prev_motion_feat=prev_motion,
                                      prev_audio_feat=prev_audio, **kw)

        terms = compute_loss_no_vert(cfg, i == 0, shape_coef, motion_in, eps, target.float(), prev_motion, end_idx)
        terms["kl_div"] = compute_kl_loss(style_out[i][1].float(), style_out[i][2].float())
        for k, v in terms.items():
            if k in weights and weights[k] > 0:
                losses[k] = losses[k] + v

    total = sum(losses[k] * weights[k] for k in losses if weights[k] > 0)
    metrics = {k: v.detach() for k, v in losses.items() if weights[k] > 0}
    metrics["loss"] = total.detach()
    return total, metrics


def batch_to(batch: Dict, device) -> Batch:
    """A loader's NumPy batch as float32 tensors on ``device`` (scalars
    such as the audio statistics are dropped)."""
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device, non_blocking=True)
            for k, v in batch.items() if getattr(v, "ndim", 0) >= 2}


def train_step(cfg: MSMDConfig, model: nn.Module, style_enc: nn.Module, opt: TrainOptimizer, batch: Batch,
               generator: torch.Generator, host_generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One micro-step: loss, backward, and the optimizer's step (an update
    every ``gradient_accumulation_steps`` calls). Returns the metrics as
    device scalars: nothing here waits on the device."""
    total, metrics = two_clip_loss(cfg, model, style_enc, batch, generator, host_generator, train=True)
    total.backward()
    opt.step()
    return metrics


@torch.no_grad()
def eval_step(cfg: MSMDConfig, model: nn.Module, style_enc: nn.Module, batch: Batch, generator: torch.Generator,
              do_ignore_style: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's test(): eval mode, cross-style always on when
    enabled (training_script.py:244-403)."""
    _, metrics = two_clip_loss(cfg, model, style_enc, batch, generator, train=False,
                               do_ignore_style=do_ignore_style, eval_always_cross_style=cfg.use_cross_style)
    return metrics
