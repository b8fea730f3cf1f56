"""The two-clip training step (the port of ``msmd_tpu/train/loop.py``;
reference: training_script.py:49-241).

One step: the VAE style of both windows (+ KL); per clip a cross-style
swap and an end-truncation with indicator masks; two chained MSMD
forwards, where clip 0's full-window motion and audio features seed
clip 1's previous window (or, with ``two_clip_batch``, one 2B-row
forward of both clips); the per-clip losses, in parameter space or, with
``use_vertex_space`` on an HDTF layout, on FLAME vertices; the weighted
loss sum; one Adam update of the trainable parameters (the audio
encoder's frozen parts stay as they are).

Random draws. The batch-level flags (cross-style swap, whether a clip is
truncated) and the per-sample truncation ends come from a host
``torch.Generator``, as the reference draws them with ``np.random``
(training_script.py:115-128), so no step waits on the device to branch.
Everything else (dropout, SpecAugment, CFG drops, timesteps, noise, the
style draw) comes from the model's ``torch.Generator`` on the device. The
no-grad re-extract of clip 0's full audio for the carry runs only when
clip 0 was truncated.

Data parallelism (``rows``, a ``layers.SampleRows``: this rank's rows of
the global batch). Every per-sample draw is made for the whole global
batch and the rank keeps its rows: the truncation ends from
``host_generator``, the timesteps, noise, CFG drops and the style sample
from the shared generator in ``rows``; ``generator`` then drives only the
draws inside the modules (dropout, SpecAugment, K7's seeds), a stream of
the rank's own. The trainer averages the gradients over the ranks, so
each rank's loss is its share of the global loss times the rank count:
a plain mean is over the rank's rows (the ranks hold as many each); a
masked mean (a truncated window's frames) divides the sum over the
rank's frames by the global batch's count over the rank count, which
every rank knows from the global ends (``losses.ShareMask``), so the
step takes the global batch's masked mean, as JAX's one-program step
does; the KL term, a sum over the batch, is scaled by the rank count.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from msmd_tpu_torch.config import MSMDConfig, is_hdtf
from msmd_tpu_torch.losses import (compute_kl_loss, compute_loss, compute_loss_no_vert, load_loss_weights,
                                   truncate_motion_coef_and_audio)
from msmd_tpu_torch.models.audio import audio_param_trainable
from msmd_tpu_torch.models.layers import SampleRows
from msmd_tpu_torch.train.scheduler import make_schedule
from msmd_tpu_torch.utils.profiling import span

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
    (``loop.py::stretched_schedule``). ``reduce_grads`` (data parallelism:
    ``parallel.mesh.Layout.average_grads``) runs on the summed gradients
    before each update."""

    def __init__(self, cfg: MSMDConfig, params: Iterable[torch.nn.Parameter],
                 reduce_grads: Optional[Callable[[Sequence[torch.Tensor]], None]] = None):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_schedule(cfg)
        self.accum = max(int(cfg.gradient_accumulation_steps), 1)
        self.adam = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.reduce_grads = reduce_grads
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
        if self.reduce_grads is not None:
            self.reduce_grads(self.params)
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


def _clip_inputs(cfg: MSMDConfig, batch: Batch, i: int, styles, train: bool,
                 host_generator: Optional[torch.Generator], eval_always_cross_style: bool,
                 rows: Optional[SampleRows] = None):
    """Clip i's style (cross-style swap), truncated audio and motion, end
    index, indicator, whether it was truncated, and the global batch's
    ends under ``rows`` when it was (else None). The batch-level flags and
    the truncation ends come from ``host_generator`` in the reference's
    order (training_script.py:115-128); under ``rows`` the ends are drawn
    for the global batch."""
    audio, motion = batch[f"audio_{i}"], batch[f"motion_{i}"]
    B, dev = motion.shape[0], motion.device
    style = styles[i]
    if cfg.use_cross_style:  # one flag per batch
        if train:
            if float(torch.rand((), generator=host_generator)) < cfg.prob_cross_style:
                style = styles[1 - i]
        elif eval_always_cross_style:
            style = styles[1 - i]
    # truncation, one flag per batch; never in eval
    end_idx = end_all = None
    do_trunc = False
    if train:
        end_rand = torch.randint(1, cfg.n_motions, (B if rows is None else rows.total,), generator=host_generator)
        if rows is not None:
            end_all, end_rand = end_rand, end_rand[rows.index]
        do_trunc = float(torch.rand((), generator=host_generator)) < (cfg.trunc_prob1 if i == 0 else cfg.trunc_prob2)
        if do_trunc:
            end_idx = end_rand.to(dev, non_blocking=True)
            end_all = None if end_all is None else end_all.to(dev, non_blocking=True)
            audio, motion = truncate_motion_coef_and_audio(audio, motion, end_idx, cfg.audio_unit, cfg.pad_mode)
    if end_idx is None:
        end_idx, end_all = torch.full((B,), cfg.n_motions, dtype=torch.int64, device=dev), None
    indicator = None
    if cfg.use_indicator:
        indicator = (torch.arange(cfg.n_motions, device=dev)[None, :] < end_idx[:, None]).to(torch.float32)
    return style, audio, motion, end_idx, indicator, do_trunc, end_all


def _clip_terms(cfg: MSMDConfig, i: int, shape_coef, motion_in, eps, target, prev_motion, end_idx, end_all, mu,
                logvar, flame, coef_stats, kl_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Clip i's loss terms: vertex space (``compute_loss``, the FLAME decode
    through ``flame``) with ``use_vertex_space`` on an HDTF layout, else
    parameter space (``end_all``: the global batch's ends, under data
    parallelism); and the style KL (a sum over the rows, times
    ``kl_scale``)."""
    if cfg.use_vertex_space and is_hdtf(cfg.dataset_type):
        terms = compute_loss(cfg, i == 0, shape_coef, motion_in, eps, target.float(), prev_motion, coef_stats, flame,
                             end_idx, end_all)
    else:
        terms = compute_loss_no_vert(cfg, i == 0, shape_coef, motion_in, eps, target.float(), prev_motion, end_idx,
                                     end_all)
    terms["kl_div"] = compute_kl_loss(mu.float(), logvar.float())
    if kl_scale != 1.0:
        terms["kl_div"] = terms["kl_div"] * kl_scale
    return terms


def _style(style_enc: nn.Module, x: torch.Tensor, generator, train: bool, rows: Optional[SampleRows]):
    """(z, mu, logvar) of the style encoder; under ``rows`` its sample's
    draw is the rank's rows of the global one."""
    if rows is None:
        return style_enc(x, generator, train)
    d = style_enc.d_style
    eps = rows.draw(lambda n, g: torch.randn((n, d), generator=g, device=g.device))
    return style_enc(x, generator, train, eps=eps)


def _total(weights, clip_terms, dev):
    losses = {k: torch.zeros((), device=dev) for k in weights}
    for terms in clip_terms:
        for k, v in terms.items():
            if k in weights and weights[k] > 0:
                losses[k] = losses[k] + v
    total = sum(losses[k] * weights[k] for k in losses if weights[k] > 0)
    metrics = {k: v.detach() for k, v in losses.items() if weights[k] > 0}
    metrics["loss"] = total.detach()
    return total, metrics


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
    flame=None,
    coef_stats=None,
    rows: Optional[SampleRows] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, per-term dict) of the two-clip loop of train() / test()
    (training_script.py:109-196, 270-340). ``noise_pair`` and
    ``time_steps`` fix each clip's q-sample noise and timesteps (test
    hooks). With ``use_vertex_space`` on an HDTF layout the loss decodes
    FLAME vertices through ``flame`` (a ``FusedFlame``: K5 and K5 bwd on
    the card; or a ``FlameModel``) from coefficients denormalised by
    ``coef_stats``. With ``cfg.two_clip_batch`` both clips run as one
    2B-row forward (``_two_clip_loss_batched``). ``rows``: ``batch`` is
    this rank's rows of a data-parallel batch (the module docstring)."""
    if train and host_generator is None:
        raise ValueError("training draws its batch-level flags from host_generator")
    if cfg.use_vertex_space and is_hdtf(cfg.dataset_type) and flame is None and (cfg.l_vert > 0 or cfg.l_vel > 0):
        raise ValueError("the vertex-space loss decodes FLAME vertices: pass flame")
    args = (cfg, model, style_enc, batch, generator, host_generator, train, do_ignore_style,
            eval_always_cross_style, noise_pair, time_steps, flame, coef_stats, rows)
    if cfg.two_clip_batch:
        return _two_clip_loss_batched(*args)
    weights = load_loss_weights(cfg)
    dev = batch["motion_0"].device
    motions = [batch["motion_0"], batch["motion_1"]]
    kl_scale = 1.0 if rows is None else rows.total / len(rows.index)
    style_out = [_style(style_enc, torch.zeros_like(m) if do_ignore_style else m, generator, train, rows)
                 for m in motions]
    shape_coef = batch["shape_0"][:, 0]  # first frame (training_script.py:91-93)
    input_shape = torch.zeros_like(shape_coef) if cfg.do_ignore_shape else shape_coef

    clip_terms = []
    prev_motion = prev_audio = None
    for i in range(2):
        style, audio_in, motion_in, end_idx, indicator, do_trunc, end_all = _clip_inputs(
            cfg, batch, i, [s[0] for s in style_out], train, host_generator, eval_always_cross_style, rows)
        kw = dict(indicator=indicator, train_with_cfg=not cfg.do_ignore_cfg, generator=generator, train=train,
                  noise=noise_pair[i] if noise_pair is not None else None,
                  time_step=time_steps[i] if time_steps is not None else None, rows=rows)
        if i == 0:
            eps, target, _, audio_feat_det = model(motion_in, audio_in, input_shape, style, **kw)
            # the carry (training_script.py:148-158): the FULL window's last
            # frames; its audio features re-extracted when clip 0 was cut
            prev_motion = motions[0][:, -cfg.n_prev_motions:].detach()
            full_audio_feat = audio_feat_det
            if do_trunc:
                with torch.no_grad():
                    full_audio_feat = model.extract_audio_feature(batch["audio_0"])
            prev_audio = full_audio_feat[:, -cfg.n_prev_motions:]
        else:
            eps, target, _, _ = model(motion_in, audio_in, input_shape, style, prev_motion_feat=prev_motion,
                                      prev_audio_feat=prev_audio, **kw)
        clip_terms.append(_clip_terms(cfg, i, shape_coef, motion_in, eps, target, prev_motion, end_idx, end_all,
                                      style_out[i][1], style_out[i][2], flame, coef_stats, kl_scale))
    return _total(weights, clip_terms, dev)


def _two_clip_loss_batched(cfg: MSMDConfig, model: nn.Module, style_enc: nn.Module, batch: Batch,
                           generator: torch.Generator, host_generator, train: bool, do_ignore_style: bool,
                           eval_always_cross_style: bool, noise_pair, time_steps, flame, coef_stats, rows):
    """The two-clip loss as one 2B-row forward (``cfg.two_clip_batch``, the
    port of ``msmd_tpu/train/loop.py``:278-450): the style encoder, the
    audio encoder and the denoiser each run once on both clips stacked on
    the batch axis. Legal because clip 1's carry takes clip 0's audio
    features only (training_script.py:148-158), never clip 0's denoiser
    output; clip 0's rows get the learned start features, expanded from
    the parameters (gradients reach them as through the module's default).
    The loss stays per clip. The device draws are one 2B-row draw per site
    in place of two B-row draws, so the augmentations are equal in
    distribution, not in bits; with fixed noise and timesteps in eval the
    loss and its gradients equal the sequential path's."""
    weights = load_loss_weights(cfg)
    B, dev, n_prev = batch["motion_0"].shape[0], batch["motion_0"].device, cfg.n_prev_motions
    motion_cat = torch.cat([batch["motion_0"], batch["motion_1"]], dim=0)
    rows2 = None if rows is None else rows.twice()  # the 2B rows: both clips of the global batch
    kl_scale = 1.0 if rows is None else rows.total / len(rows.index)
    z, mu, logvar = _style(style_enc, torch.zeros_like(motion_cat) if do_ignore_style else motion_cat, generator,
                           train, rows2)
    shape_coef = batch["shape_0"][:, 0]
    input_shape = torch.zeros_like(shape_coef) if cfg.do_ignore_shape else shape_coef

    clips = [_clip_inputs(cfg, batch, i, [z[:B], z[B:]], train, host_generator, eval_always_cross_style, rows)
             for i in range(2)]
    styles, audio_ins, motion_ins, end_idxs, indicators, do_truncs, end_alls = zip(*clips)
    audio_feat = model.extract_audio_feature(torch.cat(audio_ins, dim=0), rng=generator if train else None)

    # clip 1's carry: the FULL window's last frames, and its audio features
    # re-extracted (no grad) from the uncut audio when clip 0 was cut
    prev_motion = batch["motion_0"][:, -n_prev:].detach()
    full_audio_feat = audio_feat[:B].detach()
    if do_truncs[0]:
        with torch.no_grad():
            full_audio_feat = model.extract_audio_feature(batch["audio_0"])
    start_m = model.start_motion_feat.expand(B, *model.start_motion_feat.shape[1:])
    start_a = model.start_audio_feat.expand(B, *model.start_audio_feat.shape[1:])
    prev_motion_cat = torch.cat([start_m, prev_motion.to(start_m.dtype)], dim=0)
    prev_audio_cat = torch.cat([start_a, full_audio_feat[:, -n_prev:].to(start_a.dtype)], dim=0)
    cat = lambda ts: None if ts is None or ts[0] is None else torch.cat([t.to(dev) for t in ts], dim=0)
    eps, target, _, _ = model(torch.cat(motion_ins, dim=0), audio_feat, torch.cat([input_shape, input_shape], dim=0),
                              torch.cat(styles, dim=0), prev_motion_feat=prev_motion_cat,
                              prev_audio_feat=prev_audio_cat, indicator=cat(indicators),
                              train_with_cfg=not cfg.do_ignore_cfg, generator=generator, train=train,
                              noise=cat(noise_pair), time_step=cat(time_steps), rows=rows2)
    halves = lambda t, i: t[i * B:(i + 1) * B]
    clip_terms = [_clip_terms(cfg, i, shape_coef, motion_ins[i], halves(eps, i), halves(target, i), prev_motion,
                              end_idxs[i], end_alls[i], halves(mu, i), halves(logvar, i), flame, coef_stats,
                              kl_scale)
                  for i in range(2)]
    return _total(weights, clip_terms, dev)


def batch_to(batch: Dict, device) -> Batch:
    """A loader's NumPy batch as float32 tensors on ``device`` (scalars
    such as the audio statistics are dropped)."""
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device, non_blocking=True)
            for k, v in batch.items() if getattr(v, "ndim", 0) >= 2}


def train_step(cfg: MSMDConfig, model: nn.Module, style_enc: nn.Module, opt: TrainOptimizer, batch: Batch,
               generator: torch.Generator, host_generator: torch.Generator, flame=None,
               coef_stats=None, rows: Optional[SampleRows] = None) -> Dict[str, torch.Tensor]:
    """One micro-step: loss, backward, and the optimizer's step (an update
    every ``gradient_accumulation_steps`` calls). Returns the metrics as
    device scalars: nothing here waits on the device. ``rows``: ``batch``
    is this rank's rows of a data-parallel batch (module docstring)."""
    with span("msmd.train.loss"):
        total, metrics = two_clip_loss(cfg, model, style_enc, batch, generator, host_generator, train=True,
                                       flame=flame, coef_stats=coef_stats, rows=rows)
    with span("msmd.train.backward"):
        total.backward()
    with span("msmd.train.optimizer"):
        opt.step()
    return metrics


@torch.no_grad()
def eval_step(cfg: MSMDConfig, model: nn.Module, style_enc: nn.Module, batch: Batch, generator: torch.Generator,
              do_ignore_style: bool = False, flame=None, coef_stats=None,
              rows: Optional[SampleRows] = None) -> Dict[str, torch.Tensor]:
    """The reference's test(): eval mode, cross-style always on when
    enabled (training_script.py:244-403)."""
    _, metrics = two_clip_loss(cfg, model, style_enc, batch, generator, train=False,
                               do_ignore_style=do_ignore_style, eval_always_cross_style=cfg.use_cross_style,
                               flame=flame, coef_stats=coef_stats, rows=rows)
    return metrics
