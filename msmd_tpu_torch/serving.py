"""Serving: a loaded speech-to-motion generator and a continuous
multi-stream batcher (the port of ``msmd_tpu/serving.py``).

``MotionGenerator`` wraps model loading, style encoding, windowed
sampling and denormalisation in one object for a serving process, the
programmatic twin of the ``python -m msmd_tpu_torch.inference`` CLI. The
style draw and the sampler take ``torch.Generator``s seeded from
``seed``, so a seed gives the same motion on every call. The model of
an experiment is f32, as in the JAX package, so ``generate`` runs the
plain modules; the sampler kernels serve a bf16 model
(``sample``/``infer_coeffs``).

``StreamingBatcher`` serves many concurrent live streams: every round
runs the ready 4 s window of up to ``max_slots`` streams as one
fixed-shape ``sample`` call, with the autoregressive carries kept on the
card in slot-indexed tensors and only the generated motion fetched. At a
bf16 model the round's shape picks the decoder kernel: 48 slots (Be = 96
with two CFG entries) run K1 per-entry (K2 with ``resident=True``), 2
slots (Be = 4) K1's flat-mask mode, 1 slot the batch-1 kernel K3.
``MotionGenerator.generate(process_group=...)`` splits a request's
repetitions over the ranks of a process group (one process per device);
the batcher serves one device.

Example:
    gen = MotionGenerator.from_experiment(root, name, "0470000", coef_stats)
    gen.warmup(max_seconds=20)
    exp_code, head_rot = gen.generate(audio_16k, style_motion, seed=0)

    bat = StreamingBatcher(model, max_slots=48)
    bat.add_stream("a", seed=1, style=style_embedding)
    bat.push_audio("a", samples_16k_zscored, final=True)
    bat.run_until_drained()
    motion = bat.output("a")  # (frames, 67)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from msmd_tpu_torch.device import resolve_device
from msmd_tpu_torch.inference_lib import infer_coeffs, load_model
from msmd_tpu_torch.models.diffusion import sample
from msmd_tpu_torch.utils.profiling import count, span


class MotionGenerator:
    def __init__(self, model, style_enc, cfg, coef_stats: Dict[str, np.ndarray], device="cuda"):
        self.model, self.style_enc, self.cfg = model, style_enc, cfg
        self.device = resolve_device(device)
        to_np = lambda v: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
        self.coef_stats = {k: to_np(v) for k, v in coef_stats.items()}

    @classmethod
    def from_experiment(cls, model_root, model_name: str, iter_num: str, coef_stats, audio_config=None,
                        device="cuda") -> "MotionGenerator":
        model, style_enc, cfg = load_model(model_root, model_name, iter_num, audio_config=audio_config,
                                           device=device)
        return cls(model, style_enc, cfg, coef_stats, device=device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def encode_style(self, style_motion: np.ndarray, seed: int = 0, normalized: bool = False) -> torch.Tensor:
        """Style embedding (1, d_style) from a motion clip (T, 67): one
        draw from the style encoder on the first 100 frames, like the
        reference (inference.py:239)."""
        m = np.asarray(style_motion, np.float32)
        if not normalized:
            s = self.coef_stats
            exp = (m[:, :-3] - s["exp_mean"]) / (s["exp_std"] + 1e-9)
            rot = (m[:, -3:] - s["pose_mean"]) / (s["pose_std"] + 1e-9)
            m = np.concatenate([exp, rot], axis=-1)
        clip = torch.as_tensor(m[None, :100].astype(np.float32), device=self.device)
        return self.style_enc.sample(clip, generator=self._generator(seed))

    def generate(self, audio_16k: np.ndarray, style_motion: Optional[np.ndarray] = None, n_repetitions: int = 1,
                 cfg_scale: float = 1.4, seed: int = 0, style_normalized: bool = False,
                 process_group=None) -> Tuple[np.ndarray, np.ndarray]:
        """16 kHz audio (L,) -> (denormalised expression codes (R, T, 64),
        head rotations (R, T, 3)). ``process_group``: the repetitions split
        over its ranks, each rank returning all of them
        (``infer_coeffs``; ``msmd_tpu/serving.py``:84-98's ``mesh``)."""
        audio = np.asarray(audio_16k, np.float32)
        audio = (audio - audio.mean()) / (audio.std() + 1e-5)
        style = self.encode_style(style_motion, seed, style_normalized) if style_motion is not None else None
        coefs = infer_coeffs(
            self.model, audio, torch.zeros(1, 100), audio_unit=self.cfg.audio_unit, style_feats=style,
            n_repetitions=n_repetitions, cfg_scale=cfg_scale, dynamic_threshold=None,
            generator=self._generator(seed), device=self.device, process_group=process_group,
        ).float().cpu().numpy()
        s = self.coef_stats
        exp_code = coefs[..., :-3] * s["exp_std"] + s["exp_mean"]
        head_rot = coefs[..., -3:] * s["pose_std"] + s["pose_mean"]
        return exp_code, head_rot

    def warmup(self, max_seconds: float = 12.0, n_repetitions: int = 1) -> None:
        """Run the first-window and continuation paths once (a one- or
        two-window clip of silence), so that kernel builds and one-time
        allocations stay out of the first request."""
        cfg = self.cfg
        max_sub = max(1, math.ceil(int(max_seconds * cfg.fps) / cfg.n_motions))
        samples = int(cfg.n_audio_samples * min(2, max_sub))
        self.generate(np.zeros(samples, np.float32), None, n_repetitions=n_repetitions, seed=0)


# ===========================================================================
# Continuous multi-stream micro-batching
# ===========================================================================

SEED_LIMIT = 2 ** 31  # stream seeds and window indices stay below this


def draw_seed(seed: int, window: int, which: int) -> int:
    """The ``torch.Generator`` seed of a stream's draw: ``which`` 0 is
    window ``window``'s motion_at_T, 1 its per-step z. The value
    ``seed * 2**32 + window * 2 + which`` is distinct for every
    (seed, window, which) with 0 <= seed, window < 2**31."""
    if not (0 <= seed < SEED_LIMIT and 0 <= window < SEED_LIMIT and which in (0, 1)):
        raise ValueError(f"draw_seed: need 0 <= seed, window < 2**31 and which in (0, 1), got "
                         f"{(seed, window, which)}")
    return (seed << 32) | (window << 1) | which


@dataclass
class _Stream:
    seed: int                            # the stream's draws derive from it (draw_seed)
    style: np.ndarray                    # (d_style,)
    shape: np.ndarray                    # (shape_feat_dim,)
    buffer: np.ndarray                   # pending 16 kHz z-scored samples
    final: bool = False                  # no more audio will arrive
    window_idx: int = 0
    slot: Optional[int] = None           # carry slot on the card (None = new or evicted)
    prev_motion: Optional[np.ndarray] = None   # (n_prev, D) carry, host copy while evicted
    prev_audio: Optional[np.ndarray] = None    # (n_prev, F) carry, host copy while evicted
    motion_at_T: Optional[np.ndarray] = None   # (L, D) window-0 draw, host copy while evicted
    outputs: List[np.ndarray] = field(default_factory=list)
    finished: bool = False


class StreamingBatcher:
    """Continuous micro-batching over concurrent speech-to-motion streams
    (the port of ``msmd_tpu/serving.py::StreamingBatcher``).

    Each round (``step()``) takes up to ``max_slots`` streams that have a
    full 4 s window buffered (or a final partial one), in round-robin
    order when more are ready, extracts each window's audio features,
    runs all the windows as ONE ``sample`` call of batch ``max_slots`` (a
    fixed shape, so a fixed decoder route), and scatters the motion and
    the carries back per stream. It follows the reference's windowed
    autoregression (inference.py:35-75): the carry is the last
    ``n_prev_motions`` generated frames and audio features, and the
    window-0 noise ``motion_at_T`` is reused by later windows.

    The carries live on the card in slot-indexed tensors; a stream's carry
    goes to the host only when its slot is evicted (more streams ready
    than free slots) or through ``stream_carry``. Slots not served in a
    round keep their carry. Only the motion is fetched: each round copies
    it to pinned host memory behind an event, and with ``pipeline_depth``
    k > 1 up to k rounds are enqueued before the oldest one's event is
    waited on, so output arrives up to k - 1 rounds late.

    Every draw is per stream: window w of the stream with seed s takes
    motion_at_T (L, D) and the per-step z (T, L, D) from
    ``torch.Generator``s seeded ``draw_seed(s, w, 0)`` and
    ``draw_seed(s, w, 1)`` (``_draw``), so a stream's output does not
    depend on which streams share its round. As in the JAX batcher, audio
    features are extracted per window, and the CFG settings, the dynamic
    threshold and ``resident`` (``sample``'s K2 switch) hold for the whole
    batcher.
    """

    def __init__(self, model, max_slots: int = 48, cfg_mode: Optional[str] = None, cfg_cond=None,
                 cfg_scale: float = 1.15, dynamic_threshold: Optional[Tuple[float, float, float]] = None,
                 pipeline_depth: int = 1, resident: bool = False, device="cuda"):
        self.model, self.cfg = model, model.cfg
        self.device = resolve_device(device)
        self.max_slots = int(max_slots)
        self.cfg_mode, self.cfg_cond, self.cfg_scale = cfg_mode, cfg_cond, cfg_scale
        self.dynamic_threshold = dynamic_threshold
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.resident = resident
        self._pending: List[Tuple[torch.Tensor, Optional[torch.cuda.Event], list]] = []
        self._streams: Dict[str, _Stream] = {}
        self._rr = 0  # round-robin cursor
        null = getattr(model, "null_style_feat", None)
        self._null_style = null.detach().float().cpu().numpy()[0, 0] if null is not None else None
        S, P, L, D = self.max_slots, self.cfg.n_prev_motions, self.cfg.n_motions, self.cfg.motion_feat_dim
        F, T = model.start_audio_feat.shape[-1], self.cfg.n_diff_steps
        f32, dev = torch.float32, self.device
        self._slot_sid: List[Optional[str]] = [None] * S
        self._prev_m = torch.zeros(S, P, D, dtype=f32, device=dev)
        self._prev_a = torch.zeros(S, P, F, dtype=f32, device=dev)
        self._mT = torch.zeros(S, L, D, dtype=f32, device=dev)
        self._noise = torch.zeros(S, T, L, D, dtype=f32, device=dev)  # each slot's z of the round

    # ------------------------------------------------------------------
    def add_stream(self, sid: str, seed: int, style: Optional[np.ndarray] = None,
                   shape: Optional[np.ndarray] = None):
        """Register a stream. ``seed`` (0 <= seed < 2**31) roots its draws;
        ``style`` is a (d_style,) embedding (the null embedding when None),
        ``shape`` a (shape_feat_dim,) FLAME shape code (zeros when None)."""
        if sid in self._streams:
            raise ValueError(f"stream {sid} already registered")
        draw_seed(int(seed), 0, 0)  # range check
        if style is None:
            if self._null_style is None:
                raise ValueError("style is required: the model has no null style embedding")
            style = self._null_style
        if shape is None:
            shape = np.zeros((self.cfg.shape_feat_dim,), np.float32)
        self._streams[sid] = _Stream(seed=int(seed), style=np.asarray(style, np.float32).reshape(-1),
                                     shape=np.asarray(shape, np.float32).reshape(-1),
                                     buffer=np.zeros((0,), np.float32))

    def push_audio(self, sid: str, samples: np.ndarray, final: bool = False):
        """Append z-scored 16 kHz samples; ``final`` marks the end of the stream."""
        s = self._streams[sid]
        if s.final:
            raise ValueError(f"stream {sid} already finalized")
        s.buffer = np.concatenate([s.buffer, np.asarray(samples, np.float32).reshape(-1)])
        s.final = s.final or final
        if s.final and len(s.buffer) == 0:
            s.finished = True

    def output(self, sid: str) -> np.ndarray:
        """All frames generated so far, (n_frames, D), after resolving the
        rounds in flight."""
        self.flush()
        s = self._streams[sid]
        return (np.concatenate(s.outputs, axis=0) if s.outputs
                else np.zeros((0, self.cfg.motion_feat_dim), np.float32))

    def finished(self, sid: str) -> bool:
        return self._streams[sid].finished

    def remove_stream(self, sid: str):
        s = self._streams.pop(sid)
        if s.slot is not None:
            self._slot_sid[s.slot] = None

    def stream_carry(self, sid: str):
        """A stream's carry on the host: (prev_motion, prev_audio_features,
        motion_at_T), all None before its first window. With
        ``set_stream_carry`` the export half of moving a live stream to
        another serving process."""
        s = self._streams[sid]
        if s.slot is None or s.window_idx == 0:
            return s.prev_motion, s.prev_audio, s.motion_at_T
        i = s.slot
        return tuple(t[i].cpu().numpy() for t in (self._prev_m, self._prev_a, self._mT))

    def set_stream_carry(self, sid: str, prev_motion=None, prev_audio=None, motion_at_T=None):
        """Replace parts of a stream's carry (None keeps that part): the
        import half of moving a live stream; a slot on the card is
        updated in place."""
        s = self._streams[sid]
        cur = self.stream_carry(sid)
        new = [c if v is None else np.asarray(v, np.float32) for c, v in zip(cur, (prev_motion, prev_audio,
                                                                                   motion_at_T))]
        if s.slot is None:
            s.prev_motion, s.prev_audio, s.motion_at_T = new
        else:
            for t, v in zip((self._prev_m, self._prev_a, self._mT), new):
                t[s.slot] = torch.as_tensor(v, device=self.device)

    # ------------------------------------------------------------------
    def _draw(self, stream: _Stream, window: int, z_out: torch.Tensor) -> torch.Tensor:
        """Window ``window``'s draws of ``stream``: writes the per-step z
        (T, L, D) into ``z_out`` and returns motion_at_T (L, D), each from
        its own generator (``draw_seed``)."""
        cfg, dev = self.cfg, self.device
        gen = lambda which: torch.Generator(device=dev).manual_seed(draw_seed(stream.seed, window, which))
        torch.randn(z_out.shape, generator=gen(1), device=dev, out=z_out)
        return torch.randn((cfg.n_motions, cfg.motion_feat_dim), generator=gen(0), device=dev)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array to the card without draining its queue (pinned,
        asynchronous)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _ready_ids(self) -> List[str]:
        n_a = self.cfg.n_audio_samples
        return [sid for sid, s in self._streams.items()
                if not s.finished and (len(s.buffer) >= n_a or (s.final and len(s.buffer) > 0))]

    def _assign_slots(self, ready: List[str]) -> None:
        """Give every served stream a carry slot, evicting (one carry fetch
        to the host) slotted streams that are not served only when the
        round has too few free slots."""
        served = set(ready)
        for i, sid in enumerate(self._slot_sid):  # reap finished or removed occupants
            if sid is not None and (sid not in self._streams or self._streams[sid].finished):
                if sid in self._streams:
                    self._streams[sid].slot = None
                self._slot_sid[i] = None
        need = [sid for sid in ready if self._streams[sid].slot is None]
        if not need:
            return
        free = [i for i, sid in enumerate(self._slot_sid) if sid is None]
        short = len(need) - len(free)
        if short > 0:
            evict = [i for i, sid in enumerate(self._slot_sid) if sid is not None and sid not in served][:short]
            idx = torch.as_tensor(evict, device=self.device)
            pm, pa, mt = (t[idx].cpu().numpy() for t in (self._prev_m, self._prev_a, self._mT))
            for j, i in enumerate(evict):
                ev = self._streams[self._slot_sid[i]]
                ev.prev_motion, ev.prev_audio, ev.motion_at_T = pm[j], pa[j], mt[j]
                ev.slot, self._slot_sid[i] = None, None
            free.extend(evict)
        for sid in need:
            s, i = self._streams[sid], free.pop(0)
            s.slot, self._slot_sid[i] = i, sid
            if s.window_idx > 0:  # rejoining after eviction or migration: restore the carry
                for t, v in zip((self._prev_m, self._prev_a, self._mT), (s.prev_motion, s.prev_audio,
                                                                         s.motion_at_T)):
                    t[i] = torch.as_tensor(v, device=self.device)

    @torch.no_grad()
    def step(self) -> int:
        """Run one round; returns the number of stream-windows it served
        (0: nothing was ready)."""
        cfg, model, dev = self.cfg, self.model, self.device
        n_a, L, P = cfg.n_audio_samples, cfg.n_motions, cfg.n_prev_motions
        S = self.max_slots
        with span("msmd.stream.gather"):
            ready = self._ready_ids()
            if not ready:
                return 0
            if len(ready) > S:  # round-robin fairness when oversubscribed
                self._rr %= len(ready)
                ready = (ready + ready)[self._rr:self._rr + S]
                self._rr += S
            self._assign_slots(ready)

            audio = np.zeros((S, n_a), np.float32)
            shape = np.zeros((S, cfg.shape_feat_dim), np.float32)
            style = np.zeros((S, cfg.d_style), np.float32)
            first = np.zeros((S,), bool)
            served = np.zeros((S,), bool)
            indicator = np.ones((S, L), np.float32)
            pad_frames: Dict[str, int] = {}
            mT_draw = self._mT.clone()
            for sid in ready:
                s = self._streams[sid]
                i = s.slot
                take = min(len(s.buffer), n_a)
                audio[i, :take] = s.buffer[:take]
                s.buffer = s.buffer[take:]
                if take < n_a:  # final partial window (infer_coeffs' formula, reference inference.py:41-44)
                    pad_frames[sid] = min(L, math.ceil((n_a - take) / cfg.audio_unit))
                    indicator[i, L - pad_frames[sid]:] = 0.0
                shape[i], style[i] = s.shape, s.style
                first[i], served[i] = s.window_idx == 0, True
                mT_draw[i] = self._draw(s, s.window_idx, self._noise[i])

            first_d, served_d = self._upload(first)[:, None, None], self._upload(served)[:, None, None]
            start = lambda p, like: p.detach().float().expand(like.shape)
            prev_m = torch.where(first_d, start(model.start_motion_feat, self._prev_m), self._prev_m)
            prev_a = torch.where(first_d, start(model.start_audio_feat, self._prev_a), self._prev_a)
            motion_at_T = torch.where(first_d, mT_draw, self._mT)
            audio_d, shape_d, style_d = self._upload(audio), self._upload(shape), self._upload(style)
            indicator_d = self._upload(indicator) if cfg.use_indicator else None
        feat = model.extract_audio_feature(audio_d)
        motion, mT_out, audio_out = sample(
            model, feat, shape_d, style_d, prev_motion_feat=prev_m, prev_audio_feat=prev_a,
            motion_at_T=motion_at_T, indicator=indicator_d, cfg_mode=self.cfg_mode, cfg_cond=self.cfg_cond,
            cfg_scale=self.cfg_scale, dynamic_threshold=self.dynamic_threshold,
            noise_override=self._noise.transpose(0, 1), device=dev, resident=self.resident)
        with span("msmd.stream.scatter"):
            self._prev_m = torch.where(served_d, motion[:, -P:].float(), self._prev_m)
            self._prev_a = torch.where(served_d, audio_out[:, -P:].float(), self._prev_a)
            self._mT = torch.where(served_d, mT_out.float(), self._mT)

            # only the motion goes to the host: a pinned copy behind an event,
            # waited on when this round is resolved
            if dev.type == "cuda":
                host = torch.empty(motion.shape, dtype=torch.float32, pin_memory=True)
                host.copy_(motion, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = motion.float(), None
            # windows are counted when dispatched; output arrives when resolved
            items = [(sid, self._streams[sid].slot, pad_frames.get(sid, 0)) for sid in ready]
            count("msmd.frames.sampled", S * L)
            count("msmd.frames.kept", sum(L - pf for _, _, pf in items))
            for sid in ready:
                s = self._streams[sid]
                s.window_idx += 1
                if s.final and len(s.buffer) == 0:
                    s.finished = True
            self._pending.append((host, done, items))
        while len(self._pending) >= self.pipeline_depth:
            self._resolve_oldest()
        return len(ready)

    def _resolve_oldest(self) -> None:
        """Wait for the oldest round in flight alone and hand out its motion."""
        with span("msmd.stream.resolve"):
            host, done, items = self._pending.pop(0)
            if done is not None:
                done.synchronize()
            motion = host.numpy()
            L = self.cfg.n_motions
            for sid, slot, pf in items:
                s = self._streams.get(sid)
                if s is not None:  # else removed while its round was in flight
                    s.outputs.append(motion[slot, :L - pf].copy() if pf else motion[slot].copy())

    def flush(self) -> None:
        """Hand out every round in flight."""
        while self._pending:
            self._resolve_oldest()

    def run_until_drained(self) -> int:
        """Step until no stream has a window ready; returns the stream-windows served."""
        total = 0
        while True:
            n = self.step()
            if n == 0:
                self.flush()
                return total
            total += n
