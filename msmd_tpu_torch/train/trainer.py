"""The training loop around the two-clip step: experiment directory,
logging, periodic evaluation, checkpoints, resume and profiler traces
(the port of ``msmd_tpu/train/trainer.py``; reference:
training_script.py:49-241 train(), :244-403 test()).

On a (dp, tp) layout of ranks (``parallel/mesh.py``; one process per
device, started by ``torchrun``) every rank loads the same global batch
and takes its rows; the per-sample draws are the global batch's
(``train/loop.py``), the gradients are averaged over the data group
before each update, and ``cfg.tp_size`` shards the dense layers over
groups of consecutive ranks (``parallel/tp.py``). Rank 0 alone logs and
writes checkpoints, of whole tensors: ``iter_*.pt`` loads in both
inference CLIs, and a native checkpoint resumes on any layout.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig, audio_config_from_dict, audio_config_to_dict
from msmd_tpu_torch.device import resolve_device
from msmd_tpu_torch.interop import load_flax_params, load_reference_pt, reference_msmd_to_flax, \
    reference_style_enc_to_flax
from msmd_tpu_torch.models.diffusion import get_diffusion_model
from msmd_tpu_torch.models.layers import SampleRows, init_params
from msmd_tpu_torch.models.style_encoder import check_style_width, get_style_encoder
from msmd_tpu_torch.parallel import tp as tpar
from msmd_tpu_torch.parallel.mesh import Layout, gather_rows, shard_batch
from msmd_tpu_torch.train import checkpoint as ckpt
from msmd_tpu_torch.train.loop import TrainOptimizer, batch_to, eval_step, freeze, train_step
from msmd_tpu_torch.utils.logging import MetricWriter
from msmd_tpu_torch.utils.profiling import Tracer


class Trainer:
    """MSMD and the VAE2 style encoder with seeded random weights on
    ``device`` (default ``"cuda"``, on a multi-rank layout ``cuda:LOCAL_RANK``;
    it raises without a card unless the caller asks for the CPU), the
    optimizer, and the step's generators: ``generator`` (device) and
    ``host_generator``, shared by the ranks, for the per-sample draws, and
    ``dropout_generator`` (device), the rank's own, for the draws inside
    the modules. ``flame`` (a ``FusedFlame`` or a ``FlameModel`` on the
    device) and ``coef_stats`` (the denormalisation of the FLAME
    coefficients) feed the vertex-space loss
    (``msmd_tpu/train/trainer.py``:33-86). ``layout``: this rank's place
    (``parallel.mesh.make_layout``; default one process); its ``tp`` must
    be ``cfg.tp_size``."""

    def __init__(self, cfg: MSMDConfig, exp_dir, audio_config: Optional[AudioEncoderConfig] = None,
                 device="cuda", flame=None, coef_stats: Optional[Dict] = None, layout: Optional[Layout] = None):
        self.layout = layout = layout or Layout()
        if layout.tp != max(cfg.tp_size, 1):
            raise ValueError(f"cfg.tp_size={cfg.tp_size} but the layout has tp={layout.tp}")
        if cfg.batch_size % layout.dp:
            raise ValueError(f"batch_size={cfg.batch_size} is not divisible by the {layout.dp} data-parallel ranks")
        if audio_config is not None and cfg.audio_encoder_config is None:
            cfg = cfg.replace(audio_encoder_config=audio_config_to_dict(audio_config))
        elif audio_config is None and cfg.audio_encoder_config is not None:
            audio_config = audio_config_from_dict(cfg.audio_encoder_config)
        self.cfg = cfg
        self.exp_dir = Path(exp_dir)
        self.device = resolve_device(device)
        if layout.distributed and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", layout.local_rank)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.model = get_diffusion_model(cfg, audio_config=audio_config, dtype=dtype, device=self.device,
                                         seed=cfg.seed)
        # the encoder reads the motion of the batch, 67 wide on every layout (as JAX's init infers it)
        self.style_enc = init_params(get_style_encoder(cfg, cfg.style_enc_model_style, dtype,
                                                       input_dim=cfg.motion_feat_dim), cfg.seed + 1).to(self.device)
        check_style_width(cfg, self.style_enc)
        self.flame = flame
        self.coef_stats = None if coef_stats is None else {
            k: torch.as_tensor(np.asarray(v, np.float32), device=self.device) for k, v in coef_stats.items()}
        freeze(cfg, self.model)
        for m in (self.model, self.style_enc):
            tpar.shard_model(m, layout.tp_group, layout.tp_rank, layout.tp)
        self.opt = TrainOptimizer(cfg, list(self.model.parameters()) + list(self.style_enc.parameters()),
                                  reduce_grads=layout.average_grads if layout.distributed else None)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.host_generator = torch.Generator().manual_seed(cfg.seed + 2)
        # the tp ranks of one data shard draw alike: their replicated activations must match
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 3 + layout.dp_rank)
        self.step = 0
        self.start_iter = 0
        self.writer = MetricWriter(self.exp_dir / "logs") if layout.is_main else None

    def _rows(self, batch: Dict, generator: torch.Generator):
        """(this rank's rows of a global loader batch on the device, their
        ``SampleRows`` over ``generator``)."""
        B = next(v for v in batch.values() if getattr(v, "ndim", 0) >= 2).shape[0]
        rows = SampleRows(generator, self.layout.rows(B), B)
        return batch_to(shard_batch(batch, self.layout), self.device), rows

    def load_pretrained_audio(self, path_or_name: str, cache_dir: Optional[str] = None) -> None:
        """The audio encoder's weights from a local HF directory or cache
        (``hf_loader.inject_pretrained_audio``); every rank loads them."""
        from msmd_tpu_torch.hf_loader import inject_pretrained_audio

        with tpar.gathered(self.model):
            inject_pretrained_audio(self.model, path_or_name, cache_dir)

    # ------------------------------------------------------------------
    def maybe_resume(self, continue_from: Optional[str]) -> int:
        """Resume from an experiment directory: the native checkpoint if
        there is one (model, optimizer, step, generators), else the latest
        reference ``.pt`` (parameters only). Every rank reads it and keeps
        its shards; a rank's dropout stream resumes where the checkpoint
        has one for its data shard, and is reseeded otherwise."""
        if not continue_from:
            return 0
        exp = Path(continue_from)
        native = ckpt.latest_native(exp)
        if native is not None:
            state = ckpt.load_native(native, self.device)
            with tpar.gathered(self.model, self.style_enc):
                self.model.load_state_dict(state["model"])
                self.style_enc.load_state_dict(state["style_enc"])
            self.opt.load_state_dict(self._optimizer_state(state["optimizer"], local=True))
            self.generator.set_state(state["generator"].cpu())
            self.host_generator.set_state(state["host_generator"].cpu())
            streams = state.get("dropout_generators", [])
            if self.layout.dp_rank < len(streams):
                self.dropout_generator.set_state(streams[self.layout.dp_rank].cpu())
            self.step, self.start_iter = int(state["step"]), int(state["iteration"])
            return self.start_iter
        pt = ckpt.find_latest_pt(exp / "checkpoints")
        if pt is None:
            raise ValueError(f"No checkpoints found under {exp}")
        _, model_sd, style_sd, it = load_reference_pt(pt)
        with tpar.gathered(self.model, self.style_enc):
            load_flax_params(self.model, reference_msmd_to_flax(model_sd, self.cfg))
            load_flax_params(self.style_enc, reference_style_enc_to_flax(style_sd))
        self.step = self.start_iter = it
        return it

    def _optimizer_state(self, state: dict, local: bool) -> dict:
        """The optimizer's state with the moments of sharded parameters
        made whole (``local`` False, every rank takes part) or cut to this
        rank's shard (``local`` True)."""
        shards = {id(p): (d, s) for m in (self.model, self.style_enc) for p, d, s in tpar.param_shards(m)}
        adam = state["adam"]
        per_param = {}
        for i, p in enumerate(self.opt.params):
            st = adam["state"].get(i)
            if st is not None and id(p) in shards:
                d, s = shards[id(p)]
                cut = tpar.local_slice if local else tpar.whole
                st = {k: cut(v.to(p.device), d, s) if k.startswith("exp_avg") else v for k, v in st.items()}
            if st is not None:
                per_param[i] = st
        return dict(state, adam=dict(adam, state=per_param))

    def save_checkpoint(self, iteration: int) -> None:
        """Both checkpoints, of whole tensors, written by rank 0; every rank
        takes part in gathering the shards and the dropout streams."""
        lay = self.layout
        opt_state = self._optimizer_state(self.opt.state_dict(), local=False)
        streams = [self.dropout_generator.get_state()]
        if lay.distributed:
            mine = self.dropout_generator.get_state().to(self.device)
            streams = list(gather_rows(mine[None], lay.dp, lay.dp_group).cpu())
        with tpar.gathered(self.model, self.style_enc):
            if lay.is_main:
                ckpt.save_native(self.exp_dir, {
                    "model": self.model.state_dict(), "style_enc": self.style_enc.state_dict(),
                    "optimizer": opt_state, "step": self.step, "iteration": iteration,
                    "generator": self.generator.get_state(), "host_generator": self.host_generator.get_state(),
                    "dropout_generators": streams,
                }, iteration)
                ckpt.save_reference_pt(self.exp_dir, self.cfg, self.model, self.style_enc, iteration)

    # ------------------------------------------------------------------
    def fit(self, train_loader, val_loader=None, max_iter: Optional[int] = None, log_every: Optional[int] = None,
            profile_dir: Optional[str] = None, profile_steps=(10, 15)):
        """Iterations ``start_iter .. max_iter`` (both ends included, as the
        JAX trainer runs them): a step each, metrics logged every
        ``log_every`` (averaged over the data-parallel ranks), checkpoints
        every ``save_iter`` and at ``max_iter``, validation every
        ``val_iter`` (0 turns it off). With ``profile_dir`` a profiler trace
        of iterations ``profile_steps[0]`` up to ``profile_steps[1]`` (or the
        end of the run) is written there, one file a rank
        (``msmd_tpu/train/trainer.py``:147-164)."""
        cfg, lay = self.cfg, self.layout
        max_iter = cfg.max_iter if max_iter is None else max_iter
        log_every = log_every or cfg.log_iter
        smooth = defaultdict(lambda: deque(maxlen=cfg.log_smooth_win))
        tracer = Tracer(profile_dir, rank=lay.rank) if profile_dir is not None else None
        t0 = time.time()
        try:
            for it in range(self.start_iter, max_iter + 1):
                if tracer is not None and it == profile_steps[0]:
                    tracer.start()
                elif tracer is not None and it == profile_steps[1] and tracer.running:
                    self._stop_trace(tracer)
                metrics = self.train_one(next(train_loader))
                for k, v in metrics.items():  # kept on the device until a log point
                    smooth[k].append(v)
                if it % log_every == 0:
                    names = list(smooth)
                    vals = lay.average(torch.stack([torch.stack(list(smooth[k])).float().mean() for k in names]))
                    means = dict(zip(names, vals.tolist()))
                    rate = (it - self.start_iter + 1) / max(time.time() - t0, 1e-9)
                    if lay.is_main:
                        self.writer.scalars("train", means, it)
                        self.writer.scalar("opt/steps_per_sec", rate, it)
                        print(f"iter {it}: loss={means.get('loss', float('nan')):.4e} "
                              + " ".join(f"{k}={v:.3e}" for k, v in means.items() if k != "loss")
                              + f" [{rate:.2f} it/s]", flush=True)
                if (it % cfg.save_iter == 0 and it not in (0, self.start_iter)) or it == max_iter:
                    self.save_checkpoint(it)
                if val_loader is not None and cfg.val_iter > 0 and (
                        (it % cfg.val_iter == 0 and it not in (0, self.start_iter)) or it == max_iter):
                    cap = cfg.val_batches_cap if cfg.val_batches_cap > 0 else None
                    self.evaluate(val_loader, it, n_rounds=1, mode="val", n_batches_per_round=cap)
        finally:
            if tracer is not None and tracer.running:
                self._stop_trace(tracer)
        return self

    def train_one(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One step on this rank's rows of a global loader batch; the
        metrics stay on the device."""
        batch, rows = self._rows(batch, self.generator)
        metrics = train_step(self.cfg, self.model, self.style_enc, self.opt, batch, self.dropout_generator,
                             self.host_generator, self.flame, self.coef_stats, rows=rows)
        self.step += 1
        return metrics

    def close(self) -> None:
        """Close the metric writer (rank 0's)."""
        if self.writer is not None:
            self.writer.close()

    def _stop_trace(self, tracer: Tracer) -> None:
        path = tracer.stop()
        print(f"Wrote profiler trace to {path}", flush=True)

    # ------------------------------------------------------------------
    def evaluate(self, val_loader, iteration: int, n_rounds: int = 10, mode: str = "val",
                 n_batches_per_round: Optional[int] = None, do_save: bool = False, save_path=None) -> Dict[str, float]:
        """Validation over the loader (reference: training_script.py:244-403),
        one full epoch per round unless ``n_batches_per_round`` caps it;
        writes mean/std/n JSON when ``do_save``. Each batch's metrics are
        averaged over the data-parallel ranks."""
        if n_batches_per_round is None:
            try:
                n_batches_per_round = max(len(val_loader), 1)
            except TypeError:
                n_batches_per_round = 8
        gen = torch.Generator(device=self.device).manual_seed(1234 + iteration)
        log = defaultdict(list)
        for _ in range(n_rounds):
            for _ in range(n_batches_per_round):
                batch, rows = self._rows(next(val_loader), gen)
                metrics = eval_step(self.cfg, self.model, self.style_enc, batch, gen, flame=self.flame,
                                    coef_stats=self.coef_stats, rows=rows)
                names = list(metrics)
                vals = self.layout.average(torch.stack([metrics[k].float() for k in names])).tolist()
                for k, v in zip(names, vals):
                    log[k].append(v)
        means = {k: float(np.mean(v)) for k, v in log.items()}
        if not self.layout.is_main:
            return means
        self.writer.scalars(mode, means, iteration)
        print(f"[{mode} @ {iteration}] " + " ".join(f"{k}={v:.4e}" for k, v in means.items()), flush=True)
        if do_save:
            stats = {k: {"mean": float(np.mean(v)), "std": float(np.std(v)), "n": len(v)} for k, v in log.items()}
            path = Path(save_path or (self.exp_dir / f"eval_{mode}_{iteration}.json"))
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(stats, indent=2))
        return means
