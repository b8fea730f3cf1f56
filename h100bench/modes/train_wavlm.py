"""Training with WavLM-Large as the speech encoder: ``modes/train.py``'s
two-clip vertex-space step, set-up and check, run from private copies of
``modes/train.py`` and ``reference/train.py`` in which the audio
encoder's parts are rebound: the freezing policy (the reference's branch
for every encoder but HuBERT: only the convolutions stay as loaded), the
reference's WavLM forward in training and in eval mode
(``reference/wavlm.py``), and the step's operations
(``wavlm_work.train_step_flops``). The window is ``train.py``'s, with
its work fields (K7's included), recording also the change of K10's
counters over the traced steps (``msmd.k10.fwd_rows``,
``msmd.k10.bwd_rows``: query rows a launch, summed) for
``k10_roofline``.

Traffic keys: ``batch``, ``check_steps``, ``warmup_steps``, ``trace_units``.
"""

from __future__ import annotations

import types

from h100bench import wavlm_work
from h100bench.harness import HERE, Run, load_file_module
from h100bench.reference import model as refm
from h100bench.reference import wavlm as refw

FROZEN = ("audio_encoder.feature_extractor.",)


def trainable(name: str) -> bool:
    """The reference's freezing policy for an encoder other than HuBERT:
    its convolutions stay as loaded, everything else trains."""
    return not name.startswith(FROZEN)


def step_flops(ctx) -> int:
    """The model's operations of one step (``wavlm_work.train_step_flops``)."""
    return wavlm_work.train_step_flops(ctx.cell.traffic["batch"], ctx.cell.config["audio"])


_reft = load_file_module(HERE / "reference" / "train.py")
_reft.audio_train = refw.audio_train
_reft.m = types.SimpleNamespace(**{**vars(refm), "audio_features": refw.audio_features})
_train = load_file_module(HERE / "modes" / "train.py")
_train.reft = _reft
_train.trainable = trainable
_train.step_flops = step_flops

setup = _train.setup
check = _train.check
calibration_units = _train.calibration_units

K10_COUNTERS = {"k10_fwd_rows": "msmd.k10.fwd_rows", "k10_bwd_rows": "msmd.k10.bwd_rows"}


class _CountingTracer:
    """The harness's tracer, adding the change of K10's counters over each
    traced step it keeps to ``work``."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.work = {k: 0 for k in K10_COUNTERS}

    def __getattr__(self, name):
        return getattr(self.tracer, name)

    def run(self, fn):
        from msmd_tpu_torch.utils.profiling import counters

        before = counters()
        out = self.tracer.run(fn)
        if out[1] is not None:
            after = counters()
            for k, c in K10_COUNTERS.items():
                self.work[k] += after.get(c, 0) - before.get(c, 0)
        return out


def window(ctx, tracer, min_units: int = 1) -> Run:
    """``train.py``'s window (its work fields, K7's included), with the K10
    rows of the traced steps."""
    if tracer is None:
        return _train.window(ctx, None, min_units)
    counting = _CountingTracer(tracer)
    run = _train.window(ctx, counting, min_units)
    run.tracer = tracer
    run.work.update(counting.work)
    return run
