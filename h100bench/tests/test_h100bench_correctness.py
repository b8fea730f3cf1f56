"""What decides ``correct``, at tiny sizes on the CPU: a run drives the
port through each cell's traffic (``harness.run_cell`` past the look for
a card) and holds what it produced to the cell's own limits
(``limits/<cell>.json``). The program passes; the control (the reference
one precision below the configuration's: fp8 products for the bfloat16
parts, TF32 for the float32 ones) reads several times the program's gap
and fails a limit; and a run with the timed path broken underneath comes
out not correct, once for each fault that the cell can have:

- a sampling step that returns its state unchanged (in training: an
  optimizer step that leaves the weights as they are);
- half of the batch left out (sampling: its rows filled with the other
  half's; training: the loss and its mean over the first half alone);
- an answer altered where it is produced (one frame of every sequence
  zeroed as the sampler returns it).

The exchange between chips has no fault to plant: every cell takes one
chip. The control is also read on the card at the cells' own sizes, on
three seeds or more (``calibrate.py``, ``PERF.md``)."""

import time

import pytest
import torch

from conftest import cpu_run, tiny_cell
from h100bench import harness

MODES = ["offline", "live", "stream", "train"]
SEEDS = [3, 2 ** 31 + 11]


SECONDS = {"offline": 0.0, "live": 0.0, "stream": 1.5, "train": 0.0}  # the stream window takes streams in whole


def run_tiny(mode: str, seed: int = 2 ** 33 + 5) -> dict:
    return harness.run_cell(tiny_cell(mode), seed, SECONDS[mode], False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", MODES)
def test_the_program_is_correct_and_the_control_reads_far_above_it(mode, seed, one_thread):
    *_, program = cpu_run(mode, seed)
    *_, control = cpu_run(mode, seed, control=True)
    limits = tiny_cell(mode).limits
    assert all(program[k] <= limits[k] for k in program), program
    first = "grad_gap" if mode == "train" else "motion_gap"
    assert control[first] >= 3 * program[first], (program, control)
    assert any(control[k] > limits[k] for k in limits), (control, limits)


def _sampler_output(monkeypatch, alter):
    """Wrap the sampler as the entry points call it, altering its motion."""
    import msmd_tpu_torch.inference_lib as il
    import msmd_tpu_torch.serving as sv

    real = il.sample

    def broken(*a, **kw):
        motion, x_T, feat = real(*a, **kw)
        return alter(motion.clone()), x_T, feat

    monkeypatch.setattr(il, "sample", broken)
    monkeypatch.setattr(sv, "sample", broken)


def _unchanged_state(monkeypatch):
    import msmd_tpu_torch.models.diffusion as d

    real = d._ddpm_table

    def table(*a, **kw):
        t = real(*a, **kw).copy()
        t[:, 0], t[:, 1], t[:, 2] = 1.0, 0.0, 0.0  # x_{t-1} = x_t
        return t

    monkeypatch.setattr(d, "_ddpm_table", table)


def _train_state_unchanged(monkeypatch):
    from msmd_tpu_torch.train.loop import TrainOptimizer

    def step(self):  # the gradients are cleared, the weights left as they are
        self.adam.zero_grad(set_to_none=True)
        return True

    monkeypatch.setattr(TrainOptimizer, "step", step)


def _train_half_batch(monkeypatch):
    import msmd_tpu_torch.train.loop as lp

    real = lp.two_clip_loss

    def half(cfg, model, style_enc, batch, *a, **kw):
        h = batch["motion_0"].shape[0] // 2
        return real(cfg, model, style_enc, {k: v[:h] for k, v in batch.items()}, *a, **kw)

    monkeypatch.setattr(lp, "two_clip_loss", half)


def _half_batch(motion):
    h = motion.shape[0] // 2
    motion[h:2 * h] = motion[:h]
    return motion


def _zero_frame(motion):
    motion[:, 3] = 0.0
    return motion


FAULTS = {"unchanged_state": lambda mp: _unchanged_state(mp),
          "half_batch": lambda mp: _sampler_output(mp, _half_batch),
          "altered_answer": lambda mp: _sampler_output(mp, _zero_frame)}


TRAIN_FAULTS = {"unchanged_state": _train_state_unchanged, "half_batch": _train_half_batch}
CASES = ([(m, f) for m in MODES[:3] for f in sorted(FAULTS) if not (m == "live" and f == "half_batch")]  # batch of one
         + [("train", f) for f in sorted(TRAIN_FAULTS)])


@pytest.mark.parametrize("mode, fault", CASES)
def test_a_broken_timed_path_is_not_correct(mode, fault, monkeypatch, one_thread):
    assert run_tiny(mode)["correct"] is True
    (TRAIN_FAULTS if mode == "train" else FAULTS)[fault](monkeypatch)
    out = run_tiny(mode)
    assert out["correct"] is False, out["checks"]
