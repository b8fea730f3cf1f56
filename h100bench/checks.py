"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/model.py``), the reference
run on the card after the window, in float32 with TF32 off.

The numbers of a cell, each with its limit in ``limits/<cell>.json``:

- ``motion_gap``: over the sampled sequences, the largest relative RMS
  gap ||program - reference|| / ||reference|| of the motion (every frame
  and channel of a sequence), the reference sampling from the same inputs,
  weights and noise;
- ``frame_gap``: the same over single frames (a frame's 67 channels), the
  largest over the sampled sequences' frames: one frame altered shows;
- ``vertex_gap``: over the sampled frames, max |program's vertices -
  reference decode of the program's motion| / max |reference decode|.

The control (``control=True``) puts the reference, one precision below
the configuration's, in the program's place: fp8 products where the
configuration states bfloat16 (the audio encoder and the denoiser), TF32
where it states float32 (the style encoder and FLAME).
"""

from __future__ import annotations

import gc

import torch

from h100bench.reference import model as ref
from h100bench.reference.precision import Prec

F32 = Prec("f32")
CONTROL = {"bfloat16": Prec("fp8"), "float32": Prec("tf32")}  # one precision below the configuration's


def stand_in(control: bool):
    """The precisions of what stands in the program's place: (its
    bfloat16 parts, its float32 parts)."""
    return (CONTROL["bfloat16"], CONTROL["float32"]) if control else (F32, F32)


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest over the first axis of ||a - b|| / ||b||."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max())


def frame_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest over the frames of (N, frames, channels) of ||a - b|| / ||b||."""
    a, b = a.float(), b.float()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max())


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def vertex_gap(system_flame: dict, motion_frames: torch.Tensor, vertices: torch.Tensor, control: bool) -> float:
    """The program's vertices of some frames (N, V, 3) against the
    reference decode of the same frames' motion (N, 67); with ``control``
    the TF32 decode stands in for the program's."""
    want = ref.motion_to_vertices(system_flame, motion_frames, F32)
    if control:
        vertices = ref.motion_to_vertices(system_flame, motion_frames, CONTROL["float32"])
    return rel_max(vertices, want)


def free_program(ctx, keep=()) -> None:
    """Drop the program's objects before the reference runs, so that the
    reference neither sets the peak nor runs short of memory."""
    sysm = ctx.system
    for name in ("model", "style_enc", "fused_flame"):
        setattr(sysm, name, None)
    for k in list(ctx.state):
        if k not in keep:
            del ctx.state[k]
    gc.collect()
    torch.cuda.empty_cache()
