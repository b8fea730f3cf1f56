"""Offline takes: one caller, closed loop, back to back. Each call
encodes a seeded style clip (VAE2), runs ``infer_coeffs`` over a seeded
clip with ``batch`` takes of it, decodes every window's frames through
the FLAME kernel and copies the coefficients and the vertices to the
host. The clip lengths are the mix's, cycled in the mix's order: every
seed does the same work, on its own audio, style clips and weights.

Traffic keys: ``batch``, ``clip_seconds``, ``style_frames``,
``dynamic_threshold``, ``check_rows``, ``check_frames``, ``trace_units``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import checks, system as sysm, work
from h100bench.harness import Run, pinned, sync
from h100bench.reference import model as ref
from h100bench.reference.precision import tf32
from h100bench.trace import span


def clip_plan(lengths, n: int):
    """``n`` clip lengths: the mix's lengths cycled in its order."""
    return [float(lengths[j % len(lengths)]) for j in range(n)]


def call_inputs(ctx, i: int, seconds: float):
    """Call ``i``'s z-scored audio (samples,) and style clip (1, frames, 67),
    made on the card from the seed."""
    g = sysm.generator(ctx.dev, ctx.seed, 20, i)
    a = torch.randn(int(round(seconds * 16000)), generator=g, device=ctx.dev)
    clip = torch.randn(1, ctx.cell.traffic["style_frames"], 67, generator=g, device=ctx.dev)
    return (a - a.mean()) / a.std(), clip


def check_picks(ctx, i: int, n_frames: int):
    """The rows and frames of call ``i`` that the check reads, drawn from the seed."""
    tr = ctx.cell.traffic
    rng = np.random.default_rng(sysm.sub_seed(ctx.seed, 30, i))
    rows = np.sort(rng.choice(tr["batch"], tr["check_rows"], replace=False))
    frames = np.sort(rng.choice(n_frames, min(tr["check_frames"], n_frames), replace=False))
    return rows, frames


def setup(ctx) -> None:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.dev
    ctx.system = sysm.build(cfg, ctx.seed, dev)
    m = cfg["model"]
    B, n, T = tr["batch"], m["n_motions"], m["n_diff_steps"]
    g = sysm.generator(dev, ctx.seed, 4)
    ctx.state.update(
        x_T=torch.randn(B, n, 67, generator=g, device=dev),
        z=torch.randn(T, B, n, 67, generator=g, device=dev),
        host_vertices=pinned((B * n, cfg["flame"]["n_verts"], 3), dev),
        plan=clip_plan(tr["clip_seconds"], 4096), calls=[])
    if not ctx.warm:  # the readings of a limit: the longest clip, which a check compares
        ctx.state["plan"] = [max(tr["clip_seconds"])] * 4096
        return
    # the cell's shapes: a call of the shortest clip (first window, a later
    # window, a padded last window), then the audio encoder at every length
    call(ctx, -1, min(tr["clip_seconds"]), keep=False)
    with torch.no_grad():
        for s in sorted(set(tr["clip_seconds"])):
            audio, _ = call_inputs(ctx, -2, s)
            ctx.system.model.extract_audio_feature(audio[None], n * work_windows(ctx, s))
    sync(ctx.dev)


def work_windows(ctx, seconds: float) -> int:
    n, fps = ctx.cell.config["model"]["n_motions"], ctx.cell.config["model"]["fps"]
    frames = int(round(seconds * 16000) / 16000 * fps)
    return 1 if frames <= n else -(-frames // n)


@torch.no_grad()
def call(ctx, i: int, seconds: float, keep: bool = True, timed_out=None):
    """One call; with ``keep`` the check's rows and frames are kept."""
    from msmd_tpu_torch.inference_lib import infer_coeffs

    cfg, tr, sy, st = ctx.cell.config, ctx.cell.traffic, ctx.system, ctx.state
    n = cfg["model"]["n_motions"]
    with span("bench.inputs"):
        audio, clip = call_inputs(ctx, i, seconds)
    with span("bench.style_encode"):
        style = sy.style_enc.encode_mean(clip)
    with span("bench.infer_coeffs"):
        dt = tr["dynamic_threshold"]
        coeffs = infer_coeffs(sy.model, audio, torch.zeros(1, 100), style_feats=style, n_repetitions=tr["batch"],
                              cfg_scale=cfg["cfg_scale"], dynamic_threshold=tuple(dt) if dt else None,
                              motion_at_T=st["x_T"], noise_override=st["z"], device=ctx.dev)
    B, frames = coeffs.shape[:2]
    rows, picks = check_picks(ctx, i, frames)
    kept, pairs = [], []
    for w0 in range(0, frames, n):
        nf = min(n, frames - w0)
        if timed_out is not None:
            sync(ctx.dev)
            t0 = time.perf_counter()
        with span("bench.flame_decode"):
            verts = sysm.decode_vertices(sy, coeffs[:, w0:w0 + nf].reshape(-1, 67))
        with span("bench.vertex_copy"):
            st["host_vertices"][:B * nf].copy_(verts, non_blocking=True)
        if timed_out is not None:
            sync(ctx.dev)
            timed_out.append((time.perf_counter() - t0) * 1e3)
        if keep:
            sel = [(j, r, f) for j, r in enumerate(rows) for f in picks if w0 <= f < w0 + nf]
            idx = torch.as_tensor([r * nf + f - w0 for _, r, f in sel], device=ctx.dev, dtype=torch.long)
            kept.append(verts.index_select(0, idx))
            pairs += [(j, f) for j, _, f in sel]
    with span("bench.coeff_copy"):
        host = coeffs.cpu()
    sync(ctx.dev)
    if keep:
        st["calls"].append(dict(i=i, seconds=seconds, rows=rows, pairs=pairs, coeffs=host[torch.as_tensor(rows)],
                                vertices=torch.cat(kept)))
    return coeffs


def call_flops(ctx, seconds: float) -> int:
    """The model's operations of one call."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    m, B = cfg["model"], tr["batch"]
    nw = work_windows(ctx, seconds)
    frames = int(round(seconds * 16000) / 16000 * m["fps"])
    return (work.audio_feature_flops(64000 * nw, m["n_motions"] * nw, cfg["audio"]) + work.style_flops(
        tr["style_frames"]) + nw * work.window_flops(B, 2) + work.lbs_flops(B * frames))


def window(ctx, tracer, min_units: int = 1) -> Run:
    st, tr = ctx.state, ctx.cell.traffic
    m = ctx.cell.config["model"]
    run = Run(tracer=tracer, work=dict(traced_flops=0.0, k1_calls=0, k1_be=tr["batch"] * 2, vertex_out_ms=[]))
    t0 = time.perf_counter()
    audio_s, i = 0.0, 0
    while True:
        seconds = st["plan"][i]
        run.attempted += 1
        if tracer is not None and tracer.sessions < tr["trace_units"]:
            _, got = tracer.run(lambda: call(ctx, i, seconds, timed_out=run.work["vertex_out_ms"]))
            if got is not None:
                run.work["traced_flops"] += call_flops(ctx, seconds)
                run.work["k1_calls"] += m["n_diff_steps"] * work_windows(ctx, seconds)
        else:
            call(ctx, i, seconds)
        audio_s += seconds * tr["batch"]
        i += 1
        done = tracer is not None and tracer.sessions >= tr["trace_units"]
        if i >= min_units and (done or time.perf_counter() - t0 >= ctx.seconds):
            break
    run.e2e["audio_rate"] = audio_s / (time.perf_counter() - t0)
    return run


@torch.no_grad()
def check(ctx, run: Run, control: bool = False) -> dict:
    """The longest call against the reference: its sampled rows' motion,
    and their sampled frames' vertices."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    c = max(ctx.state["calls"], key=lambda call: call["seconds"])
    checks.free_program(ctx, keep=("x_T", "z", "calls"))
    st, sy = ctx.state, ctx.system
    low, low32 = checks.stand_in(control)
    dt = tr["dynamic_threshold"]
    with tf32(False):
        audio, clip = call_inputs(ctx, c["i"], c["seconds"])
        rows = torch.as_tensor(c["rows"], device=ctx.dev)
        R = len(rows)
        want = ref.infer_clip(sy.weights, cfg["model"], audio, torch.zeros(R, 100, device=ctx.dev),
                              ref.style_mean(sy.style_weights, clip, checks.F32).expand(R, -1),
                              st["x_T"][rows], st["z"][:, rows], cfg["cfg_scale"], dt, checks.F32, cfg["audio"])
        got = c["coeffs"].to(ctx.dev)
        if control:
            got = ref.infer_clip(sy.weights, cfg["model"], audio, torch.zeros(R, 100, device=ctx.dev),
                                 ref.style_mean(sy.style_weights, clip, low32).expand(R, -1),
                                 st["x_T"][rows], st["z"][:, rows], cfg["cfg_scale"], dt, low, cfg["audio"])
        motion = torch.stack([c["coeffs"][j, f] for j, f in c["pairs"]]).to(ctx.dev)
        return {"motion_gap": checks.rel_rms(got, want), "frame_gap": checks.frame_gap(got, want),
                "vertex_gap": checks.vertex_gap(sy.flame, motion, c["vertices"], control)}


def calibration_units(cell) -> int:
    """One call, the longest clip's, which a check compares."""
    return 1
