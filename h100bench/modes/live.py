"""A live avatar: one client in a closed loop sends utterances of fresh
seeded audio, each when the last one's vertices are on the host, and
each is served alone:
``infer_coeffs`` at batch 1 over the utterance (one window, no dynamic
threshold: the batch-1 sampler kernel K3), its frames through the FLAME
kernel, the coefficients and vertices copied to the host. A request's
latency runs from its send to its vertices on the host. The style is
encoded once, in set-up.

Traffic keys: ``batch``, ``utterance_seconds``, ``style_frames``,
``dynamic_threshold``, ``check_requests``, ``check_frames``,
``trace_units``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import checks, system as sysm, work
from h100bench.harness import Run, percentile, pinned, sync
from h100bench.reference import model as ref
from h100bench.reference.precision import tf32
from h100bench.trace import span


def utterance(ctx, i: int) -> torch.Tensor:
    """Request ``i``'s z-scored audio, made on the card from the seed."""
    g = sysm.generator(ctx.dev, ctx.seed, 20, i)
    a = torch.randn(int(round(ctx.cell.traffic["utterance_seconds"] * 16000)), generator=g, device=ctx.dev)
    return (a - a.mean()) / a.std()


def style_clip(ctx) -> torch.Tensor:
    g = sysm.generator(ctx.dev, ctx.seed, 21)
    return torch.randn(1, ctx.cell.traffic["style_frames"], 67, generator=g, device=ctx.dev)


def check_frames(ctx, n_frames: int) -> np.ndarray:
    rng = np.random.default_rng(sysm.sub_seed(ctx.seed, 30))
    return np.sort(rng.choice(n_frames, ctx.cell.traffic["check_frames"], replace=False))


def setup(ctx) -> None:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.dev
    ctx.system = sysm.build(cfg, ctx.seed, dev)
    m = cfg["model"]
    B, n, T = tr["batch"], m["n_motions"], m["n_diff_steps"]
    g = sysm.generator(dev, ctx.seed, 4)
    with torch.no_grad():
        style = ctx.system.style_enc.encode_mean(style_clip(ctx))
    ctx.state.update(style=style, x_T=torch.randn(B, n, 67, generator=g, device=dev),
                     z=torch.randn(T, B, n, 67, generator=g, device=dev),
                     host_vertices=pinned((B * n, cfg["flame"]["n_verts"], 3), dev),
                     frames=check_frames(ctx, n), served={})
    if ctx.warm:
        for i in (-1, -2):
            serve(ctx, i, keep=False)


@torch.no_grad()
def serve(ctx, i: int, keep: bool = True):
    from msmd_tpu_torch.inference_lib import infer_coeffs

    cfg, tr, sy, st = ctx.cell.config, ctx.cell.traffic, ctx.system, ctx.state
    with span("bench.inputs"):
        audio = utterance(ctx, i)
    with span("bench.infer_coeffs"):
        dt = tr["dynamic_threshold"]
        coeffs = infer_coeffs(sy.model, audio, torch.zeros(1, 100), style_feats=st["style"],
                              n_repetitions=tr["batch"], cfg_scale=cfg["cfg_scale"],
                              dynamic_threshold=tuple(dt) if dt else None, motion_at_T=st["x_T"],
                              noise_override=st["z"], device=ctx.dev)
    m = coeffs.reshape(-1, 67)
    with span("bench.flame_decode"):
        verts = sysm.decode_vertices(sy, m)
    with span("bench.vertex_copy"):
        st["host_vertices"][:m.shape[0]].copy_(verts, non_blocking=True)
    with span("bench.coeff_copy"):
        host = coeffs.cpu()
    sync(ctx.dev)
    if keep:
        frames = torch.as_tensor(st["frames"], device=ctx.dev)
        st["served"][i] = dict(coeffs=host, vertices=verts.index_select(0, frames))


def utterance_flops(ctx) -> int:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    m = cfg["model"]
    frames = int(tr["utterance_seconds"] * m["fps"])
    return (work.audio_feature_flops(64000, m["n_motions"], cfg["audio"])
            + work.window_flops(tr["batch"], 2) + work.lbs_flops(tr["batch"] * frames))


def window(ctx, tracer, min_units: int = 1) -> Run:
    tr = ctx.cell.traffic
    run = Run(tracer=tracer, work=dict(traced_flops=0.0, k3_calls=0))
    latencies = []
    t0 = time.perf_counter()
    i = 0
    while True:
        traced = tracer is not None and tracer.sessions >= tr["trace_units"]
        if i >= min_units and (time.perf_counter() - t0 >= ctx.seconds or traced):
            break
        sent = time.perf_counter()
        run.attempted += 1
        if tracer is not None and tracer.sessions < tr["trace_units"]:
            _, got = tracer.run(lambda: serve(ctx, i))
            if got is not None:
                run.work["traced_flops"] += utterance_flops(ctx)
                run.work["k3_calls"] += 1
        else:
            serve(ctx, i)
        latencies.append((time.perf_counter() - sent) * 1e3)
        i += 1
    run.e2e["utterance_p90_ms"] = percentile(latencies, 90)
    run.work["latencies_ms"] = latencies
    return run


@torch.no_grad()
def check(ctx, run: Run, control: bool = False) -> dict:
    """A seeded sample of the served utterances against the reference, in
    one batch: their motion, and their sampled frames' vertices."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    served = ctx.state["served"]
    ids = sorted(served)
    rng = np.random.default_rng(sysm.sub_seed(ctx.seed, 31))
    picked = sorted(rng.choice(ids, min(tr["check_requests"], len(ids)), replace=False).tolist())
    checks.free_program(ctx, keep=("x_T", "z", "served", "frames"))
    st, sy = ctx.state, ctx.system
    N = len(picked)
    audio = torch.stack([utterance(ctx, i) for i in picked])
    low, low32 = checks.stand_in(control)
    dt = tr["dynamic_threshold"]
    x_T, z = st["x_T"].expand(N, -1, -1), st["z"].expand(-1, N, -1, -1)
    with tf32(False):
        clip = style_clip(ctx)
        want = ref.infer_clip(sy.weights, cfg["model"], audio, torch.zeros(N, 100, device=ctx.dev),
                              ref.style_mean(sy.style_weights, clip, checks.F32).expand(N, -1), x_T, z,
                              cfg["cfg_scale"], dt, checks.F32, cfg["audio"])
        got = torch.cat([served[i]["coeffs"] for i in picked]).to(ctx.dev)
        if control:
            got = ref.infer_clip(sy.weights, cfg["model"], audio, torch.zeros(N, 100, device=ctx.dev),
                                 ref.style_mean(sy.style_weights, clip, low32).expand(N, -1), x_T, z,
                                 cfg["cfg_scale"], dt, low, cfg["audio"])
        frames = torch.as_tensor(st["frames"], device=ctx.dev)
        motion = torch.cat([served[i]["coeffs"][0] for i in picked]).to(ctx.dev)
        motion = motion.reshape(N, -1, 67)[:, frames].reshape(-1, 67)
        verts = torch.cat([served[i]["vertices"] for i in picked])
        return {"motion_gap": checks.rel_rms(got, want), "frame_gap": checks.frame_gap(got, want),
                "vertex_gap": checks.vertex_gap(sy.flame, motion, verts, control)}


def calibration_units(cell) -> int:
    """As many utterances as a check compares."""
    return cell.traffic["check_requests"]
