"""A service animating many live speakers: the port's
``StreamingBatcher`` with ``slots`` slots and ``pipeline_depth`` rounds in
flight, fed by a closed loop of ``clients`` clients, each sending a seeded
stream of ``stream_seconds`` in one push and a new one as soon as the last
is taken in whole. With more clients than slots every round is full. The
batcher draws each stream's noise from its seed (``draw_seed``).

Traffic keys: ``slots``, ``pipeline_depth``, ``clients``,
``stream_seconds``, ``style_frames``, ``dynamic_threshold``,
``check_streams``, ``trace_units``, ``warmup_seconds``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import checks, system as sysm, work
from h100bench.harness import Run, RunError, sync
from h100bench.reference import model as ref
from h100bench.reference.precision import tf32
from h100bench.trace import span

SEED_LIMIT = 2 ** 31


def stream_seed(ctx, c: int, k: int) -> int:
    """The batcher seed of client ``c``'s ``k``-th stream."""
    return sysm.sub_seed(ctx.seed, 40, c, k) % SEED_LIMIT


def stream_audio(ctx, c: int, k: int, seconds: float) -> torch.Tensor:
    g = sysm.generator(ctx.dev, ctx.seed, 41, c, k)
    a = torch.randn(int(round(seconds * 16000)), generator=g, device=ctx.dev)
    return (a - a.mean()) / a.std()


def style_clips(ctx) -> torch.Tensor:
    """One seeded style clip a client (clients, frames, 67)."""
    tr = ctx.cell.traffic
    g = sysm.generator(ctx.dev, ctx.seed, 21)
    return torch.randn(tr["clients"], tr["style_frames"], 67, generator=g, device=ctx.dev)


def batcher_draw(dev, seed: int, window: int, which: int, shape) -> torch.Tensor:
    """The batcher's draw of one stream's window (its documented rule:
    generator seed ``seed * 2**32 + window * 2 + which`` on the card;
    ``which`` 0 is x_T, 1 the per-step z)."""
    g = torch.Generator(device=dev).manual_seed((seed << 32) | (window << 1) | which)
    return torch.randn(shape, generator=g, device=dev)


def add(ctx, c: int, k: int) -> str:
    bat, tr = ctx.state["batcher"], ctx.cell.traffic
    sid = f"c{c}s{k}"
    with span("bench.push"):
        bat.add_stream(sid, seed=stream_seed(ctx, c, k), style=ctx.state["styles"][c % len(ctx.state["styles"])])
        bat.push_audio(sid, stream_audio(ctx, c, k, tr["stream_seconds"]).cpu().numpy(), final=True)
    ctx.state["streams"][sid] = (c, k)
    return sid


def setup(ctx) -> None:
    from msmd_tpu_torch.serving import StreamingBatcher

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.dev
    ctx.system = sysm.build(cfg, ctx.seed, dev)
    dt = tr["dynamic_threshold"]
    with torch.no_grad():
        styles = ctx.system.style_enc.encode_mean(style_clips(ctx)).cpu().numpy()
    bat = StreamingBatcher(ctx.system.model, max_slots=tr["slots"], cfg_scale=cfg["cfg_scale"],
                           dynamic_threshold=tuple(dt) if dt else None, pipeline_depth=tr["pipeline_depth"],
                           device=dev)
    ctx.state.update(batcher=bat, styles=styles, streams={})
    if not ctx.warm:
        return
    # the cell's shapes: full rounds of first and later windows
    for c in range(tr["slots"]):
        sid = f"warm{c}"
        bat.add_stream(sid, seed=stream_seed(ctx, -1, c), style=styles[c % len(styles)])
        bat.push_audio(sid, stream_audio(ctx, -1, c, tr["warmup_seconds"]).cpu().numpy(), final=True)
    bat.run_until_drained()
    for c in range(tr["slots"]):
        bat.remove_stream(f"warm{c}")
    sync(dev)


def round_flops(ctx) -> int:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    m = cfg["model"]
    S = tr["slots"]
    return S * work.audio_feature_flops(64000, m["n_motions"], cfg["audio"]) + work.window_flops(S, 2)


def window(ctx, tracer, min_units: int = 1) -> Run:
    tr = ctx.cell.traffic
    bat = ctx.state["batcher"]
    run = Run(tracer=tracer, work=dict(traced_flops=0.0, k1_calls=0, k1_be=tr["slots"] * 2))
    n_steps = ctx.cell.config["model"]["n_diff_steps"]
    window_s = ctx.cell.config["model"]["n_motions"] / ctx.cell.config["model"]["fps"]
    active = {c: add(ctx, c, 0) for c in range(tr["clients"])}
    served = rounds = 0
    t0 = time.perf_counter()
    while True:
        if tracer is not None and tracer.sessions < tr["trace_units"]:
            n, got = tracer.run(bat.step)
            if got is not None:
                run.work["traced_flops"] += round_flops(ctx)
                run.work["k1_calls"] += n_steps
        else:
            with span("bench.round"):
                n = bat.step()
        served += n
        rounds += 1
        for c, sid in list(active.items()):
            if bat.finished(sid):
                active[c] = add(ctx, c, ctx.state["streams"][sid][1] + 1)
        done = tracer is not None and tracer.sessions >= tr["trace_units"]
        if rounds >= min_units and (done or time.perf_counter() - t0 >= ctx.seconds):
            break
    with span("bench.flush"):
        bat.flush()
    run.e2e["audio_rate"] = served * window_s / (time.perf_counter() - t0)
    run.attempted = served
    ctx.state["complete"] = [sid for sid in ctx.state["streams"] if bat.finished(sid)]
    return run


@torch.no_grad()
def check(ctx, run: Run, control: bool = False) -> dict:
    """A seeded sample of the streams taken in whole against the reference:
    every window of each, in one batch."""
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.dev
    bat = ctx.state["batcher"]
    complete = ctx.state["complete"]
    if not complete:
        raise RunError("no stream was taken in whole in the window: nothing to check")
    rng = np.random.default_rng(sysm.sub_seed(ctx.seed, 31))
    picked = [complete[j] for j in sorted(rng.choice(len(complete), min(tr["check_streams"], len(complete)),
                                                     replace=False))]
    got = torch.stack([torch.as_tensor(bat.output(sid)) for sid in picked]).to(dev)
    ck = [ctx.state["streams"][sid] for sid in picked]
    checks.free_program(ctx)
    sy = ctx.system
    m = cfg["model"]
    n, T = m["n_motions"], m["n_diff_steps"]
    n_windows = got.shape[1] // n
    seeds = [stream_seed(ctx, c, k) for c, k in ck]
    x_T = torch.stack([batcher_draw(dev, s, 0, 0, (n, 67)) for s in seeds])
    noises = [torch.stack([batcher_draw(dev, s, w, 1, (T, n, 67)) for s in seeds], dim=1) for w in range(n_windows)]
    audio = torch.stack([stream_audio(ctx, c, k, tr["stream_seconds"]) for c, k in ck])
    clips = style_clips(ctx)[torch.as_tensor([c for c, _ in ck], device=dev)]
    N = len(picked)
    low, low32 = checks.stand_in(control)
    dt = tr["dynamic_threshold"]
    with tf32(False):
        want = ref.stream_clip(sy.weights, m, audio, torch.zeros(N, 100, device=dev),
                               ref.style_mean(sy.style_weights, clips, checks.F32), x_T, noises, checks.F32,
                               cfg["audio"], cfg["cfg_scale"], dt)
        if control:
            got = ref.stream_clip(sy.weights, m, audio, torch.zeros(N, 100, device=dev),
                                  ref.style_mean(sy.style_weights, clips, low32), x_T, noises, low, cfg["audio"],
                                  cfg["cfg_scale"], dt)
    return {"motion_gap": checks.rel_rms(got, want), "frame_gap": checks.frame_gap(got, want)}


def calibration_units(cell) -> int:
    """Rounds until every client's first stream is taken in whole."""
    tr, m = cell.traffic, cell.config["model"]
    per_stream = -(-round(tr["stream_seconds"] * m["fps"]) // m["n_motions"])
    return per_stream * -(-tr["clients"] // tr["slots"])
