"""Training: the port's vertex-space two-clip train step (``train_step``:
both clips in one forward, the loss on FLAME vertices through K5 and K5
bwd, the FFN blocks through K7, autograd, Adam) at the mix's batch, a new
seeded batch every step, back to back.

Set-up builds one training object (model, style encoder, optimizer, the
two generators), drives it through the first ``check_steps`` steps,
keeping the first gradient as Adam holds it and the weights after the
last, then through ``warmup_steps`` more, and hands that same object to
the window. The check replays the first steps with the
reference from the same weights, batches and generator seeds.

Traffic keys: ``batch``, ``check_steps``, ``warmup_steps``, ``trace_units``.
"""

from __future__ import annotations

import time

import torch

from h100bench import checks, system as sysm, work
from h100bench.harness import Run, sync
from h100bench.reference import train as reft
from h100bench.reference.precision import tf32
from h100bench.trace import span

FROZEN = ("audio_encoder.feature_extractor.", "audio_encoder.feature_projection.", "audio_encoder.encoder.layers.0.",
          "audio_encoder.encoder.layers.1.")


def trainable(name: str) -> bool:
    """The reference's freezing policy for HuBERT: its convolutions, the
    feature projection and encoder layers 0 and 1 stay as loaded."""
    return not name.startswith(FROZEN)


def batch(ctx, k: int) -> dict:
    """Step ``k``'s batch on the card: two adjacent clips of z-scored audio
    and N(0, 1) motion a row, zero shape."""
    cfg, B = ctx.cell.config["model"], ctx.cell.traffic["batch"]
    n = cfg["n_motions"]
    g = sysm.generator(ctx.dev, ctx.seed, 60, k)
    a = torch.randn(2, B, round(16000 / cfg["fps"] * n), generator=g, device=ctx.dev)
    a = (a - a.mean(dim=-1, keepdim=True)) / a.std(dim=-1, keepdim=True)
    mo = torch.randn(2, B, n, 67, generator=g, device=ctx.dev)
    z = torch.zeros(B, n, 100, device=ctx.dev)
    return {"audio_0": a[0], "audio_1": a[1], "motion_0": mo[0], "motion_1": mo[1], "shape_0": z, "shape_1": z}


def coef_stats(ctx) -> dict:
    """Seeded denormalisation statistics in FLAME's layout."""
    g = sysm.generator(ctx.dev, ctx.seed, 61)
    out = {}
    for key, (n, s) in ctx.cell.config["coef_stats"].items():
        out[f"{key}_mean"] = torch.randn(n, generator=g, device=ctx.dev) * 0.1 * s
        out[f"{key}_std"] = s * (0.5 + torch.rand(n, generator=g, device=ctx.dev))
    return out


def generators(ctx):
    """(the device generator, the host generator) of the step's draws."""
    return (sysm.generator(ctx.dev, ctx.seed, 62),
            torch.Generator().manual_seed(sysm.sub_seed(ctx.seed, 63)))


def leaves(model, style_enc) -> dict:
    return {**{"m." + k: p for k, p in model.named_parameters()},
            **{"s." + k: p for k, p in style_enc.named_parameters()}}


def setup(ctx) -> None:
    from msmd_tpu_torch.train.loop import TrainOptimizer, freeze

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    sy = ctx.system = sysm.build(cfg, ctx.seed, ctx.dev)
    mcfg, _ = sysm.port_configs(cfg)
    sy.model.train()
    sy.style_enc.train()
    freeze(mcfg, sy.model)
    for name, p in sy.model.named_parameters():
        if p.requires_grad != trainable(name):
            raise RuntimeError(f"the port freezes {name} otherwise than the reference's policy")
    opt = TrainOptimizer(mcfg, list(sy.model.parameters()) + list(sy.style_enc.parameters()))
    g, hg = generators(ctx)
    stats = coef_stats(ctx)
    ctx.state.update(mcfg=mcfg, opt=opt, g=g, hg=hg, stats=stats, step=0)
    named = leaves(sy.model, sy.style_enc)
    for k in range(tr["check_steps"]):
        step(ctx)
        if k == 0:  # the first gradient as Adam holds it: exp_avg = (1 - b1) g after one update
            ctx.state["grad1"] = {n: opt.adam.state[p]["exp_avg"].detach() / 0.1 for n, p in named.items()
                                  if p in opt.adam.state}
    ctx.state["after"] = {n: p.detach().clone() for n, p in named.items()}
    for _ in range(tr["warmup_steps"]):
        step(ctx)
    sync(ctx.dev)


def step(ctx):
    from msmd_tpu_torch.train.loop import train_step

    st, sy = ctx.state, ctx.system
    k = st["step"]
    with span("bench.batch"):
        b = batch(ctx, k)
    with span("bench.train_step"):
        train_step(st["mcfg"], sy.model, sy.style_enc, st["opt"], b, st["g"], st["hg"], sy.fused_flame,
                   st["stats"])
    st["step"] = k + 1


def step_flops(ctx) -> int:
    """The model's operations of one step (``work.train_step_flops``)."""
    cfg, B = ctx.cell.config, ctx.cell.traffic["batch"]
    return work.train_step_flops(B, cfg["audio"])


def window(ctx, tracer, min_units: int = 1) -> Run:
    tr, m = ctx.cell.traffic, ctx.cell.config["model"]
    run = Run(tracer=tracer, work=dict(traced_flops=0.0, k7_calls=0, k7_rows=2 * tr["batch"] * (
        1 + m["n_prev_motions"] + m["n_motions"])))
    t0 = time.perf_counter()
    steps = 0
    while True:
        if tracer is not None and tracer.sessions < tr["trace_units"]:
            _, got = tracer.run(lambda: step(ctx))
            if got is not None:
                run.work["traced_flops"] += step_flops(ctx)
                run.work["k7_calls"] += m["n_layers"]
        else:
            step(ctx)
        steps += 1
        done = tracer is not None and tracer.sessions >= tr["trace_units"]
        if steps >= min_units and (done or time.perf_counter() - t0 >= ctx.seconds):
            break
    sync(ctx.dev)
    run.e2e["train_rate"] = steps / (time.perf_counter() - t0)
    run.attempted = steps
    return run


def leaf_gaps(got: dict, want: dict, floor_of: dict) -> dict:
    """Each leaf's | ||got|| - ||want|| | over the larger of the reference
    leaf's norm and the median leaf's, for the leaves whose reference
    gradient is at least a thousandth of the median leaf's (a leaf whose
    gradient is nought to rounding moves under Adam by round-off alone)."""
    norms = {k: float(v.float().norm()) for k, v in want.items()}
    g_norms = {k: float(v.float().norm()) for k, v in floor_of.items()}
    med_g = sorted(g_norms.values())[len(g_norms) // 2]
    med = sorted(norms.values())[len(norms) // 2]
    out = {}
    for k, n_want in norms.items():
        if g_norms.get(k, 0.0) >= 1e-3 * med_g:
            n_got = float(got[k].float().norm()) if k in got else 0.0
            out[k] = abs(n_got - n_want) / max(n_want, med)
    return out


@torch.no_grad()
def check(ctx, run: Run, control: bool = False) -> dict:
    """The first ``check_steps`` steps replayed by the reference: the
    first gradient and the weights' change after the steps, each by its
    worst leaf. The steps' losses are not compared: neither the control
    nor a fault that the loss alone would catch separates them from sound
    runs (``PERF.md`` §2)."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    st = ctx.state
    grad1, after = st["grad1"], st["after"]
    checks.free_program(ctx, keep=())
    sy = ctx.system
    before = {**{"m." + k: v for k, v in sy.weights.items()}, **{"s." + k: v for k, v in sy.style_weights.items()}}
    train = [k for k in before if k.startswith("s.") or trainable(k[2:])]
    g, hg = generators(ctx)
    stats = coef_stats(ctx)
    batches = [batch(ctx, k) for k in range(tr["check_steps"])]
    lr = float(torch.tensor(cfg["model"]["lr"], dtype=torch.float32))
    with tf32(False), torch.enable_grad():
        _, want_grad1, want_after = reft.train_steps(
            sy.weights, sy.style_weights, train, sy.flame, stats, cfg["model"], cfg["audio"], batches, g, hg,
            checks.F32, checks.F32, lr)
        if control:
            g, hg = generators(ctx)
            _, grad1, after = reft.train_steps(
                sy.weights, sy.style_weights, train, sy.flame, stats, cfg["model"], cfg["audio"], batches, g, hg,
                *checks.stand_in(True), lr)
    delta = lambda w: {k: w[k].float() - before[k].float() for k in train}
    return {"grad_gap": max(leaf_gaps(grad1, want_grad1, want_grad1).values()),
            "update_gap": max(leaf_gaps(delta(after), delta(want_after), want_grad1).values())}


def calibration_units(cell) -> int:
    return 1
