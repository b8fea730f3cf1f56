"""Where the time goes on the card: device time by kernel for the decoder
stack, for one window of the batch-48 main path, one window at batch 1,
one guided batch-48 window and one train step.

    python -m msmd_tpu_torch.profile             # every phase
    python -m msmd_tpu_torch.profile --kernels   # decoder, sampler, decoder_flat
    python -m msmd_tpu_torch.profile --flat-rows # flat_rows only
    python -m msmd_tpu_torch.profile --resident  # resident only
    python -m msmd_tpu_torch.profile --compare   # compare only (also from an older checkout)
    python -m msmd_tpu_torch.profile --ffn-train # ffn_train only (also from an older checkout)
    python -m msmd_tpu_torch.profile --lbs       # lbs only (also from an older checkout)
    python -m msmd_tpu_torch.profile --attn-f32  # attn_f32 only (also from an older checkout)
    python -m msmd_tpu_torch.profile --profiler-sessions [SECONDS]  # profiler_sessions only
    python -m msmd_tpu_torch.profile --relpos    # relpos only: K10 beside its bound, plain twin and SDPA

Prints JSON lines:

- ``decoder``: device time per call of each kernel of the decoder stack
  (``csrc/decoder.cu``) at the batch-48 flagship shapes, from
  ``torch.profiler`` over 5 calls, and the same summed by part of K1: the
  Hopper GEMM's QKV, FFN1 and residual products (self-out and FFN2 with
  their LayerNorms), the wmma person-row products, the self- and person
  attention, the cross LayerNorm.
- ``gemm_ws``: K6's and K9's products at the guided batch-48 shapes on
  the warp-specialized GEMM (``csrc/gemm_ws.cuh``), each also at 16 times
  its depth K (the same tiles, 16 times the main loop), timed with CUDA
  events: with t(K) = fixed + k-steps x per-k-step, the two depths split a
  product's time into its main loop (microseconds per 64-deep k-step of a
  block) and the rest (the epilogue, the pipeline's fill, the launch).
- ``sampler``: K3 (``csrc/sampler.cu``, the persistent small-row stack
  of ``csrc/decoder_small.cuh``) at the flagship shapes over one 20-step
  window: device time per step from ``torch.profiler`` (the window's one
  launch), and each phase's time from the card's clock that block 0 of the
  cooperative grid records after every grid barrier in that launch (a
  phase's time is its slowest block's plus the barrier), summed over the 8
  layers and averaged over the steps (the window's first token rows, the
  ``prologue``, divided by the steps too); beside it K4 (one step on the
  same stack, one launch a step; 5 calls): its device time a step and
  the same per-phase split.
- ``decoder_flat``: K1's flat-mask mode in its two cross forms (identity
  band at Be = 4, full cross at Be = 2), device time per call and the
  same per-phase split from the card's clock, over 5 calls.
- ``flat_rows`` (``--flat-rows``, alone): K1's flat mode with the full
  masked cross at lq = 111 for Be from 2 to 96 in the denoiser's tiles
  (ms from CUDA events, and the relative error to the plain version):
  where the small stack and the Hopper-GEMM chain cross over. It calls
  only the wrapper, so it also times an older checkout of the package.
- ``resident`` (``--resident``, alone): K2 at the 48-slot shapes (Be =
  96, lq = 111) split by phase from the card's clock (block 0 stamps
  after every grid barrier of its one launch), beside K1's device time by
  part in the same call, K2's registers and local memory a thread, and K2
  beside K1 at Be = 6 and 8.
- ``compare`` (``--compare``, alone): K1, K2, K4 and K3 at their flagship
  shapes and the walls of a 48-slot batcher round through K1 and through
  K2 and of a ``ret_traj`` batch-1 window, through public entry points
  only, so that a copy of this file times an older checkout too.
- ``ffn_train`` (``--ffn-train``, alone): K7 forward and backward at the
  train step's shapes (1776 rows, F 512, FFN 2048), at p 0.1 and at p 0
  (no mask drawn: the masks' share of the time): each launch of
  one call in launch order with its device time (torch.profiler's device
  events, averaged over 5 calls), the launches a call, and the call's ms
  from CUDA events, warm and with the L2 flushed. It calls only the
  wrapper, so the same function times an older checkout of the package.
- ``lbs`` (``--lbs``, alone): K5 at N = 4800, 130 and 100 frames, V =
  5023 (``lbs_split``): its tile plan, ms warm and L2-flushed, device kernels and time
  of one call, TFLOP/s, registers and spills, f32 ``torch.matmul`` of the
  blend product alone, and the call split into main loop and the rest,
  by depth and (where the library records them) from the card's clock.
- ``attn_f32`` (``--attn-f32``, alone): K8's f32 mode (the style
  encoders' attention) at the style clip's shapes, lq 100, F 512, 8 heads,
  at B = 1 and 16 (``attn_f32_split``): ms from CUDA events, warm (three
  turns each with SDPA, kernel first, their medians) and with the L2
  flushed, the device time of one call (torch.profiler), the host's time
  to issue one call (host clock over back-to-back calls, the card left
  running), and ``scaled_dot_product_attention`` at f32 on the same
  tensors timed the same way; the host path by part, each part alone over
  many calls: the steps of the wrapper with a ``_check`` and a plan a call
  (``_check``, the plan, ``_lib``, ``torch.empty``, four
  ``ctypes.c_void_p`` pointers, the ``torch.cuda.Stream`` lookup,
  ``on_cpu``, the C entry point with its launch) and, where the package
  has them, the steps that replace them (the one-pass check with the
  pointers, ``new_empty``, the output's pointer as an int, the raw stream
  handle); and, where the library records them (``attn_f32_stamps``),
  each phase of a CTA from the card's clock. The first steps exist in
  older checkouts of the package too, so the same function times them.
- ``profiler_sessions`` (``--profiler-sessions``, alone): how often a
  torch.profiler session around one call keeps fewer kernel records than
  launch calls (``measure.profiler_session``), for K5 at N = 4800 and K8
  f32 at B = 1, lq = 100, repeated for SECONDS (default 60) with no idle
  time and with ``measure.PROFILE_PAD_S`` of it inside each end of the
  session: sessions, sessions lost, and the quantiles (0, 0.1, 0.5, 0.9,
  1) of each kept session's first kernel start minus its first launch
  call's start in us; then ``measure.profiled`` on the same calls, with
  the sessions it took each time.
- ``main_path``: one 4 s window at batch 48 (HuBERT, 500 guided DDPM
  steps, FLAME decode). Its wall time is taken without the profiler
  (host clock, ending in a synchronise); a second, profiled run gives the
  device time by kernel. ``device_busy_share`` is the summed device time
  over the un-profiled wall time; the rest is the card waiting on the host.
- ``batch1``: one 4 s window at batch 1 without a dynamic threshold (the
  route through the sampler kernel K3), measured the same way, with the
  device time of K3's kernels apart from the torch ops around them.
- ``guided``: one 4 s window of ``sample_with_guide`` at batch 48 (the
  inputs of ``chip_smoke.py``'s phase ``guided``: HuBERT, 500 steps through
  the decoder modules with K6 in every layer, FLAME decode), on the
  default route and on the ``fused_tail`` route (K9 in place of K6),
  each measured as ``main_path`` is, with the device time of K6's (or
  K9's) kernels (``csrc/ffn.cu``, ``csrc/layer_tail.cu``: the
  warp-specialized GEMM of ``csrc/gemm_ws.cuh`` at these shapes, the wmma
  tile and its LayerNorm pass elsewhere) apart from the torch ops around
  them, and the host gap (un-profiled wall time minus the summed device
  time: the card waiting on the host).
- ``serving``: one round of ``StreamingBatcher`` at 48 slots (48 streams
  of 4 s of seeded audio; HuBERT per window, 500 steps, the motion
  fetched), measured as ``main_path`` is, once through K1 (per-entry) and
  once with ``resident=True`` through K2, with the device time of the
  decoder kernels apart from the torch ops around them and the host gap.
- ``train``: one two-clip training step of the slice's training
  configuration (batch 16, bf16, ``fused_ffn_train``; see
  ``measure.build_train_path``), measured the same way, with the device
  time of K7's kernels (``csrc/ffn_train.cu``) apart from the rest; the
  host's time to enqueue the loss, the backward and the optimizer step
  (the card left running); and the calls of one step that made the host
  wait for the card (``torch.cuda.set_sync_debug_mode``).

Needs a card, like every number it prints.
"""

from __future__ import annotations

import json
import re
import sys
import time

import torch

_DECODER_KERNELS = ("gemm_sm90_kernel", "gemm_kernel", "self_attn_kernel", "person_attn_kernel", "ln_kernel",
                    "ln_person_kernel",
                    "cast_kernel", "flat_kernel")
# K3 (a window) and K4 (a step) are one cooperative kernel each; at batch
# 1 K1 does not run
_SAMPLER_KERNELS = _DECODER_KERNELS + ("scan_kernel", "step_kernel")
# K1's parts at the batch-48 shapes: the Hopper GEMM by epilogue (EPI_BF16
# is QKV, EPI_GELU FFN1, EPI_RESID_LN_CROSS self-out with LN1 and the
# motion rows' cross LayerNorm, EPI_RESID_LN FFN2 with LN3), the wmma
# tile (the person rows' two products), the person rows' attention and
# cross LayerNorm, the rest
_K1_PARTS = (("gemm_sm90_kernel<0>", "qkv"), ("gemm_sm90_kernel<2>", "ffn1"),
             ("gemm_sm90_kernel<7>", "self_out_ln1_motion_cross_layernorm"),
             ("gemm_sm90_kernel<6>", "ffn2_layernorm"), ("gemm_kernel", "person_row_products_wmma"),
             ("self_attn_kernel", "self_attention"), ("person_attn_kernel", "person_attention"),
             ("ln_person_kernel", "person_cross_layernorm"), ("ln_kernel", "cross_layernorm"),
             ("cast_kernel", "cast"))


def _k1_part(key: str) -> str:
    return next((part for prefix, part in _K1_PARTS if key.startswith(prefix)), "other")
# K7 (csrc/ffn_train.cu): its wgmma route (gemm_train.cuh) and the wmma chain of other shapes
_K7_KERNELS = ("gemm_train_kernel", "ffn_reduce_kernel", "tgemm_kernel", "ln_fwd_kernel", "ln_bwd_kernel",
               "colsum_partial_kernel", "colsum_final_kernel")
# the guided window runs no K1, so these are K6's (csrc/ffn.cu) there, or
# K9's (csrc/layer_tail.cu) on the fused_tail route, which runs no K6
_GUIDED_LAYER_KERNELS = ("gemm_ws_kernel", "gemm_kernel", "ln_kernel")
# a serving round through K2 launches only this of the decoder's kernels
_K2_KERNELS = ("resident_kernel",)


def _short(name: str) -> str:
    """A kernel of this package by its short name and template arguments
    (from the demangled ``<1, 64>`` or the mangled ``ILi1ELi64EE`` form),
    any other kernel by the start of its name."""
    m = re.search(r"(?<![a-z_])(tgemm|gemm_train|ffn_reduce|gemm_sm90|gemm_ws|gemm|self_attn|person_attn|ln_fwd|ln_bwd|ln_person|ln|cast|lbs_split|lbs|"
                  r"colsum_partial|colsum_final|attn_mid|masked_attn|chain_masked|chain_load|"
                  r"resident|scan|step|flat)_kernel"
                  r"(?:<([\w, ]+)>|I((?:L[ib]\d+E)+)E)?", name)
    if not m:
        return name[:80]
    tmpl = m.group(2) or ", ".join(re.findall(r"L[ib](\d+)E", m.group(3) or ""))
    return f"{m.group(1)}_kernel" + (f"<{tmpl}>" if tmpl else "")


def _device_ms_by_kernel(prof) -> dict:
    """Device milliseconds by kernel: only the profiler's CUDA events,
    as its own table totals them (a CPU op's device time is its kernels')."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        key = _short(evt.key)
        out[key] = out.get(key, 0.0) + evt.self_device_time_total / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _phase_split(stamps, names, launches: int) -> dict:
    """Microseconds by phase name, summed over a call's layers and averaged
    over ``launches`` launches, from the card-clock stamps block 0 writes
    (one at each launch's start, one after each of its phases ``names``)."""
    st = stamps.tolist()
    per, out = len(names) + 1, {}
    for i in range(launches):
        s = st[i * per:(i + 1) * per]
        for name, a, b in zip(names, s, s[1:]):
            out[name] = out.get(name, 0.0) + (b - a) / 1e3 / launches
    return out


def profile_device_ms(fn) -> dict:
    """Device milliseconds by kernel of one run of ``fn``, from a session
    with every kernel's device record (``measure.profiled``)."""
    from msmd_tpu_torch.measure import profiled

    return _device_ms_by_kernel(profiled(fn))


def _train_host_split(path: dict, batch) -> dict:
    """Host milliseconds to enqueue the loss, the backward and the
    optimizer step of one train step, and the calls in one step that
    synchronised with the card."""
    import warnings

    from msmd_tpu_torch.measure import run_train_steps
    from msmd_tpu_torch.train.loop import two_clip_loss

    cfg, opt = path["cfg"], path["opt"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total, _ = two_clip_loss(cfg, path["model"], path["style_enc"], batch, path["generator"], path["host_generator"])
    t1 = time.perf_counter()
    total.backward()
    t2 = time.perf_counter()
    opt.step()
    t3 = time.perf_counter()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_train_steps(path, batch, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message).lower() and "prototype" not in str(w.message)]
    return {"host_ms": {"loss": (t1 - t0) * 1e3, "backward": (t2 - t1) * 1e3, "optimizer": (t3 - t2) * 1e3,
                        "drain": (t4 - t3) * 1e3},
            "synchronising_calls": len(syncs), "synchronising_examples": sorted(set(syncs))[:10]}


def _gemm_ws_split(dev) -> dict:
    """Each K6 / K9 product's ms at its depth K and at 16 K, and the split
    of the first into main loop and the rest (see the module docstring)."""
    from msmd_tpu_torch.measure import cuda_ms, gemm_ws_case
    from msmd_tpu_torch.ops.kernels import ffn as k6
    from msmd_tpu_torch.ops.kernels import gemm_ws as kw
    from msmd_tpu_torch.ops.kernels import layer_tail as k9

    dtypes = {None: None, "bf16": torch.bfloat16, "f32": torch.float32}
    out = {}
    for kernel, products in (("k6", k6.ffn_products(96 * 111, 512, 2048)),
                             ("k9", k9.tail_products(96 * 110, 512, 2048))):
        for name, p in products.items():
            M, N, K, epi = p["M"], p["N"], p["K"], p["epilogue"]
            ms = {}
            for depth in (K, 16 * K):
                args, kwargs = gemm_ws_case(dev, M, N, depth, epi, dtypes[p["res"]], p["out"])
                ms[depth] = cuda_ms(lambda: kw.gemm_ws(*args, epi, route="wgmma_ws", **kwargs), 50, 10)
                del args, kwargs
            plan = kw.gemm_ws_plan(M, N, K, epi)
            ksteps = -(-plan["tiles"] // plan["grid"]) * K // 64  # of the busiest block at depth K
            per_kstep = (ms[16 * K] - ms[K]) / (15 * ksteps)
            out[f"{kernel}.{name}"] = {"M": M, "N": N, "K": K, "ms": ms[K], "ms_16k": ms[16 * K],
                                       "main_loop_us_per_kstep": per_kstep * 1e3,
                                       "main_loop_ms": per_kstep * ksteps, "rest_ms": ms[K] - per_kstep * ksteps}
    return out


def resident_split(dev, calls: int = 5) -> None:
    """K2 (``csrc/decoder_resident.cu``) at the 48-slot shapes (Be = 96,
    lq = 111), split by phase from the card's clock (block 0 stamps after
    every grid barrier; summed over the layers, averaged over ``calls``
    calls), beside K1 per-entry's device time by part in the same call
    (``torch.profiler``), the kernel's registers and local memory, and K2
    beside K1 at Be = 6 and 8 (below the Hopper GEMM's rows; CUDA events);
    K2 and K1 with the L2 flushed before each call."""
    from msmd_tpu_torch.measure import cuda_ms, cuda_ms_flushed, decoder_case
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import decoder_resident as kdr

    with torch.no_grad():
        args = decoder_case(dev)
        Be, lq, F = args[3].shape
        L, FF = args[0]["wqkv"].shape[0], args[0]["wf1"].shape[-1]
        kdr.fused_decoder_forward_resident(*args)
        kd.fused_decoder_forward(*args)
        k2_device = profile_device_ms(lambda: [kdr.fused_decoder_forward_resident(*args) for _ in range(calls)])
        k1_device = profile_device_ms(lambda: [kd.fused_decoder_forward(*args) for _ in range(calls)])
        stamps = torch.stack([kdr.resident_stamps(*args) for _ in range(calls)]).reshape(-1).cpu()
        k2, k1 = kdr.fused_decoder_forward_resident(*args), kd.fused_decoder_forward(*args)
        bit_equal = bool(torch.equal(k2, k1))
        k2_ms = cuda_ms(lambda: kdr.fused_decoder_forward_resident(*args), 20)
        k1_ms = cuda_ms(lambda: kd.fused_decoder_forward(*args), 20)
        flushed = {"k2_ms_l2_flushed": cuda_ms_flushed(lambda: kdr.fused_decoder_forward_resident(*args), 10),
                   "k1_ms_l2_flushed": cuda_ms_flushed(lambda: kd.fused_decoder_forward(*args), 10)}
        del args, k2, k1
    by_part = {}
    for k, v in k1_device.items():
        by_part[_k1_part(k)] = by_part.get(_k1_part(k), 0.0) + v / calls
    split = _phase_split(stamps, kdr.resident_phases(Be, lq, F, FF, L), calls)
    small = {}
    for n in (6, 8):
        with torch.no_grad():
            args = decoder_case(dev, Be=n)
            small[f"be{n}"] = {"k2_ms": cuda_ms(lambda: kdr.fused_decoder_forward_resident(*args), 50, 5),
                               "k1_ms": cuda_ms(lambda: kd.fused_decoder_forward(*args), 50, 5),
                               "bit_equal_k1": bool(torch.equal(kdr.fused_decoder_forward_resident(*args),
                                                                kd.fused_decoder_forward(*args)))}
            del args
    print(json.dumps({"phase": "resident", "entries": int(Be), "lq": int(lq), "calls": calls,
                      "grid_blocks": kdr.resident_grid(), **kdr.resident_attributes(),
                      "k2_ms": k2_ms, "k1_ms": k1_ms, "bit_equal_k1": bit_equal, **flushed,
                      "k2_device_ms_per_call": sum(k2_device.values()) / calls,
                      "k2_us_per_call_by_phase": split, "k2_us_per_call_stamped": sum(split.values()),
                      "k1_device_ms_per_call": sum(k1_device.values()) / calls, "k1_ms_per_call_by_part": by_part,
                      "small_rows": small}), flush=True)


def compare(dev) -> None:
    """K1, K2 (Be = 96), K4 (a step) and K3 (a 500-step window) at their
    flagship shapes, and the paths that run K1, K2 and K4: one 4 s window
    at batch 48 (``generate``: HuBERT, 500 steps through K1 with the
    dynamic threshold, FLAME decode), one 48-slot ``StreamingBatcher``
    round through K1 and with ``resident=True`` (48 streams of 4 s, the
    motion fetched), and one batch-1 ``sample(..., ret_traj=True)`` window
    (500 K4 calls). Kernel ms from
    CUDA events, path walls from the host clock after a warm-up run. It
    calls only the package's public entry points, so the same function
    times an older checkout of the package: copy this file into it and run
    it from that checkout's root."""
    from msmd_tpu_torch.measure import (BATCH, CFG_SCALE, SEED, build_main_path, cuda_ms, cuda_ms_flushed,
                                        decoder_case, generate, sampler_case, seeded_audio)
    from msmd_tpu_torch.models.diffusion import sample
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import decoder_resident as kdr
    from msmd_tpu_torch.ops.kernels import sampler as ks
    from msmd_tpu_torch.serving import StreamingBatcher

    out = {}
    with torch.no_grad():
        args = decoder_case(dev)
        out["k1_ms"] = cuda_ms(lambda: kd.fused_decoder_forward(*args), 20)
        out["k2_ms"] = cuda_ms(lambda: kdr.fused_decoder_forward_resident(*args), 20)
        out["k1_ms_l2_flushed"] = cuda_ms_flushed(lambda: kd.fused_decoder_forward(*args), 10)
        out["k2_ms_l2_flushed"] = cuda_ms_flushed(lambda: kdr.fused_decoder_forward_resident(*args), 10)
        del args
        scan, step, kw = sampler_case(dev)
        out["k4_ms"] = cuda_ms(lambda: ks.fused_sampler_step(*step, **kw), 50, 5)
        out["k3_ms"] = cuda_ms(lambda: ks.fused_sampler_scan(*scan, **kw), 3, 1)
        del scan, step

    model, style, fused = build_main_path(dev)
    cfg = model.cfg
    window_s = cfg.n_motions / cfg.fps
    streams = [(f"s{i}", SEED + 300 + i, seeded_audio(window_s, SEED + 300 + i)) for i in range(BATCH)]
    style_np = style.reshape(-1).cpu().numpy()

    def serve_round(resident):
        bat = StreamingBatcher(model, max_slots=BATCH, cfg_scale=CFG_SCALE, resident=resident, device=dev)
        for sid, seed, audio in streams:
            bat.add_stream(sid, seed, style=style_np)
            bat.push_audio(sid, audio, final=True)
        bat.run_until_drained()

    def wall(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    audio = seeded_audio(window_s, SEED + 6)
    w = wall(lambda: generate(model, style, fused, audio, BATCH, gen, dev))
    out["batch48_window"] = {"wall_s": w, "real_time_factor": BATCH * window_s / w}
    for resident in (False, True):
        w = wall(lambda: serve_round(resident))
        out["round_k2" if resident else "round_k1"] = {"wall_s": w, "audio_s_per_s": BATCH * window_s / w}
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    with torch.no_grad():
        feat = model.extract_audio_feature(torch.as_tensor(seeded_audio(window_s, SEED + 9), device=dev)[None])
        m_T = torch.randn(1, cfg.n_motions, cfg.motion_feat_dim, generator=gen, device=dev)
        noise = torch.randn(cfg.n_diff_steps, 1, cfg.n_motions, cfg.motion_feat_dim, generator=gen, device=dev)
        shape = torch.zeros(1, 100, device=dev)
        out["ret_traj_window_wall_s"] = wall(lambda: sample(model, feat, shape, style, ret_traj=True, motion_at_T=m_T,
                                                            noise_override=noise, cfg_scale=CFG_SCALE, device=dev))
    print(json.dumps({"phase": "compare", **out}), flush=True)


def _device_events(fn, calls: int) -> list:
    """(kernel, us) of each device kernel of ``calls`` back-to-back calls of
    ``fn``, in launch order (no memcpy or memset)."""
    from msmd_tpu_torch.measure import kernel_events, profiled

    fn()
    prof = profiled(lambda: [fn() for _ in range(calls)])
    return [(_short(e.name), e.time_range.elapsed_us()) for e in kernel_events(prof)]


def profiler_sessions(dev, seconds: float = 60.0) -> None:
    """Lost device records of single profiler sessions around K5 and K8
    f32 calls, without and with idle time inside each end, and the
    sessions ``measure.profiled`` takes for the same calls."""
    import numpy as np

    from msmd_tpu_torch.measure import PROFILE_PAD_S, attn_case, lbs_case, profiled, profiler_session
    from msmd_tpu_torch.ops.kernels import attn as k8
    from msmd_tpu_torch.ops.kernels import lbs as kl

    fused, (betas_ext, rt) = lbs_case(dev, N=4800)
    q, k, v, H = attn_case(dev, B=1, lq=100, dtype=torch.float32)
    calls = {"lbs": lambda: kl.skin_cuda(fused, betas_ext, rt), "attn_f32": lambda: k8.attention_middle(q, k, v, H)}
    for fn in calls.values():
        fn()
    sessions = {(name, pad): [] for name in calls for pad in (0.0, PROFILE_PAD_S)}
    took = {name: [] for name in calls}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for (name, pad), rows in sessions.items():
            _, kernels, launches = profiler_session(calls[name], pad)
            skew = kernels[0].time_range.start - launches[0].time_range.start if kernels and launches else None
            rows.append((len(kernels) < len(launches), skew))
        for name, fn in calls.items():
            lost = len(profiled.lost)
            profiled(fn)
            took[name].append(len(profiled.lost) - lost + 1)
    out = {}
    for (name, pad), rows in sessions.items():
        skews = [s for lost, s in rows if not lost and s is not None]
        out[f"{name}_pad_{pad}"] = dict(sessions=len(rows), lost=sum(lost for lost, _ in rows),
                                        skew_us_quantiles=np.quantile(skews, [0, 0.1, 0.5, 0.9, 1]).tolist()
                                        if skews else None)
    for name, n in took.items():
        out[f"{name}_profiled"] = dict(calls=len(n), sessions=sum(n), most_sessions_one_call=max(n))
    print(json.dumps({"phase": "profiler_sessions", "seconds": seconds, "pad_s": PROFILE_PAD_S, **out}), flush=True)


def ffn_train_split(dev, calls: int = 5) -> None:
    """K7 forward and backward at the train step's shapes, at dropout 0.1
    and 0 (no mask is drawn): each launch of one call with its device time,
    averaged over ``calls`` calls, beside the call's ms (CUDA events, warm
    and L2-flushed)."""
    from msmd_tpu_torch.measure import cuda_ms, cuda_ms_flushed, ffn_train_case
    from msmd_tpu_torch.ops.kernels import ffn_train as k7

    for p in (0.1, 0.0):
        args, gbar = ffn_train_case(dev, p=p)
        x = args[0]
        out = {}
        for name, fn in (("forward", lambda: k7.ffn_train_forward(*args)),
                         ("backward", lambda: k7.ffn_train_backward(x, gbar, *args[1:]))):
            events = _device_events(fn, calls)
            per = len(events) // calls
            launches = [{"kernel": events[i][0], "us": sum(events[c * per + i][1] for c in range(calls)) / calls}
                        for i in range(per)]
            out[name] = {"launches_per_call": per, "launches": launches,
                         "device_ms_per_call": sum(us for _, us in events) / calls / 1e3,
                         "ms": cuda_ms(fn, 20), "ms_l2_flushed": cuda_ms_flushed(fn, 20)}
        print(json.dumps({"phase": "ffn_train", "rows": int(x.shape[0]), "F": int(x.shape[1]),
                          "FFN": int(args[1].shape[0]), "p": p, "calls": calls, **out}), flush=True)


LBS_FRAMES = (4800, 130, 100)  # a batch-48 window, two 128-frame tiles, a batch-1 window
LBS_DEPTH = 8  # the depth split's second call: this many times the basis rows
LBS_KSTEP = 16  # basis rows a k-step, in both the first kernel and its redesign


def lbs_split(dev, calls: int = 20) -> None:
    """K5 (``csrc/lbs.cu``) at N = 4800 frames (a batch-48 window), 130 and
    100 (batch 1), V = 5023: the plan's tiles (where the package has a
    plan); ms from CUDA events, warm and with the L2
    flushed; the device kernels of one call and their time (torch.profiler);
    the achieved TFLOP/s; each kernel's registers and spills (``-Xptxas
    -v``, when this process built the library); f32 ``torch.matmul`` of the
    blend product alone (betas_ext by the (KB, 3 Vp) bases, no TF32) as a
    yardstick; and the call split into the product's main loop and the rest
    (skinning, stores, pipeline fill, launch). The split comes by depth:
    the same call with ``LBS_DEPTH`` times the basis rows, t(K) = rest +
    k-steps x per-k-step; and, where the library records them
    (``lbs_stamps``), from the card's clock: each block's time in its
    main loops and in its epilogues. It calls only the wrapper, so the same function
    times an older checkout of the package."""
    import subprocess

    from msmd_tpu_torch import _build
    from msmd_tpu_torch.measure import SEED, cuda_ms, cuda_ms_flushed, lbs_case, lbs_work
    from msmd_tpu_torch.models.flame import synthetic_flame
    from msmd_tpu_torch.ops.kernels import lbs as kl

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    usage = {_short(k): v for k, v in _build.ptxas_entries(_build.build(["lbs"]).get("lbs", "")).items()}
    torch.set_float32_matmul_precision("highest")
    for N in LBS_FRAMES:
        fused, (betas_ext, rt) = lbs_case(dev, N=N)
        KB, V = betas_ext.shape[1], fused.n_verts
        work = lbs_work(fused, betas_ext, rt)  # (flops, bytes), or (blend, skinning flops, bytes)
        flops = sum(work[:-1])
        fn = lambda: kl.skin_cuda(fused, betas_ext, rt)
        events = _device_events(fn, calls)
        ms = cuda_ms(fn, calls, 5)
        bases = fused.dirs.permute(1, 0, 2).reshape(KB, -1).contiguous()  # (KB, 3 Vp)
        deep = kl.FusedFlame(synthetic_flame(n_verts=V, n_shape=100 + (LBS_DEPTH - 1) * KB, seed=SEED, device=dev))
        g = torch.Generator().manual_seed(SEED + 5)
        deep_betas = (0.3 * torch.randn(N, deep.n_basis, generator=g)).to(dev)
        deep_ms = cuda_ms(lambda: kl.skin_cuda(deep, deep_betas, rt), calls, 2)
        ksteps, deep_ksteps = -(-KB // LBS_KSTEP), -(-deep.n_basis // LBS_KSTEP)
        per_kstep = (deep_ms - ms) / (deep_ksteps - ksteps)
        out = {"phase": "lbs", "card": smi, "frames": N, "verts": V, "basis": KB,
               "plan": kl.lbs_plan(N, V) if hasattr(kl, "lbs_plan") else None, "ms": ms,
               "ms_l2_flushed": cuda_ms_flushed(fn, calls),
               "device_ms_per_call": sum(us for _, us in events) / calls / 1e3,
               "launches_per_call": len(events) // calls, "kernels": sorted({k for k, _ in events}),
               "flops": flops, "work": list(work), "tflops": flops / ms / 1e9,
               "blend_matmul_ms": cuda_ms(lambda: torch.matmul(betas_ext, bases), calls, 5),
               "depth_split": {"deep_basis": deep.n_basis, "deep_ms": deep_ms, "us_per_kstep": per_kstep * 1e3,
                               "main_loop_ms": per_kstep * ksteps, "rest_ms": ms - per_kstep * ksteps},
               "ptxas": usage}
        if hasattr(kl, "lbs_stamps"):
            st = kl.lbs_stamps(fused, betas_ext, rt).double()  # (blocks, 3): main loops, epilogues, whole (ns)
            out["stamps"] = {"blocks": st.shape[0], "main_loop_us_mean": float(st[:, 0].mean()) / 1e3,
                             "epilogue_us_mean": float(st[:, 1].mean()) / 1e3,
                             "block_us_mean": float(st[:, 2].mean()) / 1e3,
                             "block_us_max": float(st[:, 2].max()) / 1e3,
                             "main_loop_share": float(st[:, 0].sum() / st[:, 2].sum())}
        print(json.dumps(out), flush=True)
        del fused, betas_ext, rt, bases, deep, deep_betas


ATTN_F32_BATCHES = (1, 16)  # inference's one clip; a train batch's eval-mode encode
ATTN_F32_LQ = 100  # the style clip's frames
HOST_REPS = 200  # few enough that the launches never fill the card's queue


def _host_us(fn, reps: int = HOST_REPS) -> float:
    """Microseconds of host time a call of ``fn`` over ``reps`` calls in a
    row (what the card runs meanwhile is not waited for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def attn_f32_split(dev, calls: int = 50) -> None:
    """K8's f32 mode at the style clip's shapes beside SDPA at f32: ms warm
    and L2-flushed, device ms, host us a call, the host path by part, and
    the phases of a CTA from the card's clock (where the library records
    them)."""
    import subprocess

    from msmd_tpu_torch import _build
    from msmd_tpu_torch.measure import attn_case, cuda_ms, cuda_ms_flushed, sdpa_call
    from msmd_tpu_torch.ops.kernels import attn as k8

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    device_ms = lambda fn: sum(us for _, us in _device_events(fn, calls)) / calls / 1e3
    new = hasattr(k8, "_launch_f32")
    lq = ATTN_F32_LQ
    for B in ATTN_F32_BATCHES:
        with torch.no_grad():
            q, k, v, H = attn_case(dev, B=B, lq=lq, seed=B + 50, dtype=torch.float32)
            F = q.shape[2]
            call = lambda: k8.attention_middle(q, k, v, H)
            got, again, want = call(), call(), k8.attention_middle_plain(q, k, v, H)
            sdpa, heads = sdpa_call(q, k, v, H)
            out = {"phase": "attn_f32", "card": smi, "entries": B, "lq": lq, "heads": H,
                   "plan": k8.attn_f32_plan(B, lq, H),
                   "rel_err": float((got - want).abs().max() / want.abs().max()),
                   "bit_equal_across_calls": bool(torch.equal(got, again)),
                   "ms_turns": [], "sdpa_ms_turns": [], "ms_l2_flushed": cuda_ms_flushed(call, 50),
                   "device_ms": device_ms(call), "host_us_per_call": _host_us(call),
                   "sdpa_ms_l2_flushed": cuda_ms_flushed(sdpa, 50),
                   "sdpa_device_ms": device_ms(sdpa), "sdpa_host_us_per_call": _host_us(sdpa)}
            for turn in range(6):  # warm ms in turns, kernel, SDPA, SDPA, kernel, ...
                side = ("ms_turns", "sdpa_ms_turns")[(turn + turn // 2) % 2]
                out[side].append(cuda_ms(call if side == "ms_turns" else sdpa, 200, 50))
            out["ms"], out["sdpa_ms"] = sorted(out["ms_turns"])[1], sorted(out["sdpa_ms_turns"])[1]
            o = torch.empty(B, lq, F, dtype=torch.float32, device=dev)
            lib, ld = k8._lib(), q.stride(1)
            ptrs = [_build.ptr(t) for t in (q, k, v)]
            parts = {"check": lambda: k8._check(q, k, v, H, torch.float32),
                     "plan": lambda: k8.attn_f32_plan(B, lq, H), "lib": k8._lib,
                     "empty": lambda: torch.empty(B, lq, F, dtype=q.dtype, device=q.device),
                     "pointers": lambda: [_build.ptr(t) for t in (q, k, v, o)],
                     "stream": lambda: _build.stream(q.device),
                     "on_cpu": lambda: _build.on_cpu("attention_middle", q)}
            if new:
                raw, ints = _build.raw_stream(q.get_device()), [t.data_ptr() for t in (q, k, v)]
                parts.update(
                    new_empty=lambda: q.new_empty((B, lq, F)),
                    check_one_pass=lambda: k8._check_f32(q, k, v, H),
                    pointer_int=lambda: o.data_ptr(),
                    stream_raw=lambda: _build.raw_stream(q.get_device()),
                    entry_and_launch=lambda: lib.msmd_attn_f32_forward(*ints, ld, o.data_ptr(), B, lq, H, None, raw))
            else:
                st = _build.stream(q.device)
                parts["entry_and_launch"] = lambda: lib.msmd_attn_f32_forward(*ptrs, ld, _build.ptr(o), B, lq, F, H,
                                                                              st)
            out["host_us_by_part"] = {name: _host_us(fn) for name, fn in parts.items()}
            if hasattr(k8, "attn_f32_stamps"):
                for _ in range(3):
                    st = k8.attn_f32_stamps(q, k, v, H).double()
                ns_per_cycle = float((st[:, 5] / st[:, 4]).mean())
                names = ("q_k_landed_k_split", "scores", "softmax", "v_split_pv_store", "whole")
                us = st[:, :5] * ns_per_cycle / 1e3
                out["stamps"] = {"ctas": st.shape[0], "ns_per_cycle": ns_per_cycle,
                                 "us_mean": dict(zip(names, us.mean(0).tolist())),
                                 "us_max": dict(zip(names, us.max(0).values.tolist())),
                                 "whole_ns_max": float(st[:, 5].max())}
        print(json.dumps(out), flush=True)
        del q, k, v, got, again, want, heads, o


FLAT_ROWS_ENTRIES = (2, 4, 8, 10, 12, 16, 24, 48, 96)


def relpos_split(dev, calls: int = 20) -> None:
    """K10 (``ops/kernels/relpos_attn.py``) at the WavLM-Large cell's shapes
    (B 32, L 200) and at B 1, L 400: forward and backward ms (CUDA events,
    warm and L2-flushed), each kernel's device time a call, the bound
    (``relpos_work`` at the published peaks), the plain twin's ms (the bias
    and P materialised) and the library's: ``scaled_dot_product_attention``
    with the gated bias as a bf16 float mask, forward and forward + backward
    (its gradient to the mask included, which the layer needs)."""
    import torch.nn.functional as F

    from msmd_tpu_torch.measure import cuda_ms, cuda_ms_flushed
    from msmd_tpu_torch.ops.kernels import relpos_attn as ra

    peak, hbm = 989e12, 3.35e12
    for B, L in ((32, 200), (1, 400)):
        H, D = 16, ra.HEAD_DIM
        gen = torch.Generator().manual_seed(B * L)
        q, k, v, dout = (torch.randn(B, L, H, D, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
        g = (1 + 2 * torch.rand(B, H, L, generator=gen)).to(dev)
        r = torch.randn(H, 2 * L - 1, generator=gen).to(dev)
        out, lse = ra.relpos_attention_cuda(q, k, v, g, r)
        fwd = lambda: ra.relpos_attention_cuda(q, k, v, g, r)
        bwd = lambda: ra.relpos_attention_bwd_cuda(q, k, v, g, r, out, lse, dout)
        row = {"phase": "relpos", "B": B, "L": L, "heads": H}
        for name, fn, back in (("forward", fwd, False), ("backward", bwd, True)):
            events = _device_events(fn, calls)
            per = len(events) // calls
            flops, nbytes = ra.relpos_work(B, L, H, D, back)
            bound_ms = max(flops / peak, nbytes / hbm) * 1e3
            dev_ms = sum(us for _, us in events) / calls / 1e3
            row[name] = {"launches_per_call": per,
                         "kernels": [[events[i][0], sum(events[c * per + i][1] for c in range(calls)) / calls]
                                     for i in range(per)],
                         "device_ms": dev_ms, "ms": cuda_ms(fn, calls), "ms_l2_flushed": cuda_ms_flushed(fn, calls),
                         "bound_ms": bound_ms, "roofline_pct": 100.0 * bound_ms / dev_ms if dev_ms else None,
                         "bound_by": "bytes" if nbytes / hbm > flops / peak else "flops"}
        row["plain_forward_ms"] = cuda_ms(lambda: ra.relpos_attention_fwd_plain(q, k, v, g, r), 5)
        row["plain_backward_ms"] = cuda_ms(lambda: ra.relpos_attention_bwd_plain(q, k, v, g, r, out, lse, dout), 5)
        qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, dout))
        bias = ra.bias_plain(g, r).to(torch.bfloat16)
        row["library_forward_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias), calls)
        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh, bias)]

        def library_step():
            o = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
            torch.autograd.grad(o, leaves, doh)

        row["library_forward_backward_ms"] = cuda_ms(library_step, calls)
        print(json.dumps(row), flush=True)


def flat_rows(dev) -> None:
    """K1's flat-mask mode with the full masked cross (width 0) at lq = 111
    for each Be of ``FLAT_ROWS_ENTRIES``, in the tiles the denoiser picks
    (``decoder_route``): ms per call (CUDA events) beside the plain
    version's relative error. Uses only the wrapper, so the same function
    times an older checkout of the package."""
    from msmd_tpu_torch.measure import cuda_ms, decoder_flat_case
    from msmd_tpu_torch.models.diffusion import decoder_route
    from msmd_tpu_torch.ops.kernels import decoder as kd

    for Be in FLAT_ROWS_ENTRIES:
        tile = decoder_route(0, Be, 111)[1]
        with torch.no_grad():
            args = decoder_flat_case(dev, Be=Be, width=0, tile=tile)
            got, want = kd.fused_decoder_forward_flat(*args), kd.fused_decoder_forward_plain(*args)
            rel = float((got - want).abs().max() / want.abs().max())
            ms = cuda_ms(lambda: kd.fused_decoder_forward_flat(*args), 10, 2)
        print(json.dumps({"phase": "flat_rows", "entries": Be, "tile": tile, "rows": Be * 111, "ms": ms,
                          "rel_err": rel}), flush=True)
        del args, got, want


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only_kernels = "--kernels" in argv  # the kernel phases only, not the paths
    if not torch.cuda.is_available():
        print("msmd_tpu_torch.profile needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--flat-rows" in argv:
        flat_rows(torch.device("cuda", 0))
        return 0
    if "--resident" in argv:
        resident_split(torch.device("cuda", 0))
        return 0
    if "--compare" in argv:
        compare(torch.device("cuda", 0))
        return 0
    if "--ffn-train" in argv:
        ffn_train_split(torch.device("cuda", 0))
        return 0
    if "--lbs" in argv:
        lbs_split(torch.device("cuda", 0))
        return 0
    if "--attn-f32" in argv:
        attn_f32_split(torch.device("cuda", 0))
        return 0
    if "--relpos" in argv:
        relpos_split(torch.device("cuda", 0))
        return 0
    if "--profiler-sessions" in argv:
        rest = argv[argv.index("--profiler-sessions") + 1:]
        profiler_sessions(torch.device("cuda", 0), float(rest[0]) if rest else 60.0)
        return 0
    from msmd_tpu_torch.measure import (BATCH, CFG_SCALE, SEED, build_main_path, decoder_case, decoder_flat_case,
                                        generate, sampler_case, seeded_audio)
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import sampler as ks
    from msmd_tpu_torch.ops.kernels.small_stack import small_stack_plan

    dev = torch.device("cuda", 0)
    calls = 5
    with torch.no_grad():
        args = decoder_case(dev)
        kd.fused_decoder_forward(*args)
        by_kernel = profile_device_ms(lambda: [kd.fused_decoder_forward(*args) for _ in range(calls)])
    per_call = {k: v / calls for k, v in by_kernel.items()}
    by_part = {}
    for k, v in per_call.items():
        by_part[_k1_part(k)] = by_part.get(_k1_part(k), 0.0) + v
    print(json.dumps({"phase": "decoder", "calls": calls, "ms_per_call": per_call, "ms_per_call_by_part": by_part,
                      "total_ms_per_call": sum(per_call.values()),
                      "device_time_seen": bool(per_call)}), flush=True)
    del args

    if not only_kernels:
        with torch.no_grad():
            print(json.dumps({"phase": "gemm_ws", "products": _gemm_ws_split(dev)}), flush=True)

    steps = 20
    with torch.no_grad():
        scan, step, kw = sampler_case(dev, T=steps)
        ks.fused_sampler_scan(*scan, **kw)
        per_step = {k: v / steps for k, v in profile_device_ms(lambda: ks.fused_sampler_scan(*scan, **kw)).items()}
        stamps = ks.sampler_scan_stamps(*scan, **kw).cpu()
        L, F, FF = scan[0]["wqkv"].shape[0], scan[0]["wso"].shape[-1], scan[0]["wf1"].shape[-1]
        lq = scan[7]["pe_flat"].shape[0] // kw["n_entries"]
        plan = small_stack_plan(kw["n_entries"], lq, F, FF, kw["n_heads"], "entry", L=L, n_cur=kw["n_cur"],
                                Fd=scan[7]["wd1"].shape[-1])
        # the window's one launch: its token rows, then each step's phases
        names = [p["name"] for p in plan["phases"]]
        split = {k: v / steps for k, v in _phase_split(stamps, names[:1] + names[1:] * steps, 1).items()}
        ks.fused_sampler_step(*step, **kw)
        k4_calls = 5
        k4_device = profile_device_ms(lambda: [ks.fused_sampler_step(*step, **kw) for _ in range(k4_calls)])
        k4_stamps = torch.stack([ks.sampler_step_stamps(*step, **kw) for _ in range(k4_calls)]).reshape(-1).cpu()
        k4_plan = small_stack_plan(kw["n_entries"], lq, F, FF, kw["n_heads"], "entry_gather", L=L,
                                   n_cur=kw["n_cur"], Fd=scan[7]["wd1"].shape[-1])
        k4_split = _phase_split(k4_stamps, [p["name"] for p in k4_plan["phases"]], k4_calls)
        k4 = {"ms_per_step": {k: v / k4_calls for k, v in k4_device.items()},
              "total_ms_per_step": sum(k4_device.values()) / k4_calls,
              "phases_per_step": k4_plan["phases_per_step"], "us_per_step_by_phase": k4_split,
              "us_per_step_stamped": sum(k4_split.values())}
    print(json.dumps({"phase": "sampler", "steps": steps, "launches_per_window": 1,
                      "ms_per_step": per_step, "total_ms_per_step": sum(per_step.values()),
                      "phases_per_step": plan["phases_per_step"], "us_per_step_by_phase": split,
                      "us_per_step_stamped": sum(split.values()), "k4": k4}), flush=True)
    del scan, step

    flat_calls = 5
    for form, Be, width in (("identity_band", 4, 1), ("full_cross", 2, 0)):
        with torch.no_grad():
            args = decoder_flat_case(dev, Be=Be, width=width)
            kd.fused_decoder_forward_flat(*args)
            by_kernel = profile_device_ms(lambda: [kd.fused_decoder_forward_flat(*args) for _ in range(flat_calls)])
            stamps = torch.stack([kd.flat_stamps(*args) for _ in range(flat_calls)]).reshape(-1).cpu()
        L, F, FF = args[0]["wqkv"].shape[0], args[3].shape[2], args[0]["wf1"].shape[-1]
        plan = small_stack_plan(Be, args[3].shape[1], F, FF, args[5], "flat_band" if width == 1 else "flat_full",
                                L=L, tile=args[9])
        split = _phase_split(stamps, [p["name"] for p in plan["phases"]], flat_calls)
        print(json.dumps({"phase": "decoder_flat", "form": form, "entries": Be, "calls": flat_calls,
                          "ms_per_call": {k: v / flat_calls for k, v in by_kernel.items()},
                          "total_ms_per_call": sum(by_kernel.values()) / flat_calls,
                          "phases_per_call": plan["phases_per_step"], "us_per_call_by_phase": split,
                          "us_per_call_stamped": sum(split.values())}), flush=True)
        del args

    if only_kernels:
        return 0

    model, style, fused = build_main_path(dev)
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    audio = seeded_audio(cfg.n_motions / cfg.fps, SEED + 6)
    for phase, batch, threshold, family in (("main_path", BATCH, (0, 1, 4), _DECODER_KERNELS),
                                            ("batch1", 1, None, _SAMPLER_KERNELS)):
        run = lambda: generate(model, style, fused, audio, batch, gen, dev, dynamic_threshold=threshold)
        run()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = profile_device_ms(run)
        busy = sum(by_kernel.values())
        stack = sum(v for k, v in by_kernel.items() if k.split("<")[0] in family)
        lbs = sum(v for k, v in by_kernel.items() if k.startswith(("lbs_kernel", "lbs_split_kernel")))
        name = "decoder_kernel_ms" if phase == "main_path" else "sampler_kernel_ms"
        print(json.dumps({
            "phase": phase, "batch": batch, "windows": 1, "diff_steps": cfg.n_diff_steps,
            "wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
            name: stack, "lbs_kernel_ms": lbs, "other_kernels_ms": busy - stack - lbs,
            "top_kernels_ms": dict(list(by_kernel.items())[:25]),
        }), flush=True)

    from msmd_tpu_torch.measure import guided_inputs, run_guided

    inputs = guided_inputs(cfg, dev)
    for route, key in (({}, "k6_kernels_ms"), ({"fused_tail": True}, "k9_kernels_ms")):
        with torch.no_grad():
            run = lambda: run_guided(model, style, inputs, dev, **route)
            run()  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            by_kernel = profile_device_ms(run)
        busy = sum(by_kernel.values())
        layer = sum(v for k, v in by_kernel.items() if k.split("<")[0] in _GUIDED_LAYER_KERNELS)
        print(json.dumps({
            "phase": "guided", "route": "fused_tail" if route else "default", "batch": BATCH, "windows": 1,
            "diff_steps": cfg.n_diff_steps, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms, "host_gap_ms": wall_ms - busy, key: layer,
            "other_kernels_ms": busy - layer, "top_kernels_ms": dict(list(by_kernel.items())[:25]),
        }), flush=True)
    del inputs

    from msmd_tpu_torch.serving import StreamingBatcher

    streams = [(f"s{i}", SEED + 300 + i, seeded_audio(cfg.n_motions / cfg.fps, SEED + 300 + i))
               for i in range(BATCH)]
    style_np = style.reshape(-1).cpu().numpy()

    def serve_round(resident):
        bat = StreamingBatcher(model, max_slots=BATCH, cfg_scale=CFG_SCALE, resident=resident, device=dev)
        for sid, seed, audio in streams:
            bat.add_stream(sid, seed, style=style_np)
            bat.push_audio(sid, audio, final=True)
        bat.run_until_drained()

    for resident, family in ((False, _DECODER_KERNELS), (True, _K2_KERNELS)):
        serve_round(resident)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve_round(resident)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = profile_device_ms(lambda: serve_round(resident))
        busy = sum(by_kernel.values())
        stack = sum(v for k, v in by_kernel.items() if k.split("<")[0] in family)
        print(json.dumps({
            "phase": "serving", "slots": BATCH, "rounds": 1, "resident": resident, "diff_steps": cfg.n_diff_steps,
            "wall_ms": wall_ms, "audio_s_per_s": BATCH * cfg.n_motions / cfg.fps / (wall_ms / 1e3),
            "device_busy_ms": busy, "device_busy_share": busy / wall_ms, "host_gap_ms": wall_ms - busy,
            "decoder_kernel_ms": stack, "other_kernels_ms": busy - stack,
            "top_kernels_ms": dict(list(by_kernel.items())[:25]),
        }), flush=True)
    del model, style, fused

    from msmd_tpu_torch.measure import build_train_path, run_train_steps, train_batch

    path = build_train_path(dev)
    batch = train_batch(path["cfg"], dev)
    run_train_steps(path, batch, 2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_train_steps(path, batch, 1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = profile_device_ms(lambda: run_train_steps(path, batch, 1))
    busy = sum(by_kernel.values())
    k7 = sum(v for k, v in by_kernel.items() if k.split("<")[0] in _K7_KERNELS)
    print(json.dumps({
        "phase": "train", "batch": path["cfg"].batch_size, "steps": 1, "wall_ms": wall_ms,
        "device_busy_ms": busy, "device_busy_share": busy / wall_ms, "k7_kernels_ms": k7,
        "other_kernels_ms": busy - k7, **_train_host_split(path, batch),
        "top_kernels_ms": dict(list(by_kernel.items())[:30]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
