"""Chip smoke test of the PyTorch / CUDA port (``msmd_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Device kernels are read from torch.profiler sessions that
``measure.profiled`` pads with idle host time at both ends and takes
again, up to ``measure.PROFILE_TRIES`` times, when the profiler kept fewer
kernel records than launch calls (in some stretches of a process it
keeps none for most sessions); the kernels and parallel phases report the
sessions taken again (``profiler_sessions_lost``: kernel records and
launch calls of each), and phase parallel takes its traced fit up to
``TRACE_SESSIONS`` times.

Phases, each printing one JSON line:

1. device: needs ``torch.cuda.is_available()`` (else it exits 1 and prints
   no result); turns TF32 off for float32 products and convolutions.
2. build: compiles every ``msmd_tpu_torch/csrc/*.cu`` with ``nvcc``, one
   process per source, all started together.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the same CUDA tensors at the flagship shapes of its path, and timed
   with CUDA events beside its bound (``msmd_tpu_torch/measure.py``: the
   larger of bytes over 3.35 TB/s and operations over the peak rate of
   their type on an H100 SXM, 989 TFLOP/s bf16 or 67 TFLOP/s f32).
   - decoder stack (K1): Be = 96 (batch 48, two CFG entries), lq = 111,
     8 x 512 layers, bf16 pack; max |err| / max |plain| <= 2e-2; timed
     warm and with the L2 flushed before each call (``ms_l2_flushed``).
     Under ``products``: its four large products alone at R = 10656 rows
     (QKV, self-out + LayerNorm + the motion rows' cross step and
     LayerNorm, FFN1, FFN2 + LayerNorm) on the warp-specialised Hopper
     GEMM that K1 runs, each gated the same way against the plain product
     and bit for bit against the 256-thread tile loop that K2 runs, with
     ms and TFLOP/s beside its bound, the tile loop's ms, the wmma tile of
     earlier PRs and ``torch.nn.functional.linear`` at the same shape (a
     yardstick the port never calls).
   - batch-1 sampler scan (K3): two CFG entries, lq = 111, the same
     layers, 500 steps; gated at max |err| / max |plain| <= 2e-2 over all
     500 steps and over the last 10 (t = 10..1), and timed over all 500.
     The gates read the denoiser because they end at t = 1, where
     x_0 = target; over the first steps (t = 500..491) the output is
     almost all x_T and z, which both sides share, and a wrong decoder
     would read well below the gate. K3 is one cooperative launch of the
     persistent small-row stack (``csrc/decoder_small.cuh``) a window; its
     entry also gives its grid and phases a step (the plan the library
     reports), its launches a step as the card ran them
     (``launches_per_step``: the kernel's device events in torch.profiler
     over one call, divided by the steps; the plan's number beside it as
     ``planned_launches_per_step``), its registers and spills (``-Xptxas
     -v``), whether two calls are bit-equal (``deterministic``, gated), the
     window with the L2 flushed and the weight-streaming floor (500 x the
     pack's bytes / 3.35 TB/s).
   - batch-1 sampler step (K4): one step at t = 1 and one at t = T (the
     first step of the window); the same gate at each, and two calls
     bit-equal (gated). K4 is one cooperative launch of the same stack a
     step; its entry gives K3's launch facts for it (grid, phases, launches
     a step from torch.profiler, registers), its ms beside K3's ms a step
     in the same call (``k3_ms_per_step``).
   - FLAME decode (K5, 3xTF32 on wgmma): N = 4800 frames (the batch-48
     window) and N = 100 (batch 1), V = 5023; max |err| against the f32
     plain version <= 1e-4 and, the f32-class check that one TF32 product
     misses, <= 1e-5; two calls bit-equal; the plan's two device kernels a
     call (``ops/kernels/lbs.py::lbs_plan``: the betas split, the kernel) in
     torch.profiler; registers and spills (``-Xptxas -v``); warm and
     L2-flushed ms beside the 3xTF32 bound (``measure.lbs_bound``), the
     f32 CUDA-core bound of the same work (``f32_simt_bound_ms``) and f32
     ``torch.matmul`` of the blend product alone with TF32 off
     (``blend_matmul_ms``).
   - the FLAME decode's backward (K5 bwd, the skinning terms of the VJP):
     N = 1760 frames (clip 1's predicted frames of a batch-16 train step),
     V = 5023, a seeded cotangent; dv, dR and dt each gated at max |err| /
     max |plain| <= 1e-4 against ``skin_vjp_plain`` (JAX's einsums, gw
     materialised), two calls bit-equal, dv zero past V, two device kernels
     a call in torch.profiler; warm and L2-flushed ms beside its bound
     (``measure.lbs_bwd_bound``: bytes); registers and spills.
   - training FFN block (K7), forward and backward: rows 1776 (batch 16 x
     111), F 512, FFN 2048, bf16, dropout 0.1 and 0, a fixed seed; out and
     each of the seven gradients gated at max |err| / max |plain| <= 2e-2
     at both rates, two calls bit-equal (``bit_equal_across_calls``), the
     dropout bits of the kernels' device generator equal to the plain
     generator's with 0 mismatches (both salts, all rows), and the device
     kernels of one call in torch.profiler (``launches_per_call``) equal to
     the plan's (``ops/kernels/ffn_train.py::ffn_train_plan``: at these
     rows the wgmma route of ``csrc/gemm_train.cuh``, 2 and 6 launches;
     ``kernel_route``). No one PyTorch call computes K7 (``library_ms``
     null); the unfused torch-op chain (F.linear, gelu, dropout,
     layer_norm, and its autograd backward) is timed beside it as
     ``chain_ms``; K7 also with the L2 flushed before each call, and by its
     kernels' device time alone (``device_ms``, torch.profiler: its warm
     ``ms`` also holds the host's time to issue each call).
   - K1's flat-mask mode (``decoder_flat``) in its two cross forms, lq =
     111, the same layers, in the tiles the denoiser picks: the identity
     band at Be = 4 (the 2-slot serving round) and the full masked cross at
     Be = 2 (batch 1 of a model without the alignment mask), both one tile
     on the persistent small-row stack, and the full masked cross at Be =
     96 (batch 48 of that model, tiles of 8, 10656 rows: the chain of
     launches on the Hopper GEMM); each at max |err| / max |plain| <= 2e-2
     and bit-equal across two calls. The entry's ``ms`` is the identity
     band's; every form's numbers are under ``forms``, with its ``route``,
     the small-row stack's launch facts as K3's (the chain: the kernels the
     card ran in one call), bit-equality and L2-flushed time.
   - K2 (``resident``) at K1's Be = 96 shapes: max |err| / max |plain| <=
     2e-2 and bit-equal to K1's kernel on the same inputs (gated: the same
     device functions in the same order give the same bits); its threads,
     registers (the launch's count and ``-Xptxas -v``), spill bytes and
     grid; timed warm and with the L2 flushed beside K1 in the same call,
     and at Be = 2, 4, 6 and 8 (``small_rows``, below the Hopper GEMM's
     rows) beside K1 per-entry.
   - the guided window's layer kernels at its batch-48 shapes (two CFG
     entries, Be = 96, lq = 111): K6 ``fused_ffn_ln`` over 10656 rows (F
     512, FFN 2048), K8 ``attention_middle`` over 96 entries of 111 rows (8
     heads of 64, q, k, v the column slices of one projection), K9
     ``fused_layer_tail`` over the 10560 motion rows; each at max |err| /
     max |plain| <= 2e-2. ``library_ms`` is ``scaled_dot_product_attention``
     on K8's inputs, and null for K6 and K9, whose unfused torch-op chains
     are timed as ``chain_ms``. K6 and K9 run with their weights prepared
     once, as the guided path runs them. K6, K8 and K9 are also timed with
     the L2 flushed before each call (SDPA too), and K8 and SDPA also by
     their kernels' device time alone (``device_ms``,
     ``library_device_ms``, torch.profiler). Under ``products``: K6's
     two and K9's four products alone at their shapes, on the route the
     kernel takes (the warp-specialized GEMM of ``csrc/gemm_ws.cuh`` at
     these rows) and on the wmma tile of earlier PRs, each gated at max
     |err| / max |plain| <= 2e-2 against the plain product, with ms and
     TFLOP/s beside ``torch.nn.functional.linear`` at the same shape.
   - K8's f32 mode (``attention_middle_f32``; the style encoders'
     self-attention at inference) at the style clip's shapes, 100 rows an
     entry, F 512, 8 heads of 64, at B = 1 (``attn_f32``, one clip) and B =
     16 (``attn_f32_b16``, a train batch's eval-mode encode): max |err| /
     max |plain| <= 1e-5 against the plain version at f32 with TF32 off,
     two calls bit-equal, one device kernel a call in torch.profiler;
     timed warm (in turns with SDPA, the median of three each: both are
     host-bound here), with the L2 flushed and by device time alone,
     beside its
     bound (three TF32 products a product at 495 TFLOP/s, or the bytes)
     and ``scaled_dot_product_attention`` at f32 on the same tensors
     (``library_ms``; a yardstick the port never calls).
   - K10 (``ops/kernels/relpos_attn.py``, ``csrc/relpos_attn.cu``; WavLM's
     gated relative-position attention) at the WavLM-Large cell's shapes,
     B 32 clips of L 200 tokens, 16 heads of 64: forward and backward
     against the plain twin at the card tests' tolerances (out, dq, dk,
     dv within 2e-2 of max |plain|, the log-sum-exp within 1e-5, dg and
     dr within 1e-3), two calls bit-equal, the device kernels of one call
     in torch.profiler (1 forward, 4 backward), registers and spills;
     timed warm, with the L2 flushed and by device time alone beside its
     bound (``relpos_work``: bytes), the plain twin and
     ``scaled_dot_product_attention`` with the gated bias as a bf16 float
     mask (forward; forward and backward, the mask's gradient included,
     which the layer would need). Its launches come from phase
     train_wavlm.
12. library (``phase_library``, after phase 11; listed here beside the
   kernels it checks): the model library off the main paths,
   f32 unless named. The flagship-width VAE and VAE2 style encoders (512
   features, d_style 256) on a seeded 100-frame clip at batch 16 against
   the same modules on the CPU (z, mu, logvar within 1e-5 of max |CPU|;
   the VAE's z 2 x d_style wide; no kernel launched); VAE2 with
   ``attn_kernel`` at f32 at batch 1 and 16 (K8's f32 mode once a call and
   no other kernel, within 1e-5 of the plain route) and at bf16 (K8's bf16
   mode once a call, within 2e-2); ``flame_forward`` with ``return_lm2d``
   and ``return_lm3d`` on ``synthetic_flame(5023)`` at B = 100 (head yaws
   across -60..60 degrees): the dynamic contour's indices equal to the
   CPU's, the landmarks within 1e-5, no kernel launched;
   ``flame_tex_forward`` at size 256 on a basis drawn from a
   ``torch.Generator`` against the CPU, within 1e-5 of max |CPU|. Its
   K8 f32 launch counts are the ``launches`` of the two K8 f32 entries.
4. main_path: the flagship bf16 MSMD (8 x 512 denoiser, HuBERT-base
   12 x 768 encoder, 500 DDPM steps) and the VAE2 style encoder with
   seeded random weights; ``infer_coeffs`` on 8 s of seeded audio
   (2 windows) with 48 repetitions, cfg_scale 1.15 and the dynamic
   threshold, then every frame decoded to vertices through the FLAME
   kernel on a synthetic 5023-vertex FLAME. K1 must have run 2 x 500
   times, K5 once per window.
5. batch1: the same model at batch 1 without a dynamic threshold on the
   same audio, each window through K5: K3 must have run once per window,
   K1 never, K5 once per window; then one window of
   ``sample(..., ret_traj=True)``, which must run K4 500 times (its wall
   printed, ``traj_wall_s``), and the difference of its x_0 from K3's on
   the same noise (printed, not gated).

6. guided: the batch-48 model of phase 4; one 4 s window of
   ``sample_with_guide`` at batch 48 (48 streams of seeded audio through
   HuBERT, keyframes at frames 0, 10, ..., 90 with seeded values, cfg_scale
   1.15, dynamic threshold (0, 1, 4)), its frames then decoded through
   K5; a warm-up, then three timed runs on the same x_T and noise: the
   default route (K6 500 x 8 times, K1/K3/K4/K8/K9 never), with
   ``attn_kernel`` (K6 and K8 4000 times each) and with ``fused_tail``
   (K9 4000 times, K6 and K8 never). Each gates on finite output, the
   shapes and those counts (K5 once), and prints its wall time; the
   largest |difference| between the three routes' x_0 is printed, not
   gated.
7. separate: one batch-1 window of ``sample_separate`` at bf16 on 4 s of
   seeded audio; six finite outputs of the right shapes, and no launch of
   any kernel.
8. serving: ``StreamingBatcher`` on the model of phase 4 at cfg_scale
   1.15, no dynamic threshold: 48 streams of 8 s of seeded audio through
   48 slots, two rounds, K1 per-entry 500 times a round; the first round
   alone through K1 and with ``resident=True`` (K2 500 times, K1 never),
   their audio seconds per wall second side by side
   (``first_round_audio_s_per_s``) and K2's largest difference from the K1
   round; one of the streams alone in a 48-slot
   batcher, and its largest difference from its output beside the other
   47 (printed; expected 0); a 2-slot round (K1 flat-mask, identity band,
   500 times); one 4 s window at batch 1 of the same model with
   ``align_mask_width=0`` (K1 flat-mask, full cross, 500 times; K3
   never); then 48 streams of 16 s through 48 slots at ``pipeline_depth``
   1 and 4, each giving aggregate audio seconds per wall second. Every
   output must be finite and of its shape.

9. train: the default training configuration with ``fused_ffn_train``
   (MSMD at bf16 over f32 parameters, HuBERT-base, VAE2, batch 16, two
   clips of 4 s of seeded audio and seeded motion, seeded random weights,
   constant rate 2e-5), one warm-up step, then ``TRAIN_STEPS`` timed steps
   on the same batch. Every loss must be finite, every trainable parameter
   must have moved and every frozen one (conv feature extractor, feature
   projection, HuBERT layers 0-1) be bit-unchanged. The one exception to
   the first: the last decoder layer's cross-attention q and k projections
   feed only the person row, which the motion decoder drops, so the loss
   does not depend on them (their gradient is exactly 0, in the JAX
   package too); K7 forward and
   backward must each have run 16 times per step (8 layers x 2 clips) and
   K1, K3, K4, K5 never; one ``eval_step`` must run no K7. It prints
   steps/s, training audio seconds per wall second, the peak memory and
   the device-busy share of one profiled step, then the same steps with
   ``fused_ffn_train`` off (steps/s only, not gated).

10. train_vertex: the training configuration of phase 9 at the HDTF
   layout with the vertex-space loss (``measure.build_train_path(...,
   vertex=True)``: axis-angle pose, the loss weights of
   ``load_loss_weights``, a ``FusedFlame`` over ``synthetic_flame(5023)``,
   seeded FLAME-layout denormalisation statistics, ``two_clip_batch`` and
   ``fused_ffn_train`` on), one warm-up step and ``TRAIN_STEPS`` timed
   steps. Every loss finite and every ``vert`` term > 0; trainable
   parameters moved and frozen ones not (as phase 9); K5 4 and K5 bwd 2
   launches a step (two clips x gt and pred; pred's backward), K7 8 forward
   and 8 backward (one 2B-row decoder); the gradient of the vertex terms of
   the loss with respect to the denoiser's output on one window through K5
   + K5 bwd within 1e-4 of max |plain| of the one through plain
   ``flame_forward``.
   Then the same steps with the sequential loop (K7 16 and 16 a step, K5
   and K5 bwd as before): its steps/s beside the batched one. Then from one
   saved state, 2 steps without and 2 with ``remat_denoiser``: losses
   within 1e-3 of each other (the first bit-equal in practice; the
   backward's atomics move the second), the remat peak memory lower, K7's
   forward 16 a step under remat (each layer's recompute). It prints
   steps/s, the device-busy share of one profiled step and both peaks.

10b. train_wavlm (``phase_train_wavlm``): phase 10's step with
   WavLM-Large as the speech encoder (``audio_model="wavlm"`` at
   ``config.WAVLM_LARGE``'s published widths, only its convolutions
   frozen), one warm-up step and ``WAVLM_STEPS`` timed steps with the
   counters reset just before them: every loss finite; K10 24 forward
   launches an encoder call (one table an encoder call,
   ``msmd.wavlm.bias_tables``: the trained call of the two clips, and
   clip 0's no-grad forward where it is cut) and 24 backward a step, 2B
   x 200 query rows a backward, ``msmd.k10.calls`` their sum, no call on
   the plain route (``msmd.k10.plain_calls``). It prints steps/s and the
   peak memory.

11. parallel (``phase_parallel``), at phase 10's width with
   ``fused_ffn_train`` (``measure.build_trainer``): a HuBERT-base HF
   directory (``config.json`` + ``pytorch_model.bin``) written from a
   second seeded encoder through the port's HF naming, and a
   ``model.safetensors`` copy by the port's writer, each loaded into the
   train path as ``--audio_weights`` loads it: every encoder tensor equal
   to what was written, bit for bit (the positional convolution's
   weight-norm pair folded by the loader; within 1 ulp of the source).
   ``Trainer.fit(profile_dir=)`` over 2 iterations writes one trace file
   that names K5's, K5 bwd's and K7's device kernels and holds a kernel
   record for every launch call (a fresh trainer's fit is traced again,
   up to 3 sessions, when the profiler dropped device records);
   ``device_memory_stats()`` reports a peak. NCCL at world size 1 (a
   spawned process, PyTorch's deterministic mode): the one-process
   trainer and the trainer on the data-parallel layout, a warm-up each
   and ``PAR_STEPS`` steps a turn in the order one, NCCL, NCCL, one;
   losses and parameters bit-equal; the steps/s of each turn. Two ranks on the one card over gloo (NCCL takes one rank a
   device): the eval-mode f32 step (the global batch's draws) at dp = 2
   and at tp = 2, and at dp = 2 the train-mode f32 step with both clips
   truncated (dropout off; the ranks' frame counts differ), against the
   one-process step at the CPU tests' bounds;
   ``PAR_TRAIN_STEPS`` train-mode steps at dp = 2 (a rank K5 4, K5 bwd 2
   and K7 8 + 8 launches a step, counted by the wrappers; then the device
   kernels of one more step in torch.profiler) and at tp = 2 (K5 and K5
   bwd the same, K7 never: the whole-weight kernels stay closed under
   tensor parallelism), the
   replicas' parameters equal; ``infer_coeffs`` at R = ``PAR_REPS`` over
   the two ranks: with the noise pinned to one global draw, each rank's
   rows against an unsharded call on the same rows of that draw (the same
   route, K1 flat at Be = 4) within ``PAR_SAMPLE_GATE`` of max |ref|; with
   the generator's draws, its launches, and its gap to the unsharded call
   at R (K1 per-entry at Be = 8, another summation order) reported.
   Every child is joined with a timeout; a failed check or a child's exit
   code other than 0 fails the phase.

Launch counts are set to 0 just before each path is driven and read just
after; each path runs a warm-up window first, so the timed run holds no
one-time set-up. The line before the last is the per-kernel summary
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

AUDIO_SECONDS = 8.0
GATE = 2e-2  # max |err| / max |plain| at bf16
SCAN_GATED_STEPS = 10
TRAIN_STEPS = 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build():
    """Builds every kernel; returns each library's ``-Xptxas -v`` output."""
    from msmd_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build(_build.sources())
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas {name}] {line.strip()}")
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs)})
    return logs


def ptxas_usage(log: str, kernel: str) -> dict:
    """Registers, stack frame and spill bytes of the entry function whose
    name holds ``kernel`` in one library's ``-Xptxas -v`` output, and the
    most spill bytes of any function that library compiles (the small-row
    stack's phase functions are not inlined)."""
    from msmd_tpu_torch._build import ptxas_entries

    out, funcs = {}, ptxas_entries(log).items()
    for name, usage in funcs:
        if kernel in name:
            out.update(usage)
    most = {k: max([u.get(k, 0) for _, u in funcs], default=0) for k in ("spill_stores", "spill_loads")}
    return {**out, "most_spill_any_function": most}


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at its path's shapes
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def _timed_once(fn):
    """(result, device ms) of one call, from CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# K6, K8 and K9 take 0.02-0.5 ms: enough calls that the card's clocks have
# risen before the timed ones (20 calls of K8 read slower than its
# L2-flushed calls once)
GUIDED_ITERS, GUIDED_WARMUP = 200, 50


def _guided_products(dev, products):
    """K6's or K9's products alone (``ffn_products``, ``tail_products``) on
    the route the kernel takes at their shapes and on the wmma tile, each
    against the plain product, timed beside ``torch.nn.functional.linear``
    at the same shape (bf16, the weight in the same nn.Linear layout,
    cuBLAS; a yardstick the port never calls; it takes neither the GELU nor
    the residual and LayerNorm)."""
    import torch
    import torch.nn.functional as tf

    from msmd_tpu_torch.measure import cuda_ms, gemm_ws_case
    from msmd_tpu_torch.ops.kernels import gemm_ws as kw

    out = {}
    for name, p in products.items():
        M, N, K, epi, plan = p["M"], p["N"], p["K"], p["epilogue"], p["plan"]
        res_dtype = {None: None, "bf16": torch.bfloat16, "f32": torch.float32}[p["res"]]
        args, kwargs = gemm_ws_case(dev, M, N, K, epi, res_dtype, p["out"])
        call = lambda route: kw.gemm_ws(*args, epi, route=route, **kwargs)
        got, old, want = call("auto"), call("wmma"), kw.gemm_ws_plain(*args, epi, **kwargs)
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        rel = max(_rel(a.float(), b.float()) for a, b in pairs)
        rel_wmma = max(_rel(a.float(), b.float()) for a, b in (zip(old, want) if isinstance(old, tuple)
                                                                  else [(old, want)]))
        flops = 2 * M * N * K
        ms = cuda_ms(lambda: call("auto"), GUIDED_ITERS, GUIDED_WARMUP)
        wmma_ms = cuda_ms(lambda: call("wmma"), GUIDED_ITERS, GUIDED_WARMUP)
        linear_ms = cuda_ms(lambda: tf.linear(args[0], args[1], args[2]), GUIDED_ITERS, GUIDED_WARMUP)
        out[name] = dict(M=M, N=N, K=K, epilogue=epi, res=p["res"], out=p["out"], route=plan["route"],
                         tile=plan["tile"], cluster=plan["cluster"], grid=plan["grid"], rel_err=rel,
                         rel_err_wmma=rel_wmma, ms=ms, tflops=flops / ms / 1e9, wmma_ms=wmma_ms,
                         wmma_tflops=flops / wmma_ms / 1e9, linear_ms=linear_ms,
                         linear_tflops=flops / linear_ms / 1e9,
                         ok=rel <= GATE and all(bool(torch.isfinite(a.float()).all()) for a, _ in pairs))
        del args, kwargs, got, old, want, pairs
    return out


def _device_ms_per_call(fn, calls: int = 50) -> float:
    """The device time of one call of ``fn``: its kernels' durations in
    torch.profiler over ``calls`` back-to-back calls, summed, over
    ``calls``."""
    from torch.autograd import DeviceType

    from msmd_tpu_torch.measure import profiled

    fn()
    prof = profiled(lambda: [fn() for _ in range(calls)])
    return sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3 / calls


def _guided_entries(dev):
    """K6, K8 and K9 against their plain versions at the guided batch-48
    shapes, timed beside their bounds, the unfused torch-op chains (K6,
    K9) and ``scaled_dot_product_attention`` (K8); K6's and K9's products
    alone."""
    import torch

    from msmd_tpu_torch.measure import (BF16_PEAK, attn_case, bound, cuda_ms, cuda_ms_flushed, ffn_case, ffn_chain,
                                        sdpa_call, tail_case, tail_chain)
    from msmd_tpu_torch.ops.kernels import attn as k8
    from msmd_tpu_torch.ops.kernels import ffn as k6
    from msmd_tpu_torch.ops.kernels import layer_tail as k9

    bf = torch.bfloat16
    ffn_args, tail_args = ffn_case(dev), tail_case(dev)
    ffn_w = k6.prepare_ffn_weights(*ffn_args[1:], dtype=bf)
    tail_w = k9.prepare_tail_weights(*tail_args[3:11], list(tail_args[11]), list(tail_args[12]), dtype=bf)
    cases = {
        # (kernel call, plain call, inputs, torch-op chain, source, TPU kernel); K8 (0.02 ms) first:
        # right after K6's and K9's products at full power its warm time, and SDPA's, read ~1.5x
        "attn": (k8.attention_middle, k8.attention_middle_plain, attn_case(dev), None,
                 "msmd_tpu_torch/csrc/attn.cu", "msmd_tpu/ops/pallas/attn_kernel.py:88"),
        "ffn": (lambda *a: k6.fused_ffn_ln(a[0], *ffn_w), k6.ffn_ln_plain, ffn_args, ffn_chain,
                "msmd_tpu_torch/csrc/ffn.cu", "msmd_tpu/ops/pallas/ffn_kernel.py:61"),
        "tail": (lambda *a: k9.fused_layer_tail(*a[:3], *tail_w), k9.layer_tail_plain, tail_args, tail_chain,
                 "msmd_tpu_torch/csrc/layer_tail.cu", "msmd_tpu/ops/pallas/layer_tail_kernel.py:77"),
    }
    names = {"ffn": k6.fused_ffn_ln.__name__, "attn": k8.attention_middle.__name__,
             "tail": k9.fused_layer_tail.__name__}
    entries = {}
    with torch.no_grad():
        for key, (fn, plain, args, chain, source, replaces) in cases.items():
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            rel = _rel(got.float(), want.float())
            products = {}
            if key == "ffn":
                x, w1 = args[0], args[1]
                flops, nbytes = k6.ffn_work(x.shape[0], x.shape[1], w1.shape[0])
                shape = {"rows": x.shape[0]}
                products = _guided_products(dev, k6.ffn_products(x.shape[0], x.shape[1], w1.shape[0]))
            elif key == "attn":
                q = args[0]
                flops, nbytes = k8.attn_work(q.shape[0], q.shape[1], q.shape[2])
                shape = {"entries": q.shape[0], "lq": q.shape[1], "heads": args[3]}
            else:
                x_m, w1 = args[1], args[7]
                R = x_m.shape[0] * x_m.shape[1]
                flops, nbytes = k9.tail_work(R, x_m.shape[2], w1.shape[0])
                shape = {"rows": R}
                products = _guided_products(dev, k9.tail_products(R, x_m.shape[2], w1.shape[0]))
            bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
            # warm times first: the L2 flushes write 256 MB between calls
            ms = cuda_ms(lambda: fn(*args), GUIDED_ITERS, GUIDED_WARMUP)
            if chain is None:
                sdpa, heads = sdpa_call(*args)
                library_ms, library, chain_ms = cuda_ms(sdpa, GUIDED_ITERS, GUIDED_WARMUP), \
                    "scaled_dot_product_attention", None
                # K8 is ~0.02 ms of device work a call: the warm ms (CUDA
                # events over back-to-back calls) also holds the host's time
                # to launch each call, which the device time alone does not
                flushed = {"ms_l2_flushed": cuda_ms_flushed(lambda: fn(*args), 50),
                           "library_ms_l2_flushed": cuda_ms_flushed(sdpa, 50),
                           "device_ms": _device_ms_per_call(lambda: fn(*args)),
                           "library_device_ms": _device_ms_per_call(sdpa)}
                del heads
            else:
                library_ms, library = None, "none: no one call computes it"
                chain_ms = cuda_ms(lambda: chain(*args), GUIDED_ITERS, GUIDED_WARMUP)
                flushed = {"ms_l2_flushed": cuda_ms_flushed(lambda: fn(*args), 50)}
            extra = {"products": products} if products else {}
            entries[key] = dict(
                name=names[key], route="cuda", source=source, replaces=replaces,
                max_abs_err=float((got.float() - want.float()).abs().max()), rel_err=rel,
                tolerance=f"max|err|/max|plain| <= {GATE}", **shape, ms=ms,
                plain_ms=cuda_ms(lambda: plain(*args), 3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, library=library, chain_ms=chain_ms,
                flops=flops, bytes=nbytes, **flushed, **extra,
                ok=bool(torch.isfinite(got).all()) and rel <= GATE and all(p["ok"] for p in products.values()),
            )
            del got, want
        del cases, ffn_args, tail_args, ffn_w, tail_w
    return entries


def _warm_in_turns(kernel, library, turns: int = 3):
    """(kernel ms, library ms): each the median of ``turns`` warm timings
    (``cuda_ms`` over ``GUIDED_ITERS`` calls) taken in turns, kernel,
    library, library, kernel, ..., so that a drift of the host's speed,
    which sets both warm times at these shapes, falls on both alike."""
    from msmd_tpu_torch.measure import cuda_ms

    times = ([], [])
    for turn in range(2 * turns):
        side = (turn + turn // 2) % 2  # 0, 1, 1, 0, 0, 1
        times[side].append(cuda_ms((kernel, library)[side], GUIDED_ITERS, GUIDED_WARMUP))
    return statistics.median(times[0]), statistics.median(times[1])


K8_F32_GATE = 1e-5  # max |err| / max |plain| of K8's f32 mode (f32 sums in other orders, 3xTF32 products)
STYLE_CLIP = 100  # frames of the style clip the encoders read (inference.py's 4 s at 25 fps)
K8_F32_BATCHES = {"attn_f32": 1, "attn_f32_b16": 16}  # inference's one clip; a train batch's eval-mode encode


def _k8_f32_entries(dev):
    """K8's f32 mode (the style encoders' attention: 100 rows an entry, F
    512, 8 heads of 64, q, k, v the column slices of one f32 projection) at
    B = 1 and B = 16 against the plain version at f32 with TF32 off: max
    |err| / max |plain| <= 1e-5, two calls bit-equal, one device kernel a
    call in torch.profiler; timed warm, with the L2 flushed and by device
    time alone, beside its bound (three TF32 products a product, or the
    bytes) and ``scaled_dot_product_attention`` at f32 on the same tensors
    (a yardstick the port never calls)."""
    import torch

    from msmd_tpu_torch.measure import TF32_PEAK, attn_case, bound, cuda_ms, cuda_ms_flushed, sdpa_call
    from msmd_tpu_torch.ops.kernels import attn as k8

    out = {}
    with torch.no_grad():
        for key, B in K8_F32_BATCHES.items():
            q, k, v, H = attn_case(dev, B=B, lq=STYLE_CLIP, seed=B + 50, dtype=torch.float32)
            call = lambda: k8.attention_middle(q, k, v, H)
            got, again, want = call(), call(), k8.attention_middle_plain(q, k, v, H)
            torch.cuda.synchronize()
            rel = _rel(got, want)
            launched = _device_launches(call, "attn_f32_kernel")
            flops, nbytes = k8.attn_work(B, STYLE_CLIP, q.shape[2], torch.float32)
            bound_ms, bound_by = bound(3 * flops, nbytes, TF32_PEAK)  # three TF32 products a product
            sdpa, heads = sdpa_call(q, k, v, H)
            ms, library_ms = _warm_in_turns(call, sdpa)
            checks = {"finite": bool(torch.isfinite(got).all()), "dtype": got.dtype == torch.float32,
                      "gate": rel <= K8_F32_GATE, "bit_equal_across_calls": bool(torch.equal(got, again)),
                      "one_launch_a_call": launched["kernel"] == 1}
            out[key] = dict(
                name=k8.attention_middle_f32.__name__, route="cuda", source="msmd_tpu_torch/csrc/attn.cu",
                replaces="msmd_tpu/ops/pallas/attn_kernel.py:88", entries=B, lq=STYLE_CLIP, heads=H,
                max_abs_err=float((got - want).abs().max()), rel_err=rel,
                tolerance=f"max|err|/max|plain| <= {K8_F32_GATE}", ms=ms,
                ms_l2_flushed=cuda_ms_flushed(call, 50), device_ms=_device_ms_per_call(call),
                plain_ms=cuda_ms(lambda: k8.attention_middle_plain(q, k, v, H), 20, warmup=2),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library="scaled_dot_product_attention (f32)", library_ms_l2_flushed=cuda_ms_flushed(sdpa, 50),
                library_device_ms=_device_ms_per_call(sdpa), flops=flops, bytes=nbytes,
                device_kernels_per_call=launched, plan=k8.attn_f32_plan(B, STYLE_CLIP, H), checks=checks,
                ok=all(checks.values()))
            del q, k, v, got, again, want, heads
    return out


def _product_entries(dev, Be, lq, F, L, FF):
    """K1's four large products alone at its shapes, on the route K1 takes
    (the warp-specialised Hopper GEMM at these rows), on the 256-thread
    tile loop that K2 runs (K1's route before; ``loop_ms``, and
    ``bit_equal_loop``, gated) and on the wmma tile (not for self-out's
    cross epilogue, which only the Hopper GEMM takes), each against the
    plain product, timed beside the product's bound (``bound_ms``,
    ``bound_by``) and ``torch.nn.functional.linear`` at the same shape (bf16
    in and out, cuBLAS; a yardstick the port never calls; it does not take
    the LayerNorm of the residual products)."""
    import torch
    import torch.nn.functional as tf

    from msmd_tpu_torch.measure import BF16_PEAK, bound, cuda_ms, decoder_products, gemm_case
    from msmd_tpu_torch.ops.kernels import gemm as kg

    out = {}
    for name, p in decoder_products(Be, lq, F, L, FF).items():
        M, N, K, epi = p["M"], p["N"], p["K"], p["epilogue"]
        if epi is None:  # the person rows (Be rows, gathered) stay on the wmma tile inside K1
            continue
        args, kw = gemm_case(dev, M, N, K, epi, lq=lq)
        call = lambda route: kg.gemm(*args[:3], epi, *args[3:], route=route, **kw)
        got, want, loop = call("auto"), kg.gemm_plain(*args[:3], epi, *args[3:], **kw), call("sm90_loop")
        ln = epi.startswith("resid_ln")
        old = call("wmma") if epi != "resid_ln_cross" else None
        torch.cuda.synchronize()
        if ln:
            rel = max(_rel(got[0], want[0]), _rel(got[1].float(), want[1].float()))
            rel_wmma = _rel(old[0], want[0]) if old is not None else None
            bit_equal = all(torch.equal(a, b) for a, b in zip(got, loop))
        else:
            rel, rel_wmma = _rel(got.float(), want.float()), _rel(old.float(), want.float())
            bit_equal = torch.equal(got, loop)
        w_t = args[1].t().contiguous()
        flops, nbytes = kg.gemm_work(M, N, K, epi)
        ms, loop_ms = cuda_ms(lambda: call("auto"), 20), cuda_ms(lambda: call("sm90_loop"), 20)
        wmma_ms = cuda_ms(lambda: call("wmma"), 20) if old is not None else None
        linear_ms = cuda_ms(lambda: tf.linear(args[0], w_t, args[2]), 20)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        plan = kg.gemm_plan(M, N, K, epi)
        out[name] = dict(M=M, N=N, K=K, epilogue=epi, calls_per_step=L, route=plan["route"], tile=plan["tile"],
                         cluster=plan["cluster"], grid=plan["grid"], rel_err=rel, rel_err_wmma=rel_wmma, ms=ms,
                         tflops=flops / ms / 1e9, bound_ms=bound_ms, bound_by=bound_by, loop_ms=loop_ms,
                         bit_equal_loop=bit_equal, wmma_ms=wmma_ms,
                         wmma_tflops=flops / wmma_ms / 1e9 if wmma_ms else None, linear_ms=linear_ms,
                         linear_tflops=flops / linear_ms / 1e9,
                         ok=rel <= GATE and bit_equal and bool(torch.isfinite(got[0] if ln else got.float()).all()))
        del args, got, want, old, loop, w_t
    return out


def _device_launches(call, kernel: str) -> dict:
    """The kernels the card ran in one ``call``, from torch.profiler's
    device events: those of ``kernel`` and the others (the wrapper's own
    torch ops, such as the row-index tensors it builds)."""
    from msmd_tpu_torch.measure import kernel_events, profiled

    names = [e.name for e in kernel_events(profiled(call))]
    ours = sum(kernel in n for n in names)
    return {"kernel": ours, "other_kernels": len(names) - ours}


def _small_stack_fields(plan: dict, usage: dict, launched: dict, steps: int, planned) -> dict:
    """The persistent small-row stack's launch facts for a kernel entry:
    ``launched`` from ``_device_launches`` over one call of ``steps``
    sampler steps, beside the plan's launches a step."""
    return dict(grid_blocks=plan["grid"], blocks_per_sm=plan["per_sm"], smem_bytes=plan["smem"],
                phases_per_step=len(plan["rows"]), launches_per_step=launched["kernel"] / steps,
                device_kernels_per_call=launched, planned_launches_per_step=planned,
                registers=usage.get("registers"), spill_stores=usage.get("spill_stores"),
                spill_loads=usage.get("spill_loads"), stack_frame=usage.get("stack_frame"),
                most_spill_any_function=usage.get("most_spill_any_function"))


def phase_kernels(dev, logs):
    import torch

    from msmd_tpu_torch.measure import (BF16_PEAK, HBM_RATE, bound, cuda_ms, cuda_ms_flushed, decoder_case,
                                        decoder_work, sampler_case, sampler_work)
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import sampler as ks

    out = {}
    with torch.no_grad():
        args = decoder_case(dev)
        got = kd.fused_decoder_forward(*args)
        want = kd.fused_decoder_forward_plain(*args)
        torch.cuda.synchronize()
        err, rel = float((got - want).abs().max()), _rel(got, want)
        flops, nbytes = decoder_work(args)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        Be, lq, F = args[3].shape
        L, FF = args[0]["wqkv"].shape[0], args[0]["wf1"].shape[-1]
        products = _product_entries(dev, Be, lq, F, L, FF)
        out["decoder"] = dict(
            name="fused_decoder_forward", route="cuda", source="msmd_tpu_torch/csrc/decoder.cu",
            replaces="msmd_tpu/ops/pallas/decoder_kernel.py:560",
            max_abs_err=err, rel_err=rel, tolerance=f"max|err|/max|plain| <= {GATE}",
            ms=cuda_ms(lambda: kd.fused_decoder_forward(*args), 20),
            ms_l2_flushed=cuda_ms_flushed(lambda: kd.fused_decoder_forward(*args), 10),
            plain_ms=cuda_ms(lambda: kd.fused_decoder_forward_plain(*args), 3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None, flops=flops, bytes=nbytes, products=products,
            ok=bool(torch.isfinite(got).all()) and rel <= GATE and all(p["ok"] for p in products.values()),
        )
        del args, got, want

        scan, step, kw = sampler_case(dev)
        pack, kmem, vmem, motion, emb, sc, z, const = scan
        n = SCAN_GATED_STEPS
        tail = (pack, kmem, vmem, motion, emb[-n:], sc[-n:], z[-n:], const)  # t = n..1
        got = ks.fused_sampler_scan(*tail, **kw)
        want = ks.fused_sampler_scan_plain(*tail, **kw)
        torch.cuda.synchronize()
        err, rel = float((got - want).abs().max()), _rel(got, want)
        got_full = ks.fused_sampler_scan(*scan, **kw)
        again = ks.fused_sampler_scan(*scan, **kw)
        want_full, plain_ms = _timed_once(lambda: ks.fused_sampler_scan_plain(*scan, **kw))
        rel_full = _rel(got_full, want_full)
        flops, nbytes = sampler_work(scan, kw)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        T = int(z.shape[0])
        L, F, FF = pack["wqkv"].shape[0], pack["wso"].shape[-1], pack["wf1"].shape[-1]
        lq = const["pe_flat"].shape[0] // kw["n_entries"]
        plan = ks.scan_plan(lq, F, kw["n_heads"], L, FF, kw["n_cur"], kw["d_motion"], kw["num_basis"],
                            const["wd1"].shape[-1], kw["use_indicator"], kw["n_entries"])
        out["scan"] = dict(
            name="fused_sampler_scan", route="cuda", source="msmd_tpu_torch/csrc/sampler.cu",
            replaces="msmd_tpu/ops/pallas/decoder_kernel.py:1142",
            max_abs_err=float((got_full - want_full).abs().max()), rel_err=rel_full,
            tolerance=f"max|err|/max|plain| <= {GATE} over all {T} steps and over t = {n}..1",
            steps=T, max_abs_err_last_steps=err, rel_err_last_steps=rel,
            ms=cuda_ms(lambda: ks.fused_sampler_scan(*scan, **kw), 3, warmup=1),
            ms_l2_flushed=cuda_ms_flushed(lambda: ks.fused_sampler_scan(*scan, **kw), 3),
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            weight_stream_floor_ms=T * sum(t.numel() * t.element_size() for t in pack.values()) / HBM_RATE * 1e3,
            library_ms=None, flops=flops, bytes=nbytes, deterministic=bool(torch.equal(got_full, again)),
            **_small_stack_fields(plan, ptxas_usage(logs.get("sampler", ""), "scan_kernel"),
                                  _device_launches(lambda: ks.fused_sampler_scan(*scan, **kw), "scan_kernel"), T,
                                  1 / T),
            ok=bool(torch.isfinite(got_full).all()) and rel_full <= GATE and rel <= GATE
            and bool(torch.equal(got_full, again)),
        )
        del got, want, got_full, want_full, again

        # K4 at t = 1 (x_0 = target: the whole denoiser) and at t = T
        at_T = (pack, kmem, vmem, motion, emb[0], sc[0], z[0], step[7])
        gated = {}
        for t, args in (("1", step), ("T", at_T)):
            got, again = ks.fused_sampler_step(*args, **kw), ks.fused_sampler_step(*args, **kw)
            want = ks.fused_sampler_step_plain(*args, **kw)
            torch.cuda.synchronize()
            gated[t] = dict(max_abs_err=float((got - want).abs().max()), rel_err=_rel(got, want),
                            deterministic=bool(torch.equal(got, again)), finite=bool(torch.isfinite(got).all()))
        flops, nbytes = sampler_work(step, kw, step=True)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        step_plan = ks.scan_plan(lq, F, kw["n_heads"], L, FF, kw["n_cur"], kw["d_motion"], kw["num_basis"],
                                 const["wd1"].shape[-1], kw["use_indicator"], kw["n_entries"], step=True)
        ms = cuda_ms(lambda: ks.fused_sampler_step(*step, **kw), 50, 5)
        out["step"] = dict(
            name="fused_sampler_step", route="cuda", source="msmd_tpu_torch/csrc/sampler.cu",
            replaces="msmd_tpu/ops/pallas/decoder_kernel.py:1227",
            max_abs_err=max(g["max_abs_err"] for g in gated.values()), rel_err=gated["1"]["rel_err"],
            rel_err_t_T=gated["T"]["rel_err"], tolerance=f"max|err|/max|plain| <= {GATE} at t = 1 and at t = T",
            ms=ms, k3_ms_per_step=out["scan"]["ms"] / T,
            ms_l2_flushed=cuda_ms_flushed(lambda: ks.fused_sampler_step(*step, **kw), 20),
            plain_ms=cuda_ms(lambda: ks.fused_sampler_step_plain(*step, **kw), 3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None, flops=flops, bytes=nbytes,
            deterministic=all(g["deterministic"] for g in gated.values()),
            **_small_stack_fields(step_plan, ptxas_usage(logs.get("sampler", ""), "step_kernel"),
                                  _device_launches(lambda: ks.fused_sampler_step(*step, **kw), "step_kernel"), 1, 1),
            ok=all(g["finite"] and g["rel_err"] <= GATE and g["deterministic"] for g in gated.values()),
        )
        del scan, step, got, want, again, at_T

        out["lbs"] = _lbs_entry(dev, logs)
        out["lbs_bwd"] = _lbs_bwd_entry(dev, logs)
        out.update(_flat_and_resident_entries(dev, logs))
        out.update(_k7_entries(dev))
        out.update(_guided_entries(dev))
        out.update(_k8_f32_entries(dev))
        out.update(_k10_entries(dev, logs))
    from msmd_tpu_torch.measure import profiled

    emit({"phase": "kernels", **out, "profiler_sessions_lost": profiled.lost})
    bad = {k: {c: ok for c, ok in v.get("checks", {}).items() if not ok} for k, v in out.items() if not v["ok"]}
    if bad:
        raise SystemExit(f"chip_smoke: kernel(s) disagree with their plain version (failed checks): {bad}")
    return out


LBS_GATE, LBS_F32_GATE = 1e-4, 1e-5  # max |err| against the f32 plain version


def _lbs_entry(dev, logs):
    """K5 at N = 4800 (a batch-48 window) and N = 100 (batch 1), V = 5023,
    each against the plain version (max |err| <= 1e-4 and the f32-class
    <= 1e-5), finite, of its shape, two calls bit-equal, the plan's device
    kernels a call in torch.profiler, timed warm and L2-flushed beside its
    bound (3xTF32), the f32 CUDA-core bound and f32 ``torch.matmul`` of
    the blend product alone (no TF32; a yardstick the port never calls).
    The entry's top-level numbers are N = 4800's."""
    import torch

    from msmd_tpu_torch.measure import cuda_ms, cuda_ms_flushed, lbs_bound, lbs_case, lbs_work
    from msmd_tpu_torch.ops.kernels import lbs as kl

    usage = {name: ptxas_usage(logs.get("lbs", ""), mangled) for name, mangled in
             (("lbs_kernel", "lbs_kernel"), ("lbs_split_kernel", "lbs_split_kernel"))}
    forms = {}
    for N in (4800, 100):
        fused, (betas_ext, rt) = lbs_case(dev, N=N)
        call = lambda: kl.skin_cuda(fused, betas_ext, rt)
        got, again, want = call(), call(), kl.skin_plain(fused, betas_ext, rt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        blend, skin, nbytes = lbs_work(fused, betas_ext, rt)
        bound_ms, bound_by, simt_ms = lbs_bound(blend, skin, nbytes)
        plan = kl.lbs_plan(N, fused.n_verts, torch.cuda.get_device_properties(dev).multi_processor_count)
        KB = betas_ext.shape[1]
        bases = fused.dirs.permute(1, 0, 2).reshape(KB, -1).contiguous()  # (KB, 3 Vp)
        ms, launched = cuda_ms(call, 20, 5), _device_launches(call, "lbs")
        forms[N] = dict(
            frames=N, verts=fused.n_verts, max_abs_err=err,
            tolerance=f"max|err| <= {LBS_GATE} and <= {LBS_F32_GATE}", ms=ms, ms_l2_flushed=cuda_ms_flushed(call, 20),
            plain_ms=cuda_ms(lambda: kl.skin_plain(fused, betas_ext, rt), 3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by, f32_simt_bound_ms=simt_ms, tflops=(blend + skin) / ms / 1e9,
            blend_matmul_ms=cuda_ms(lambda: torch.matmul(betas_ext, bases), 20, 5),
            matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
            matmul_precision=torch.get_float32_matmul_precision(), blend_flops=blend, skin_flops=skin,
            bytes=nbytes, plan=plan, launches_per_call=launched, planned_launches_per_call=plan["launches"],
            bit_equal_across_calls=bool(torch.equal(got, again)),
            ok=bool(torch.isfinite(got).all()) and tuple(got.shape) == (N, fused.n_verts, 3)
            and err <= LBS_GATE and err <= LBS_F32_GATE and bool(torch.equal(got, again))
            and launched["kernel"] == plan["launches"],
        )
        del fused, betas_ext, rt, got, again, want, bases
    top = forms[4800]
    return dict(name="flame_vertices", route="cuda", source="msmd_tpu_torch/csrc/lbs.cu",
                replaces="msmd_tpu/ops/pallas/lbs_kernel.py:197", library_ms=None,
                library="none: no one call computes it (blend_matmul_ms is the product part alone)",
                **{k: top[k] for k in ("max_abs_err", "tolerance", "ms", "ms_l2_flushed", "plain_ms", "bound_ms",
                                       "bound_by", "f32_simt_bound_ms", "blend_matmul_ms", "matmul_allow_tf32",
                                       "bit_equal_across_calls", "launches_per_call",
                                       "planned_launches_per_call")},
                forms={str(k): v for k, v in forms.items()}, ptxas=usage, ok=all(f["ok"] for f in forms.values()))


LBS_BWD_GATE = 1e-4  # max |err| / max |plain| of dv, dR and dt (f32, other summation orders)


def _lbs_bwd_entry(dev, logs):
    """K5 bwd at N = 1760 (clip 1's predicted frames of a batch-16 train
    step), V = 5023, against the skinning terms of the plain VJP
    (``skin_vjp_plain``, JAX's einsums with gw materialised) on the same
    card tensors: dv, dR and dt each gated at max |err| / max |plain|, two
    calls bit-equal, dv zero past V, the two device kernels a call in
    torch.profiler; timed warm and L2-flushed beside its bound."""
    import torch

    from msmd_tpu_torch.measure import cuda_ms, cuda_ms_flushed, lbs_bwd_bound, lbs_bwd_case, lbs_bwd_work
    from msmd_tpu_torch.ops.kernels import lbs as kl

    fused, betas_ext, rt, planes, g = lbs_bwd_case(dev)
    N, V = rt.shape[0], fused.n_verts
    call = lambda: kl.skin_vjp_cuda(fused, planes, rt, g)
    (dv, d_rt), (dv2, d_rt2) = call(), call()
    want_dv, want_rt = kl.skin_vjp_plain(fused, planes, rt, g)
    torch.cuda.synchronize()
    got_rt, want = d_rt.reshape(N, 5, 3, 4), want_rt.reshape(N, 5, 3, 4)
    rel = {"dv": _rel(dv, want_dv), "dR": _rel(got_rt[..., :3], want[..., :3]),
           "dt": _rel(got_rt[..., 3], want[..., 3])}
    err = max(float((dv - want_dv).abs().max()), float((d_rt - want_rt).abs().max()))
    bit_equal = bool(torch.equal(dv, dv2)) and bool(torch.equal(d_rt, d_rt2))
    del dv2, d_rt2, want_dv, want_rt, want, got_rt
    flops, nbytes = lbs_bwd_work(fused, N)
    bound_ms, bound_by = lbs_bwd_bound(fused, N)
    ms, launched = cuda_ms(call, 50, 5), _device_launches(call, "lbs_bwd")
    out = dict(
        name="flame_vertices backward (skinning VJP)", route="cuda", source="msmd_tpu_torch/csrc/lbs_bwd.cu",
        replaces="msmd_tpu/ops/pallas/lbs_kernel.py:92", frames=N, verts=V, max_abs_err=err, rel_err=rel,
        tolerance=f"max|err|/max|plain| <= {LBS_BWD_GATE} for dv, dR and dt; two calls bit-equal",
        ms=ms, ms_l2_flushed=cuda_ms_flushed(call, 20),
        plain_ms=cuda_ms(lambda: kl.skin_vjp_plain(fused, planes, rt, g), 5, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        library="none: no one call computes it (plain_ms is JAX's einsum chain, gw materialised)",
        flops=flops, bytes=nbytes, gbytes_per_s=nbytes / ms / 1e6, launches_per_call=launched,
        planned_launches_per_call=2, bit_equal_across_calls=bit_equal,
        ptxas={k: ptxas_usage(logs.get("lbs_bwd", ""), k) for k in ("lbs_bwd_kernel", "lbs_bwd_reduce_kernel")},
        ok=all(v <= LBS_BWD_GATE for v in rel.values()) and bool(torch.isfinite(dv).all())
        and bool(torch.isfinite(d_rt).all()) and not bool(dv[:, :, V:].any()) and bit_equal
        and launched["kernel"] == 2,
    )
    del fused, betas_ext, rt, planes, g, dv, d_rt
    return out


NO_LIBRARY = "none: no one call computes a decoder stack"


def _flat_and_resident_entries(dev, logs):
    """K1's flat-mask mode in both cross forms and K2, each against its
    plain version, timed beside its bound; K2 also beside K1's kernel, and
    at the small-row shapes (Be = 2, 4, 6 and 8) beside K1 per-entry."""
    import torch

    from msmd_tpu_torch.measure import BF16_PEAK, bound, cuda_ms, cuda_ms_flushed, decoder_case, \
        decoder_flat_case, decoder_flat_work, decoder_work
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import decoder_resident as kdr

    from msmd_tpu_torch.models.diffusion import decoder_route
    from msmd_tpu_torch.ops.kernels.small_stack import flat_uses_chain

    usage = ptxas_usage(logs.get("decoder", ""), "flat_kernel")
    forms = {}
    # the 2-slot round, batch 1 without the alignment mask (both on the
    # small stack), and batch 48 without it (Be = 96 in tiles of 8: the
    # chain on the Hopper GEMM)
    for form, Be, width in (("identity_band", 4, 1), ("full_cross", 2, 0), ("full_cross_batch48", 96, 0)):
        args = decoder_flat_case(dev, Be=Be, width=width, tile=decoder_route(width, Be, 111)[1])
        call = lambda: kd.fused_decoder_forward_flat(*args)
        got, again = call(), call()
        want = kd.fused_decoder_forward_plain(*args)
        torch.cuda.synchronize()
        rel = _rel(got, want)
        flops, nbytes = decoder_flat_work(args)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        lq, F, L, FF = int(args[3].shape[1]), int(args[3].shape[2]), args[0]["wqkv"].shape[0], args[0]["wf1"].shape[-1]
        if flat_uses_chain(Be, lq, F, FF):
            launched = _device_launches(call, "_kernel")
            route = dict(route="chain", device_kernels_per_call=launched["kernel"] + launched["other_kernels"])
        else:
            plan = kd.flat_plan(Be, lq, F, args[5], L, FF, args[9], width == 1)
            route = dict(route="small_stack", **_small_stack_fields(plan, usage, _device_launches(call, "flat_kernel"),
                                                                    1, 1))
        forms[form] = dict(entries=Be, tile=args[9], lq=lq, align_mask_width=width,
                           max_abs_err=float((got - want).abs().max()), rel_err=rel,
                           ms=cuda_ms(call, 20), ms_l2_flushed=cuda_ms_flushed(call, 10),
                           plain_ms=cuda_ms(lambda: kd.fused_decoder_forward_plain(*args), 3, warmup=1),
                           bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
                           deterministic=bool(torch.equal(got, again)), **route,
                           ok=bool(torch.isfinite(got).all()) and rel <= GATE and bool(torch.equal(got, again)))
        del args, got, want, again, call
    band = forms["identity_band"]
    facts = {k: band[k] for k in ("grid_blocks", "blocks_per_sm", "smem_bytes", "phases_per_step",
                                   "launches_per_step", "device_kernels_per_call", "planned_launches_per_step",
                                   "registers", "spill_stores", "spill_loads", "stack_frame",
                                   "most_spill_any_function")}
    out = {"decoder_flat": dict(
        name="fused_decoder_forward_flat", route="cuda", source="msmd_tpu_torch/csrc/decoder.cu",
        replaces="msmd_tpu/ops/pallas/decoder_kernel.py:560",
        max_abs_err=max(f["max_abs_err"] for f in forms.values()), tolerance=f"max|err|/max|plain| <= {GATE}",
        ms=band["ms"], ms_l2_flushed=band["ms_l2_flushed"], plain_ms=band["plain_ms"], bound_ms=band["bound_ms"],
        bound_by=band["bound_by"], library_ms=None, library=NO_LIBRARY, **facts,
        deterministic=all(f["deterministic"] for f in forms.values()), forms=forms,
        ok=all(f["ok"] for f in forms.values()))}

    args = decoder_case(dev)
    got = kdr.fused_decoder_forward_resident(*args)
    k1 = kd.fused_decoder_forward(*args)
    want = kdr.fused_decoder_forward_resident_plain(*args)
    torch.cuda.synchronize()
    rel = _rel(got, want)
    flops, nbytes = decoder_work(args)
    bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
    attrs, usage = kdr.resident_attributes(), ptxas_usage(logs.get("decoder_resident", ""), "resident_kernel")
    call, k1_call = (lambda: kdr.fused_decoder_forward_resident(*args)), (lambda: kd.fused_decoder_forward(*args))
    out["resident"] = dict(
        name="fused_decoder_forward_resident", route="cuda", source="msmd_tpu_torch/csrc/decoder_resident.cu",
        replaces="msmd_tpu/ops/pallas/decoder_kernel.py:723", max_abs_err=float((got - want).abs().max()),
        rel_err=rel, tolerance=f"max|err|/max|plain| <= {GATE}, and bit-equal to K1",
        max_abs_diff_vs_k1=float((got - k1).abs().max()), bit_equal_k1=bool(torch.equal(got, k1)),
        grid_blocks=kdr.resident_grid(), threads=attrs["threads"], registers=attrs["registers"],
        local_bytes=attrs["local_bytes"],
        spill_bytes=usage.get("spill_stores"), spill_loads=usage.get("spill_loads"),
        stack_frame=usage.get("stack_frame"), dynamic_smem=attrs["dynamic_smem"],
        ms=cuda_ms(call, 20), k1_ms=cuda_ms(k1_call, 20), ms_l2_flushed=cuda_ms_flushed(call, 10), k1_ms_l2_flushed=cuda_ms_flushed(k1_call, 10),
        plain_ms=cuda_ms(lambda: kdr.fused_decoder_forward_resident_plain(*args), 3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, library=NO_LIBRARY, flops=flops, bytes=nbytes,
        ok=bool(torch.isfinite(got).all()) and rel <= GATE and bool(torch.equal(got, k1)))
    del args, got, k1, want, call, k1_call
    small = {}
    for Be in (2, 4, 6, 8):  # below the Hopper GEMM's rows: the wmma tiles, beside K1 per-entry
        args = decoder_case(dev, Be=Be)
        small[f"be{Be}"] = dict(ms=cuda_ms(lambda: kdr.fused_decoder_forward_resident(*args), 20),
                                k1_ms=cuda_ms(lambda: kd.fused_decoder_forward(*args), 20),
                                bit_equal_k1=bool(torch.equal(kdr.fused_decoder_forward_resident(*args),
                                                              kd.fused_decoder_forward(*args))))
        del args
    out["resident"]["small_rows"] = small
    out["resident"]["ok"] = out["resident"]["ok"] and all(v["bit_equal_k1"] for v in small.values())
    return out


def _k7_entries(dev):
    """K7 forward and backward against their plain versions (at p 0.1 and p
    0), their mask bits against the plain generator, two calls bit-equal,
    the launches a call from torch.profiler beside the plan's, and their
    times beside their bounds and the unfused torch-op chain's."""
    import torch

    from msmd_tpu_torch.measure import BF16_PEAK, bound, cuda_ms, cuda_ms_flushed, ffn_train_case, ffn_train_chain
    from msmd_tpu_torch.ops.kernels import ffn_train as k7

    args, gbar = ffn_train_case(dev)
    x, w1, b1, w2, b2, g, b, seed, p = args
    R, F, FF = x.shape[0], x.shape[1], w1.shape[0]
    names = ("out", "dx", "dw1", "db1", "dw2", "db2", "dg", "db")
    calls = lambda a: [k7.ffn_train_forward(*a)] + list(k7.ffn_train_backward(a[0], gbar, *a[1:]))
    rel, err, finite = {}, {}, True
    for case in (args, args[:8] + (0.0,)):
        got, again = calls(case), calls(case)
        want = [k7.ffn_train_forward_plain(*case)] + list(k7.ffn_train_backward_plain(case[0], gbar, *case[1:]))
        torch.cuda.synchronize()
        key = "" if case[8] == p else "_p0"
        rel.update({n + key: _rel(a.float(), w.float()) for n, a, w in zip(names, got, want)})
        err.update({n + key: float((a.float() - w.float()).abs().max()) for n, a, w in zip(names, got, want)})
        finite = finite and all(bool(torch.isfinite(a).all()) for a in got)
        if not key:
            bit_equal = {n: bool(torch.equal(a, c)) for n, a, c in zip(names, got, again)}
        del got, again, want
    mismatches = sum(int((k7.kernel_mask_bits(seed, salt, R, cols) != k7.philox_bits(seed, salt, R, cols, dev)).sum())
                     for salt, cols in ((1, FF), (2, F)))

    with torch.enable_grad():
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2, g, b)]
        chain_out = ffn_train_chain(*leaves, p)
        chain_fwd_ms = cuda_ms(lambda: ffn_train_chain(*leaves, p), 20)
        chain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(chain_out, leaves, gbar, retain_graph=True), 20)
        del chain_out, leaves
    entries = {}
    for key, bwd in (("ffn_train_fwd", False), ("ffn_train_bwd", True)):
        flops, nbytes = k7.ffn_train_work(R, F, FF, bwd)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        plan = k7.ffn_train_plan(R, F, FF, bwd)
        if bwd:
            fn = lambda: k7.ffn_train_backward(x, gbar, *args[1:])
            plain = lambda: k7.ffn_train_backward_plain(x, gbar, *args[1:])
            gated = [n for n in names[1:]]
        else:
            fn, plain = (lambda: k7.ffn_train_forward(*args)), (lambda: k7.ffn_train_forward_plain(*args))
            gated = ["out"]
        gated = {n + k: rel[n + k] for n in gated for k in ("", "_p0")}
        launched = _device_launches(fn, "gemm_train_kernel" if plan["route"] == "wgmma" else "tgemm_kernel")
        per_call = launched["kernel"] + launched["other_kernels"]
        equal = {n: bit_equal[n] for n in (names[1:] if bwd else names[:1])}
        entries[key] = dict(
            name="fused_ffn_ln_train " + ("backward" if bwd else "forward"), route="cuda",
            source="msmd_tpu_torch/csrc/ffn_train.cu",
            replaces="msmd_tpu/ops/pallas/ffn_train_kernel.py:" + ("304" if bwd else "261"),
            kernel_route=plan["route"], planned_launches_per_call=plan["launches"], launches_per_call=per_call,
            device_kernels_per_call=launched, row_chunks=plan["row_chunks"], grids=plan["grids"],
            max_abs_err=max(err[n] for n in gated), rel_err=gated,
            tolerance=f"max|err|/max|plain| <= {GATE} for each output at p {p} and p 0; mask bits exact; "
                      "two calls bit-equal",
            mask_bit_mismatches=mismatches, bit_equal_across_calls=equal, rows=R,
            ms=cuda_ms(fn, 50, 10), device_ms=_device_ms_per_call(fn), ms_l2_flushed=cuda_ms_flushed(fn, 20),
            plain_ms=cuda_ms(plain, 3, warmup=1), bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            library="none: no one call computes it", chain_ms=chain_bwd_ms if bwd else chain_fwd_ms,
            flops=flops, bytes=nbytes,
            checks=dict(finite=finite, mask_bits_exact=mismatches == 0,
                        within_gate=all(v <= GATE for v in gated.values()), bit_equal=all(equal.values()),
                        planned_launches=per_call == plan["launches"]),
        )
        entries[key]["ok"] = all(entries[key]["checks"].values())
    return entries


K10_GATE = {"out": 2e-2, "lse": 1e-5, "dq": 2e-2, "dk": 2e-2, "dv": 2e-2, "dg": 1e-3, "dr": 1e-3}  # the card tests'
K10_SHAPE = (32, 200, 16)  # the WavLM-Large cell: 32 clips of 200 tokens, 16 heads of 64


def _k10_entries(dev, logs):
    """K10 forward and backward at ``K10_SHAPE`` against the plain twin,
    two calls bit-equal, the device kernels of a call, and their times
    beside the bound, the twin and SDPA with the gated bias as a mask."""
    import torch
    import torch.nn.functional as tf

    from msmd_tpu_torch.measure import BF16_PEAK, bound, cuda_ms, cuda_ms_flushed
    from msmd_tpu_torch.ops.kernels import relpos_attn as ra

    B, L, H = K10_SHAPE
    gen = torch.Generator().manual_seed(10)
    q, k, v, dout = (torch.randn(B, L, H, ra.HEAD_DIM, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
    g = (1 + 2 * torch.rand(B, H, L, generator=gen)).to(dev)  # the gate's range, (1, 3)
    r = torch.randn(H, 2 * L - 1, generator=gen).to(dev)
    fwd = lambda: ra.relpos_attention_cuda(q, k, v, g, r)
    out, lse = fwd()
    bwd = lambda: ra.relpos_attention_bwd_cuda(q, k, v, g, r, out, lse, dout)
    got = (out, lse) + tuple(bwd())
    again = fwd() + tuple(bwd())
    want = ra.relpos_attention_fwd_plain(q, k, v, g, r) + tuple(ra.relpos_attention_bwd_plain(q, k, v, g, r, out,
                                                                                                lse, dout))
    torch.cuda.synchronize()
    names = tuple(K10_GATE)
    rel = {n: _rel(a.float(), w.float()) for n, a, w in zip(names, got, want)}
    err = {n: float((a.float() - w.float()).abs().max()) for n, a, w in zip(names, got, want)}
    equal = {n: bool(torch.equal(a, c)) for n, a, c in zip(names, got, again)}
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
    del again, want
    plan = ra.relpos_plan(B, L, H)
    usage = {n: ptxas_usage(logs.get("relpos_attn", ""), n) for n in ("k10_relpos_fwd", "k10_relpos_bwd_pre",
                                                                        "k10_relpos_bwd_dkdv", "k10_relpos_bwd_dq",
                                                                        "k10_relpos_bwd_dr")}
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, dout))
    bias = ra.bias_plain(g, r).to(torch.bfloat16)
    sdpa = lambda: tf.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
    leaves = [t.detach().requires_grad_() for t in (qh, kh, vh, bias)]

    def sdpa_fwd_bwd():
        with torch.enable_grad():  # phase kernels runs under no_grad
            o = tf.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
            return torch.autograd.grad(o, leaves, doh)

    entries = {}
    for key, fn, back in (("relpos_fwd", fwd, False), ("relpos_bwd", bwd, True)):
        gated = names[2:] if back else names[:2]
        flops, nbytes = ra.relpos_work(B, L, H, ra.HEAD_DIM, back)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        launched = _device_launches(fn, "k10_relpos_")
        if back:
            plain = lambda: ra.relpos_attention_bwd_plain(q, k, v, g, r, out, lse, dout)
            library, library_ms = ("scaled_dot_product_attention forward + backward, the gated bias as a bf16 float "
                                   "mask with its gradient"), cuda_ms(sdpa_fwd_bwd, 20, 5)
        else:
            plain = lambda: ra.relpos_attention_fwd_plain(q, k, v, g, r)
            library, library_ms = "scaled_dot_product_attention, the gated bias as a bf16 float mask", \
                cuda_ms(sdpa, 50, 10)
        checks = dict(finite=finite, within_gate=all(rel[n] <= K10_GATE[n] for n in gated),
                      bit_equal=all(equal[n] for n in gated),
                      planned_launches=launched["kernel"] == (4 if back else 1))
        entries[key] = dict(
            name="relpos_attention " + ("backward" if back else "forward"), route="cuda",
            source="msmd_tpu_torch/csrc/relpos_attn.cu", replaces="none: the JAX package has no WavLM",
            B=B, L=L, heads=H, rel_err={n: rel[n] for n in gated}, max_abs_err=max(err[n] for n in gated),
            tolerance="max|err|/max|plain| <= " + ", ".join(f"{n} {K10_GATE[n]}" for n in gated)
                      + "; two calls bit-equal",
            bit_equal_across_calls={n: equal[n] for n in gated}, device_kernels_per_call=launched, plan=plan,
            ptxas={n: u for n, u in usage.items() if (n == "k10_relpos_fwd") != back},
            ms=cuda_ms(fn, 50, 10), device_ms=_device_ms_per_call(fn), ms_l2_flushed=cuda_ms_flushed(fn, 20),
            plain_ms=cuda_ms(plain, 3, warmup=1), bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            library=library, library_device_ms=_device_ms_per_call(sdpa_fwd_bwd if back else sdpa, 10),
            flops=flops, bytes=nbytes, checks=checks, ok=all(checks.values()))
    del q, k, v, dout, g, r, out, lse, got, bias, leaves
    return entries


# ---------------------------------------------------------------------------
# phases 4 and 5: the main paths, audio -> guided DDPM -> FLAME vertices
# ---------------------------------------------------------------------------

def _counted():
    from msmd_tpu_torch.ops.kernels import attn as k8
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import decoder_resident as kdr
    from msmd_tpu_torch.ops.kernels import ffn as k6
    from msmd_tpu_torch.ops.kernels import ffn_train as k7
    from msmd_tpu_torch.ops.kernels import layer_tail as k9
    from msmd_tpu_torch.ops.kernels import lbs as kl
    from msmd_tpu_torch.ops.kernels import relpos_attn as k10
    from msmd_tpu_torch.ops.kernels import sampler as ks

    return {"decoder": kd.fused_decoder_forward, "decoder_flat": kd.fused_decoder_forward_flat,
            "resident": kdr.fused_decoder_forward_resident, "scan": ks.fused_sampler_scan,
            "step": ks.fused_sampler_step, "lbs": kl.flame_vertices, "lbs_bwd": kl.skin_backward,
            "ffn_train_fwd": k7.ffn_train_forward,
            "ffn_train_bwd": k7.ffn_train_backward, "ffn": k6.fused_ffn_ln, "attn": k8.attention_middle,
            "attn_f32": k8.attention_middle_f32, "tail": k9.fused_layer_tail,
            "relpos_fwd": k10.relpos_attention_cuda, "relpos_bwd": k10.relpos_attention_bwd_cuda}


def _reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def _counts():
    return {k: fn.launches for k, fn in _counted().items()}


def _run_path(model, style, fused, reps, dynamic_threshold, gen, dev):
    """A warm-up window, then the 8 s clip with counts from 0. Returns
    (coeffs, verts, wall seconds, launch counts, windows)."""
    import torch

    from msmd_tpu_torch.measure import SEED, generate, seeded_audio

    cfg = model.cfg
    generate(model, style, fused, seeded_audio(cfg.n_motions / cfg.fps, SEED + 6), reps, gen, dev,
             dynamic_threshold=dynamic_threshold)
    torch.cuda.synchronize()
    audio = seeded_audio(AUDIO_SECONDS, SEED + 7)
    _reset_counts()
    t0 = time.perf_counter()
    coeffs, verts = generate(model, style, fused, audio, reps, gen, dev, dynamic_threshold=dynamic_threshold)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return coeffs, verts, wall, _counts(), math.ceil(int(AUDIO_SECONDS * cfg.fps) / cfg.n_motions)


def _finite(*ts) -> bool:
    import torch

    return all(bool(torch.isfinite(t).all()) for t in ts)


LIBRARY_GATE = 1e-5  # max |err| / max |reference| of the f32 library checks
LIBRARY_BATCH = 16
LANDMARK_FRAMES = 100
TEX_SIZE = 256


def _library_encoders(dev):
    """Checks 1-3 of ``phase_library``: the flagship-width VAE and VAE2 on
    the card against the same modules on the CPU; VAE2 with
    ``attn_kernel`` at f32 (K8's f32 mode, at B = 1 and 16) and at bf16
    (K8's bf16 mode) against the plain route on the card."""
    import copy

    import torch

    from msmd_tpu_torch.config import MSMDConfig
    from msmd_tpu_torch.measure import SEED
    from msmd_tpu_torch.models.layers import init_params
    from msmd_tpu_torch.models.style_encoder import get_style_encoder

    cfg = MSMDConfig()
    rs = np.random.RandomState(SEED + 60)
    clip = torch.as_tensor(rs.randn(LIBRARY_BATCH, STYLE_CLIP, cfg.motion_feat_dim).astype(np.float32))
    out, counts, cards = {}, {}, {}
    with torch.no_grad():
        for style in ("vae", "vae2"):
            cpu = init_params(get_style_encoder(cfg, style, input_dim=cfg.motion_feat_dim), SEED + 61).eval()
            card = cards[style] = copy.deepcopy(cpu).to(dev)
            eps = torch.as_tensor(rs.randn(LIBRARY_BATCH, cpu.z_dim).astype(np.float32))
            want = cpu(clip, eps=eps)
            _reset_counts()
            got = card(clip.to(dev), eps=eps.to(dev))
            torch.cuda.synchronize()
            counts[f"{style}_cpu_vs_card"] = _counts()
            out[f"{style}_cpu_vs_card_rel_err"] = max(_rel(g.cpu(), w) for g, w in zip(got, want))
            out[f"{style}_z_width"] = got[0].shape[1]
        vae2 = cards["vae2"]
        for B in sorted(K8_F32_BATCHES.values()):
            x = clip[:B].to(dev)
            want = vae2.encode_mean(x)
            _reset_counts()
            got = vae2.encode_mean(x, attn_kernel=True)
            torch.cuda.synchronize()
            counts[f"f32_attn_kernel_b{B}"] = _counts()
            out[f"f32_attn_kernel_b{B}_rel_err"] = _rel(got, want)
        bf16 = init_params(get_style_encoder(cfg, "vae2", torch.bfloat16, input_dim=cfg.motion_feat_dim),
                           SEED + 61).to(dev).eval()
        x = clip.to(dev)
        want = bf16.encode_mean(x).float()
        _reset_counts()
        got = bf16.encode_mean(x, attn_kernel=True).float()
        torch.cuda.synchronize()
        counts["bf16_attn_kernel"] = _counts()
        out["bf16_attn_kernel_rel_err"] = _rel(got, want)
        out["finite"] = _finite(got)
    only = lambda c, key: c[key] == 1 and all(v == 0 for k, v in c.items() if k != key)
    checks = {
        **{f"{s}_card_vs_cpu": out[f"{s}_cpu_vs_card_rel_err"] <= LIBRARY_GATE for s in ("vae", "vae2")},
        "vae_z_is_2_d_style": out["vae_z_width"] == 2 * cfg.d_style,
        "vae2_z_is_d_style": out["vae2_z_width"] == cfg.d_style,
        "encoders_launch_no_kernel": all(not any(counts[f"{s}_cpu_vs_card"].values()) for s in ("vae", "vae2")),
        **{f"f32_attn_kernel_b{B}": out[f"f32_attn_kernel_b{B}_rel_err"] <= LIBRARY_GATE
           and only(counts[f"f32_attn_kernel_b{B}"], "attn_f32") for B in K8_F32_BATCHES.values()},
        "bf16_attn_kernel": out["bf16_attn_kernel_rel_err"] <= GATE and only(counts["bf16_attn_kernel"], "attn")
        and out["finite"],
    }
    return out, counts, checks


def _library_flame(dev):
    """Checks 4-5 of ``phase_library``: ``flame_forward``'s landmarks on
    ``synthetic_flame(5023)`` at B = 100 (head yaws across -60..60 degrees)
    and ``flame_tex_forward`` at 256 on a basis drawn from a
    ``torch.Generator``, each on the card against the CPU."""
    import torch

    from msmd_tpu_torch.measure import SEED
    from msmd_tpu_torch.models import flame as fl

    out = {}
    rs = np.random.RandomState(SEED + 62)
    B = LANDMARK_FRAMES
    coefs = [rs.randn(B, n).astype(np.float32) * s for n, s in ((100, 0.3), (50, 0.3), (6, 0.2))]
    coefs[2][:, 1] = np.deg2rad(np.linspace(-60, 60, B)).astype(np.float32)
    res = {}
    with torch.no_grad():
        for d in ("cpu", dev):
            model = fl.synthetic_flame(n_verts=fl.FLAME_N_VERTS, seed=SEED, device=d)
            args = [torch.as_tensor(c, device=d) for c in coefs]
            _reset_counts()
            verts, lm2d, lm3d = fl.flame_forward(model, *args, return_lm2d=True, return_lm3d=True)
            idx, _ = fl._find_dynamic_lmk_idx_and_bcoords(model, fl.full_pose(args[2]))
            res[str(d)] = [t.cpu() for t in (verts, lm2d, lm3d, idx)] + [_counts()]
        (cv, c2, c3, ci, _), (gv, g2, g3, gi, launches) = res["cpu"], res[str(dev)]
        out.update(landmark_frames=B, lm2d_shape=list(g2.shape), lm3d_shape=list(g3.shape),
                   contour_rows_distinct=len({tuple(r) for r in gi.tolist()}),
                   contour_indices_equal=bool(torch.equal(gi, ci)),
                   lm2d_max_abs_err=float((g2 - c2).abs().max()), lm3d_max_abs_err=float((g3 - c3).abs().max()),
                   verts_max_abs_err=float((gv - cv).abs().max()))
        gen = torch.Generator().manual_seed(SEED + 63)
        n = 512 * 512 * 3
        mean = torch.rand((1, n), generator=gen) * 255.0
        basis = torch.randn((n, 50), generator=gen)
        code = torch.randn((2, 50), generator=gen) * 0.5
        want = fl.flame_tex_forward(mean, basis, code, size=TEX_SIZE)
        got = fl.flame_tex_forward(mean.to(dev), basis.to(dev), code.to(dev), size=TEX_SIZE).cpu()
        out.update(tex_shape=list(got.shape), tex_max_abs_err=float((got - want).abs().max()),
                   tex_max=float(want.abs().max()))
        del basis
    checks = {
        "landmark_shapes": out["lm2d_shape"] == [B, 68, 3] and out["lm3d_shape"] == [B, 68, 3],
        "contour_indices_equal": out["contour_indices_equal"],
        "landmarks": max(out["lm2d_max_abs_err"], out["lm3d_max_abs_err"]) <= LIBRARY_GATE,
        "flame_forward_launches_no_kernel": not any(launches.values()),
        "texture_shape": out["tex_shape"] == [2, 3, TEX_SIZE, TEX_SIZE],
        "texture": out["tex_max_abs_err"] <= LIBRARY_GATE * out["tex_max"] and _finite(got),
    }
    return out, checks


def phase_library(dev, smi):
    """Phase ``library``: the model library's modules outside the main
    paths (the VAE encoder, K8 inside the encoders, the FLAME landmarks and
    texture) on the card. Returns the launch counts of K8's f32 mode at
    each batch."""
    t0 = time.perf_counter()
    enc, counts, enc_checks = _library_encoders(dev)
    flame, flame_checks = _library_flame(dev)
    checks = {**enc_checks, **flame_checks}
    emit({"phase": "library", "encoders": enc, "flame": flame, "launches": counts, "checks": checks,
          "seconds": time.perf_counter() - t0, "card": smi})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: library checks failed: { {k: v for k, v in checks.items() if not v} }")
    return {B: counts[f"f32_attn_kernel_b{B}"]["attn_f32"] for B in K8_F32_BATCHES.values()}


def phase_main(dev, smi, built):
    import torch

    from msmd_tpu_torch.measure import BATCH, SEED

    model, style, fused = built
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    coeffs, verts, wall, launches, n_windows = _run_path(model, style, fused, BATCH, (0, 1, 4), gen, dev)
    frames = int(AUDIO_SECONDS * cfg.fps)
    checks = {
        "coeffs_shape": list(coeffs.shape) == [BATCH, frames, cfg.motion_feat_dim],
        "verts_shape": list(verts.shape) == [BATCH * frames, fused.n_verts, 3],
        "finite": _finite(coeffs, verts),
        "decoder_launches": launches["decoder"] == n_windows * cfg.n_diff_steps,
        "lbs_launches": launches["lbs"] == n_windows,
    }
    per_window = wall / n_windows
    emit({"phase": "main_path", "batch": BATCH, "windows": n_windows, "diff_steps": cfg.n_diff_steps,
          "coeffs_shape": list(coeffs.shape), "verts_shape": list(verts.shape),
          "wall_s": wall, "wall_s_per_window": per_window,
          "real_time_factor": (cfg.n_motions / cfg.fps) * BATCH / per_window,
          "launches": launches, "checks": checks, "card": smi,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: main path checks failed: {checks}")
    return launches


def phase_batch1(dev, smi, built):
    import torch

    from msmd_tpu_torch.measure import CFG_SCALE, SEED, seeded_audio
    from msmd_tpu_torch.models.diffusion import sample

    model, style, fused = built
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    coeffs, verts, wall, launches, n_windows = _run_path(model, style, fused, 1, None, gen, dev)
    frames = int(AUDIO_SECONDS * cfg.fps)
    per_window = wall / n_windows

    # one window with the trajectory (K4 per step), and the same window
    # through K3 from the same noise
    with torch.no_grad():
        feat = model.extract_audio_feature(
            torch.as_tensor(seeded_audio(cfg.n_motions / cfg.fps, SEED + 9), device=dev)[None])
        shape = torch.zeros(1, 100, device=dev)
        m_T = torch.randn(1, cfg.n_motions, cfg.motion_feat_dim, generator=gen, device=dev)
        noise = torch.randn(cfg.n_diff_steps, 1, cfg.n_motions, cfg.motion_feat_dim, generator=gen, device=dev)
        kw = dict(motion_at_T=m_T, noise_override=noise, cfg_scale=CFG_SCALE, device=dev)
        _reset_counts()
        t0 = time.perf_counter()
        traj, _, _ = sample(model, feat, shape, style, ret_traj=True, **kw)
        torch.cuda.synchronize()
        traj_wall = time.perf_counter() - t0
        traj_launches = _counts()
        m0, _, _ = sample(model, feat, shape, style, **kw)
    checks = {
        "coeffs_shape": list(coeffs.shape) == [1, frames, cfg.motion_feat_dim],
        "verts_shape": list(verts.shape) == [frames, fused.n_verts, 3],
        "finite": _finite(coeffs, verts, traj),
        "scan_launches": launches["scan"] == n_windows,
        "decoder_launches": launches["decoder"] == 0,
        "lbs_launches": launches["lbs"] == n_windows,
        "traj_shape": list(traj.shape) == [cfg.n_diff_steps + 1, 1, cfg.n_motions, cfg.motion_feat_dim],
        "traj_step_launches": traj_launches["step"] == cfg.n_diff_steps,
        "traj_no_other_sampler": traj_launches["scan"] == 0 and traj_launches["decoder"] == 0,
    }
    emit({"phase": "batch1", "batch": 1, "windows": n_windows, "diff_steps": cfg.n_diff_steps,
          "coeffs_shape": list(coeffs.shape), "verts_shape": list(verts.shape),
          "wall_s": wall, "wall_s_per_window": per_window,
          "real_time_factor": (cfg.n_motions / cfg.fps) / per_window, "launches": launches,
          "traj_shape": list(traj.shape), "traj_wall_s": traj_wall, "traj_launches": traj_launches,
          "traj_x0_vs_scan_max_abs": float((traj[0] - m0).abs().max()),
          "traj_x0_vs_scan_rel": _rel(traj[0], m0),
          "checks": checks, "card": smi})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: batch-1 checks failed: {checks}")
    return launches, traj_launches


# ---------------------------------------------------------------------------
# phases 6 and 7: guided inpainting and the style-basis sampler
# ---------------------------------------------------------------------------

GUIDED_ROUTES = (("default", {}, {"ffn"}), ("attn_kernel", {"attn_kernel": True}, {"ffn", "attn"}),
                 ("fused_tail", {"fused_tail": True}, {"tail"}))


def phase_guided(dev, smi, built):
    import torch

    from msmd_tpu_torch.measure import BATCH, decode_vertices, guided_inputs, run_guided

    model, style, fused = built
    cfg = model.cfg
    inputs = guided_inputs(cfg, dev)
    per_window = cfg.n_layers * cfg.n_diff_steps
    with torch.no_grad():
        run_guided(model, style, inputs, dev)  # warm-up
        torch.cuda.synchronize()
        runs, x0 = {}, {}
        for name, route, launched in GUIDED_ROUTES:
            _reset_counts()
            t0 = time.perf_counter()
            out = run_guided(model, style, inputs, dev, **route)
            verts = decode_vertices(fused, out)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
            want = {k: (per_window if k in launched else 0) for k in ("decoder", "scan", "step", "ffn", "attn", "tail")}
            checks = {
                "shape": list(out.shape) == [BATCH, cfg.n_motions, cfg.motion_feat_dim],
                "verts_shape": list(verts.shape) == [BATCH * cfg.n_motions, fused.n_verts, 3],
                "finite": _finite(out, verts),
                "launches": all(launches[k] == v for k, v in want.items()) and launches["lbs"] == 1,
            }
            runs[name] = {"wall_s": wall, "real_time_factor": (cfg.n_motions / cfg.fps) * BATCH / wall,
                          "launches": launches, "checks": checks}
            x0[name] = out
            del verts
    diffs = {f"{a}_vs_{b}": float((x0[a] - x0[b]).abs().max())
             for a, b in (("default", "attn_kernel"), ("default", "fused_tail"), ("attn_kernel", "fused_tail"))}
    emit({"phase": "guided", "batch": BATCH, "windows": 1, "diff_steps": cfg.n_diff_steps,
          "keyframes": int(inputs["guidance_indice"].numel()), "runs": runs, "x0_max_abs_diff": diffs,
          "card": smi})
    bad = {k: v["checks"] for k, v in runs.items() if not all(v["checks"].values())}
    if bad:
        raise SystemExit(f"chip_smoke: guided checks failed: {bad}")
    return {name: r["launches"] for name, r in runs.items()}


def phase_separate(dev, smi, built):
    import torch

    from msmd_tpu_torch.measure import CFG_SCALE, SEED, seeded_audio
    from msmd_tpu_torch.models.diffusion import sample_separate

    model, style, _ = built
    cfg = model.cfg
    n, D = cfg.n_motions, cfg.motion_feat_dim
    audio = torch.as_tensor(seeded_audio(n / cfg.fps, SEED + 13), device=dev)[None]
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    _reset_counts()
    t0 = time.perf_counter()
    outs = sample_separate(model, audio, torch.zeros(1, 100, device=dev), style.reshape(1, -1),
                           cfg_scale=CFG_SCALE, generator=gen, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    shapes = [[1, n, D], [1, n, D], [1, n, cfg.feature_dim], [1, n, D], [1, n, D], [1, n, cfg.num_of_basis]]
    checks = {"shapes": [list(o.shape) for o in outs] == shapes, "finite": _finite(*(o.float() for o in outs)),
              "no_kernel": not any(launches.values())}
    emit({"phase": "separate", "batch": 1, "diff_steps": cfg.n_diff_steps, "wall_s": wall,
          "shapes": [list(o.shape) for o in outs], "launches": launches, "checks": checks, "card": smi})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: separate checks failed: {checks}")


# ---------------------------------------------------------------------------
# phase 8: multi-stream serving
# ---------------------------------------------------------------------------

SLOTS = 48
DEPTHS = (1, 4)


def _serve(model, style, streams, slots, dev, rounds=None, **kw):
    """A ``StreamingBatcher`` of ``slots`` slots fed ``streams`` [(sid,
    seed, audio)], run to the end (or ``rounds`` rounds, the audio then
    not marked final), with the counts set to 0 just before. Returns
    (outputs by sid, wall seconds, launch counts)."""
    import torch

    from msmd_tpu_torch.measure import CFG_SCALE
    from msmd_tpu_torch.serving import StreamingBatcher

    bat = StreamingBatcher(model, max_slots=slots, cfg_scale=CFG_SCALE, device=dev, **kw)
    style_np = style.reshape(-1).cpu().numpy()
    for sid, seed, audio in streams:
        bat.add_stream(sid, seed, style=style_np)
        bat.push_audio(sid, audio, final=rounds is None)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    if rounds is None:
        bat.run_until_drained()
    else:
        for _ in range(rounds):
            bat.step()
        bat.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = {sid: bat.output(sid) for sid, _, _ in streams}
    del bat
    torch.cuda.empty_cache()
    return outs, wall, _counts()


def phase_serving(dev, smi, built):
    import numpy as np
    import torch

    from msmd_tpu_torch.measure import SEED, build_main_path, generate, seeded_audio

    model, style, fused = built
    cfg = model.cfg
    T, n, D = cfg.n_diff_steps, cfg.n_motions, cfg.motion_feat_dim
    window_s = n / cfg.fps
    streams = lambda count, seconds, base: [(f"s{i}", base + i, seeded_audio(seconds, base + i))
                                            for i in range(count)]
    finite = lambda outs: all(np.isfinite(o).all() for o in outs.values())
    shaped = lambda outs, frames: all(o.shape == (frames, D) for o in outs.values())
    only = lambda counts, **want: all(counts[k] == want.get(k, 0) for k in counts)
    runs, checks = {}, {}

    mixed = streams(SLOTS, AUDIO_SECONDS, SEED + 60)
    _serve(model, style, [(sid, seed, a[:cfg.n_audio_samples]) for sid, seed, a in mixed], SLOTS, dev)  # warm-up
    k1_out, wall, counts = _serve(model, style, mixed, SLOTS, dev)
    frames = int(AUDIO_SECONDS * cfg.fps)
    runs["k1_48_slots"] = {"rounds": 2, "wall_s": wall, "launches": counts}
    checks["k1_48_slots"] = finite(k1_out) and shaped(k1_out, frames) and only(counts, decoder=2 * T)

    # the first round alone, through K1 and through K2
    k1_first, wall, counts = _serve(model, style, mixed, SLOTS, dev, rounds=1)
    runs["k1_48_slots_first_round"] = {"rounds": 1, "wall_s": wall, "launches": counts}
    checks["k1_48_slots_first_round"] = finite(k1_first) and shaped(k1_first, n) and only(counts, decoder=T)
    k2_out, wall, counts = _serve(model, style, mixed, SLOTS, dev, rounds=1, resident=True)
    k2_diff = max(float(np.abs(k2_out[sid] - k1_out[sid][:n]).max()) for sid, _, _ in mixed)
    runs["k2_48_slots_first_round"] = {"rounds": 1, "wall_s": wall, "launches": counts,
                                       "max_abs_diff_vs_k1_round": k2_diff}
    checks["k2_48_slots"] = finite(k2_out) and shaped(k2_out, n) and only(counts, resident=T)
    first_round = {route: SLOTS * window_s / runs[f"{route}_48_slots_first_round"]["wall_s"] for route in ("k1", "k2")}

    alone, wall, counts = _serve(model, style, mixed[:1], SLOTS, dev)
    sid0 = mixed[0][0]
    iso_diff = float(np.abs(alone[sid0] - k1_out[sid0]).max())
    runs["one_stream_in_48_slots"] = {"rounds": 2, "wall_s": wall, "launches": counts,
                                      "max_abs_diff_vs_mixed": iso_diff}
    checks["one_stream_in_48_slots"] = finite(alone) and shaped(alone, frames) and only(counts, decoder=2 * T)

    two, wall, counts = _serve(model, style, streams(2, window_s, SEED + 120), 2, dev)
    runs["flat_2_slots"] = {"rounds": 1, "wall_s": wall, "launches": counts}
    checks["flat_2_slots"] = finite(two) and shaped(two, n) and only(counts, decoder_flat=T)

    model0, _, _ = build_main_path(dev, cfg_kw={"align_mask_width": 0})
    gen = torch.Generator(device=dev).manual_seed(SEED + 130)
    audio0 = seeded_audio(window_s, SEED + 131)
    generate(model0, style, fused, audio0, 1, gen, dev, dynamic_threshold=None)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    coeffs0, verts0 = generate(model0, style, fused, audio0, 1, gen, dev, dynamic_threshold=None)
    torch.cuda.synchronize()
    wall, counts = time.perf_counter() - t0, _counts()
    del model0
    torch.cuda.empty_cache()
    runs["no_alignment_mask_batch1"] = {"windows": 1, "wall_s": wall, "launches": counts}
    checks["no_alignment_mask_batch1"] = (_finite(coeffs0, verts0) and list(coeffs0.shape) == [1, n, D]
                                          and only(counts, decoder_flat=T, lbs=1))

    long = streams(SLOTS, 4 * window_s, SEED + 200)
    rates = {}
    for depth in DEPTHS:
        outs, wall, counts = _serve(model, style, long, SLOTS, dev, pipeline_depth=depth)
        rates[depth] = SLOTS * 4 * window_s / wall
        runs[f"depth_{depth}"] = {"rounds": 4, "wall_s": wall, "audio_s_per_s": rates[depth], "launches": counts}
        checks[f"depth_{depth}"] = finite(outs) and shaped(outs, 4 * n) and only(counts, decoder=4 * T)
    emit({"phase": "serving", "slots": SLOTS, "diff_steps": T, "runs": runs,
          "audio_s_per_s": {f"depth_{d}": r for d, r in rates.items()},
          "first_round_audio_s_per_s": {"k1": first_round["k1"], "resident_k2": first_round["k2"]},
          "stream_isolation_max_abs_diff": iso_diff, "k2_vs_k1_max_abs_diff": k2_diff, "checks": checks,
          "card": smi})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: serving checks failed: {checks}")
    return {"decoder_flat": runs["flat_2_slots"]["launches"]["decoder_flat"],
            "resident": runs["k2_48_slots_first_round"]["launches"]["resident"]}


# ---------------------------------------------------------------------------
# phase 9: the two-clip training step
# ---------------------------------------------------------------------------

def _train_wall(path, batch, steps):
    import torch

    from msmd_tpu_torch.measure import run_train_steps

    run_train_steps(path, batch, 1)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = run_train_steps(path, batch, steps)
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0, _counts()


def phase_train(dev, smi):
    import torch

    from msmd_tpu_torch.measure import build_train_path, run_train_steps, train_batch
    from msmd_tpu_torch.profile import profile_device_ms
    from msmd_tpu_torch.train.loop import eval_step

    path = build_train_path(dev)
    cfg, model, style_enc = path["cfg"], path["model"], path["style_enc"]
    batch = train_batch(cfg, dev)
    params = [(n, p) for m in (model, style_enc) for n, p in m.named_parameters()]
    before = {n: p.detach().clone() for n, p in params}
    losses, wall, launches = _train_wall(path, batch, TRAIN_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in params}
    unreached = tuple(f"denoising_net.transformer.layers.{cfg.n_layers - 1}.cross_attn.{w}_proj." for w in "qk")
    trainable = [n for n, p in params if p.requires_grad and not n.startswith(unreached)]
    frozen = [n for n, p in params if not p.requires_grad]
    del before

    _reset_counts()
    eval_metrics = eval_step(cfg, model, style_enc, batch, path["generator"])
    torch.cuda.synchronize()
    eval_launches = _counts()

    busy_ms = sum(profile_device_ms(lambda: run_train_steps(path, batch, 1)).values())
    step_s = wall / TRAIN_STEPS
    cfg.fused_ffn_train = False  # the same model and batch without K7, for reference
    _, plain_wall, plain_launches = _train_wall(path, batch, TRAIN_STEPS)
    cfg.fused_ffn_train = True

    per_step = cfg.n_layers * 2
    checks = {
        "finite_losses": all(bool(torch.isfinite(l)) for l in losses) and _finite(*eval_metrics.values()),
        "trainable_moved": not [n for n in trainable if not moved[n]],
        "frozen_unchanged": not any(moved[n] for n in frozen) and len(frozen) > 0,
        "k7_fwd_launches": launches["ffn_train_fwd"] == per_step * TRAIN_STEPS,
        "k7_bwd_launches": launches["ffn_train_bwd"] == per_step * TRAIN_STEPS,
        "no_sampling_kernels": all(launches[k] == 0 for k in ("decoder", "scan", "step", "lbs")),
        "eval_runs_no_k7": eval_launches["ffn_train_fwd"] == 0 and eval_launches["ffn_train_bwd"] == 0,
        "unfused_runs_no_k7": plain_launches["ffn_train_fwd"] == 0 and plain_launches["ffn_train_bwd"] == 0,
    }
    B = batch["motion_0"].shape[0]
    audio_s = 2 * B * cfg.n_motions / cfg.fps
    emit({"phase": "train", "batch": B, "clips": 2, "clip_seconds": cfg.n_motions / cfg.fps,
          "steps": TRAIN_STEPS, "losses": [float(l) for l in losses], "wall_s": wall,
          "steps_per_s": 1.0 / step_s, "audio_s_per_s": audio_s / step_s, "peak_mem_gb": peak_gb,
          "device_busy_ms_per_step": busy_ms, "device_busy_share": busy_ms / (step_s * 1e3),
          "launches": launches, "eval_launches": eval_launches,
          "trainable_params": len(trainable), "frozen_params": len(frozen),
          "trainable_not_moved": [n for n in trainable if not moved[n]][:20],
          "unfused_steps_per_s": TRAIN_STEPS / plain_wall, "checks": checks, "card": smi})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: train checks failed: {checks}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the vertex-space training step
# ---------------------------------------------------------------------------

VERTEX_GRAD_GATE = 1e-4  # max |err| / max |plain| of d loss / d target, K5 + K5 bwd against flame_forward
REMAT_STEPS = 2
# remat against no remat from one saved state: the first step's gradients within REMAT_GRAD_GATE of max |g|
# (a recompute that drew fresh dropout masks or a fresh K7 seed moves them by ~10%); its loss bit-equal (no
# backward has run); the second step's loss within REMAT_LOSS_RTOL (the backward's atomics, index_put in the
# step embedding, reach it through one Adam update)
REMAT_GRAD_GATE = 1e-5
REMAT_LOSS_RTOL = 1e-4


def _vertex_steps(path, batch, steps):
    """``steps`` train steps; returns (loss, vert) of each, device scalars."""
    from msmd_tpu_torch.train.loop import train_step

    out = []
    for _ in range(steps):
        m = train_step(path["cfg"], path["model"], path["style_enc"], path["opt"], batch, path["generator"],
                       path["host_generator"], path["flame"], path["coef_stats"])
        out.append((m["loss"], m["vert"]))
    return out


def _timed_vertex_steps(path, batch, steps):
    import torch

    _vertex_steps(path, batch, 1)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = _vertex_steps(path, batch, steps)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _counts(), torch.cuda.max_memory_allocated() / 1e9


def _vertex_grad_check(path, batch):
    """One clip-1 window of the step's inputs through the model (no grad),
    then the gradient of the vertex terms of the loss (vert, vel, smooth,
    weighted) with respect to the denoiser's output through K5 + K5 bwd
    (the ``FusedFlame``) and through plain ``flame_forward`` (its
    ``FlameModel``): max |err| / max |plain|, and each route's vert term."""
    import torch

    from msmd_tpu_torch.losses import compute_loss, load_loss_weights

    cfg, model, fused = path["cfg"], path["model"], path["flame"]
    n_prev = cfg.n_prev_motions
    gen = torch.Generator(device=batch["motion_0"].device).manual_seed(77)
    with torch.no_grad():
        style = path["style_enc"](batch["motion_1"], gen, False)[0]
        prev_m = batch["motion_0"][:, -n_prev:]
        prev_a = model.extract_audio_feature(batch["audio_0"])[:, -n_prev:]
        shape = batch["shape_0"][:, 0]
        eps, target, _, _ = model(batch["motion_1"], batch["audio_1"], shape, style, prev_motion_feat=prev_m,
                                  prev_audio_feat=prev_a, generator=gen, train=False)
    # the terms on the vertices only: the others (noise, head pose) do not pass through K5
    weights = {k: w for k, w in load_loss_weights(cfg).items() if k in ("vert", "vel", "smooth") and w > 0}
    grads, terms = [], []
    for flame in (fused, fused.model):
        t = target.float().detach().requires_grad_(True)
        out = compute_loss(cfg, False, shape, batch["motion_1"], eps, t, prev_m, path["coef_stats"], flame)
        grads.append(torch.autograd.grad(sum(out[k] * w for k, w in weights.items()), t)[0])
        terms.append(float(out["vert"].detach()))
    return _rel(grads[0], grads[1]), terms


def _first_step_grads(path, batch, state, remat):
    """From ``state``, the first step's loss and gradients (no update):
    (loss, {name: grad}) over the trainable parameters."""
    from msmd_tpu_torch.train.loop import two_clip_loss

    _restore(path, state)
    path["opt"].adam.zero_grad(set_to_none=True)
    path["cfg"].remat_denoiser = remat
    total, _ = two_clip_loss(path["cfg"], path["model"], path["style_enc"], batch, path["generator"],
                             path["host_generator"], train=True, flame=path["flame"], coef_stats=path["coef_stats"])
    total.backward()
    grads = {n: p.grad.detach().clone() for m in (path["model"], path["style_enc"]) for n, p in m.named_parameters()
             if p.grad is not None}
    path["opt"].adam.zero_grad(set_to_none=True)
    path["cfg"].remat_denoiser = False
    return float(total), grads


def _grad_gap(a, b):
    """max |a - b| over every gradient, over max |b|; inf where the two
    sets of gradients differ in their parameters."""
    if a.keys() != b.keys():
        return math.inf
    top = max(float(g.abs().max()) for g in b.values())
    return max(float((a[n] - b[n]).abs().max()) for n in b) / top


def _train_state(path):
    import copy

    return (copy.deepcopy(path["model"].state_dict()), copy.deepcopy(path["style_enc"].state_dict()),
            copy.deepcopy(path["opt"].state_dict()), path["generator"].get_state(),
            path["host_generator"].get_state())


def _restore(path, state):
    """``state`` back into the path; the optimizer's tensors copied, since
    Adam's ``load_state_dict`` keeps (and later updates) the tensors it is
    given where their device and type already fit."""
    import copy

    model_sd, style_sd, opt_sd, gen, host = state
    path["model"].load_state_dict(model_sd)
    path["style_enc"].load_state_dict(style_sd)
    path["opt"].load_state_dict(copy.deepcopy(opt_sd))
    path["generator"].set_state(gen)
    path["host_generator"].set_state(host)


def phase_train_vertex(dev, smi):
    import torch

    from msmd_tpu_torch.measure import build_train_path, train_batch
    from msmd_tpu_torch.profile import profile_device_ms

    path = build_train_path(dev, vertex=True)
    cfg, model, style_enc = path["cfg"], path["model"], path["style_enc"]
    batch = train_batch(cfg, dev)
    params = [(n, p) for m in (model, style_enc) for n, p in m.named_parameters()]
    before = {n: p.detach().clone() for n, p in params}
    out, wall, launches, peak_gb = _timed_vertex_steps(path, batch, TRAIN_STEPS)
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in params}
    unreached = tuple(f"denoising_net.transformer.layers.{cfg.n_layers - 1}.cross_attn.{w}_proj." for w in "qk")
    trainable = [n for n, p in params if p.requires_grad and not n.startswith(unreached)]
    frozen = [n for n, p in params if not p.requires_grad]
    del before
    busy_ms = sum(profile_device_ms(lambda: _vertex_steps(path, batch, 1)).values())
    step_s = wall / TRAIN_STEPS
    grad_rel, vert_terms = _vertex_grad_check(path, batch)

    cfg.two_clip_batch = False  # the sequential loop on the same model and batch
    seq_out, seq_wall, seq_launches, seq_peak = _timed_vertex_steps(path, batch, TRAIN_STEPS)
    cfg.two_clip_batch = True

    state = _train_state(path)
    ref_loss, ref_grads = _first_step_grads(path, batch, state, False)
    rep_loss, rep_grads = _first_step_grads(path, batch, state, False)
    rep_gap = _grad_gap(rep_grads, ref_grads)  # the backward's own run-to-run spread
    del rep_grads
    remat_loss, remat_grads = _first_step_grads(path, batch, state, True)
    remat_gap = _grad_gap(remat_grads, ref_grads)
    del ref_grads, remat_grads
    remat = {}
    for flag in (False, True):
        _restore(path, state)
        cfg.remat_denoiser = flag
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        r = _vertex_steps(path, batch, REMAT_STEPS)
        torch.cuda.synchronize()
        remat[flag] = dict(losses=[float(l) for l, _ in r], peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                           launches=_counts())
    cfg.remat_denoiser = False
    del state

    L, T = cfg.n_layers, TRAIN_STEPS
    losses = [float(l) for l, _ in out]
    checks = {
        "finite_losses": all(math.isfinite(l) for l in losses + [float(l) for l, _ in seq_out]),
        "vert_positive": all(float(v) > 0 for _, v in out + seq_out) and min(vert_terms) > 0,
        "trainable_moved": not [n for n in trainable if not moved[n]],
        "frozen_unchanged": not any(moved[n] for n in frozen) and len(frozen) > 0,
        # two_clip_batch: the decoder once on 2B rows; each clip decodes gt and pred, pred's backward
        "lbs_launches": launches["lbs"] == 4 * T and seq_launches["lbs"] == 4 * T,
        "lbs_bwd_launches": launches["lbs_bwd"] == 2 * T and seq_launches["lbs_bwd"] == 2 * T,
        "k7_launches": launches["ffn_train_fwd"] == L * T and launches["ffn_train_bwd"] == L * T
        and seq_launches["ffn_train_fwd"] == 2 * L * T and seq_launches["ffn_train_bwd"] == 2 * L * T,
        "grad_through_k5_matches_flame_forward": grad_rel <= VERTEX_GRAD_GATE,
        "remat_same_gradients": remat_gap <= REMAT_GRAD_GATE,
        "remat_same_losses": remat_loss == ref_loss and remat[True]["losses"][0] == remat[False]["losses"][0]
        and all(abs(a - b) <= REMAT_LOSS_RTOL * abs(b) for a, b in zip(remat[True]["losses"], remat[False]["losses"])),
        "remat_lowers_peak_mem": remat[True]["peak_mem_gb"] < remat[False]["peak_mem_gb"],
        # under remat K7's forward runs again in each layer's recompute
        "remat_k7_launches": remat[True]["launches"]["ffn_train_fwd"] == 2 * L * REMAT_STEPS
        and remat[True]["launches"]["ffn_train_bwd"] == L * REMAT_STEPS
        and remat[False]["launches"]["ffn_train_fwd"] == L * REMAT_STEPS,
        "no_sampling_kernels": all(launches[k] == 0 for k in ("decoder", "scan", "step")),
    }
    B = batch["motion_0"].shape[0]
    emit({"phase": "train_vertex", "batch": B, "clips": 2, "clip_seconds": cfg.n_motions / cfg.fps,
          "dataset_type": cfg.dataset_type, "two_clip_batch": True, "flame_verts": path["flame"].n_verts,
          "steps": T, "losses": losses, "vert": [float(v) for _, v in out], "wall_s": wall,
          "steps_per_s": 1.0 / step_s, "peak_mem_gb": peak_gb,
          "device_busy_ms_per_step": busy_ms, "device_busy_share": busy_ms / (step_s * 1e3),
          "sequential_steps_per_s": T / seq_wall, "sequential_peak_mem_gb": seq_peak,
          "sequential_losses": [float(l) for l, _ in seq_out],
          "launches": launches, "sequential_launches": seq_launches,
          "grad_rel_err_k5_vs_flame_forward": grad_rel, "vert_k5_vs_flame_forward": vert_terms,
          "remat": {str(k).lower(): v for k, v in remat.items()},
          "remat_first_step": {"loss": remat_loss, "no_remat_loss": ref_loss, "grad_gap": remat_gap,
                               "no_remat_repeat_grad_gap": rep_gap, "no_remat_repeat_loss": rep_loss},
          "remat_tolerance": f"first step: gradients max |remat - no remat| <= {REMAT_GRAD_GATE} max |no remat|, "
                             f"loss bit-equal; second step: loss |remat - no remat| <= {REMAT_LOSS_RTOL} |no remat|",
          "trainable_params": len(trainable), "frozen_params": len(frozen),
          "trainable_not_moved": [n for n in trainable if not moved[n]][:20], "checks": checks, "card": smi})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: train_vertex checks failed: {checks}")
    return launches


# ---------------------------------------------------------------------------
# phase 11: pretrained audio weights, data and tensor parallelism, sharded
# sampling and profiler traces
# ---------------------------------------------------------------------------

PAR_STEPS = 3  # steps a turn at NCCL world size 1 (two turns a trainer, after a warm-up)
PAR_TRAIN_STEPS = 2  # train-mode steps a rank at dp = 2 and at tp = 2
PAR_DET_BATCH = 4  # the deterministic f32 step's global batch
PAR_REPS = 4  # sharded sampling's repetitions over the two ranks
PAR_TIMEOUT = 600  # seconds a spawn of ranks may take
# the CPU tests' bounds (tests/test_torch_parallel.py): loss rtol, gradient max |err| <= 1e-4 max |g| + 1e-6,
# the updated parameters rtol 3e-3, atol 2e-5 where |g| >= 1e-4 of the largest gradient
PAR_LOSS_RTOL, PAR_GRAD_REL, PAR_GRAD_ATOL = 1e-5, 1e-4, 1e-6
PAR_PARAM_RTOL, PAR_PARAM_ATOL, PAR_PARAM_FLOOR = 3e-3, 2e-5, 1e-4
PAR_SAMPLE_GATE = 1e-5  # max |err| / max |ref| of a rank's rows against the same route unsharded
TRAIN_KERNELS = {"lbs": "lbs_kernel", "lbs_bwd": "lbs_bwd_kernel", "ffn_train": "gemm_train_kernel"}


def _card_setup():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _kernel_events(call, names: dict, agree=lambda whole: whole) -> dict:
    """How often the card ran each kernel of ``names`` ({key: substring of
    its device name}) in one ``call``, from torch.profiler (``agree`` as
    in ``measure.profiled``)."""
    from msmd_tpu_torch.measure import kernel_events, profiled

    events = [e.name for e in kernel_events(profiled(call, agree=agree))]
    return {k: sum(sub in n for n in events) for k, sub in names.items()}


def _all_ranks(whole: bool) -> bool:
    """True when the profiler session of every rank of the default group
    was whole (``measure.profiled``'s ``agree``; a CPU flag, for gloo)."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(whole)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _whole(trainer, grads: bool = False) -> dict:
    """{name: whole tensor} of the trainer's parameters (or gradients) on
    the card; every rank of its groups takes part."""
    from msmd_tpu_torch.parallel import tp as tpar

    out = {}
    for part, module in (("model", trainer.model), ("style", trainer.style_enc)):
        shards = {id(p): (d, sh) for p, d, sh in tpar.param_shards(module)}
        for name, p in module.named_parameters():
            t = p.grad if grads else p.detach()
            if t is not None:
                out[f"{part}.{name}"] = (tpar.whole(t, *shards[id(p)]) if id(p) in shards else t).clone()
    return out


def _deterministic(dev, exp_dir, layout, tp, truncated=False):
    """The eval-mode two-clip loss at f32 (no dropout or truncation; the
    timesteps, noise, CFG drops and style sample are the global batch's,
    drawn from one seeded generator) on this rank's rows, its backward and
    one Adam update (the gradients reduced as the trainer reduces them).
    With ``truncated`` the train-mode step with the modules' dropout and
    SpecAugment off, no cross-style swap, and both clips cut at the global
    batch's ends from the trainer's host generator (the ranks' frame
    counts differ). Returns (global loss, whole gradients, whole updated
    parameters)."""
    import torch

    from msmd_tpu_torch.measure import SEED, build_trainer, train_batch
    from msmd_tpu_torch.models.layers import SampleRows
    from msmd_tpu_torch.parallel.mesh import shard_batch
    from msmd_tpu_torch.train.loop import two_clip_loss

    class EvalModel(torch.nn.Module):  # MSMD with dropout and SpecAugment off in a train-mode step
        def __init__(self, m):
            super().__init__()
            self.m, self.cfg = m, m.cfg
            self.start_motion_feat, self.start_audio_feat = m.start_motion_feat, m.start_audio_feat

        def forward(self, *a, **kw):
            return self.m(*a, **dict(kw, train=False))

        def extract_audio_feature(self, audio, frame_num=None, rng=None):
            return self.m.extract_audio_feature(audio, frame_num)

    class EvalStyle(torch.nn.Module):  # the style encoder without dropout; z from the global draw
        def __init__(self, e):
            super().__init__()
            self.e, self.d_style = e, e.d_style

        def forward(self, x, generator=None, train=False, eps=None):
            return self.e(x, generator, False, eps=eps)

    cut = dict(trunc_prob1=1.0, trunc_prob2=1.0, prob_cross_style=0.0) if truncated else {}
    t = build_trainer(dev, exp_dir, layout, batch_size=PAR_DET_BATCH, compute_dtype="float32", tp_size=tp, **cut)
    batch = train_batch(t.cfg, dev, batch_size=PAR_DET_BATCH, seed=SEED + 40)
    rows = SampleRows(torch.Generator(device=dev).manual_seed(11), layout.rows(PAR_DET_BATCH), PAR_DET_BATCH)
    model, style = (EvalModel(t.model), EvalStyle(t.style_enc)) if truncated else (t.model, t.style_enc)
    total, _ = two_clip_loss(t.cfg, model, style, shard_batch(batch, layout), t.dropout_generator,
                             t.host_generator, train=truncated, flame=t.flame, coef_stats=t.coef_stats, rows=rows)
    total.backward()
    reduce, t.opt.reduce_grads = t.opt.reduce_grads, None
    if reduce is not None:  # the trainer's reduction, here before the gradients are read
        reduce(t.opt.params)
    grads = _whole(t, grads=True)
    t.opt.step()
    out = float(layout.average(total.detach())), grads, _whole(t)
    t.close()
    return out


def _compare_steps(ref, got) -> dict:
    """The deterministic step against the one-process one, at the CPU
    tests' bounds."""
    (rl, rg, rp), (gl, gg, gp) = ref, got
    if set(gg) != set(rg) or set(gp) != set(rp):
        return dict(loss=gl, one_process_loss=rl, same_parameters=False, ok=False)
    grad_gap = max(float((gg[k] - g).abs().max() - PAR_GRAD_REL * g.abs().max()) for k, g in rg.items())
    top = max(float(g.abs().max()) for g in rg.values())
    param_gap, checked = 0.0, 0
    for k, want in rp.items():
        g = rg.get(k)
        sure = (g.abs() >= PAR_PARAM_FLOOR * top) if g is not None else None
        a, b = (gp[k], want) if sure is None else (gp[k][sure], want[sure])
        param_gap = max(param_gap, float(((a - b).abs() - PAR_PARAM_ATOL - PAR_PARAM_RTOL * b.abs()).max())
                        if b.numel() else 0.0)
        checked += int(b.numel())
    return dict(loss=gl, one_process_loss=rl, loss_rel=abs(gl - rl) / abs(rl),
                grad_excess=grad_gap, param_excess=param_gap, params_checked=checked, same_parameters=True,
                ok=abs(gl - rl) <= PAR_LOSS_RTOL * abs(rl) and grad_gap <= PAR_GRAD_ATOL and param_gap <= 0)


def _replicas_equal(trainer, layout) -> bool:
    """Every rank holds the same whole parameters (checksums of rank 0's
    broadcast and compared, bit for bit)."""
    import torch
    import torch.distributed as dist

    sums = torch.stack([torch.stack([v.double().sum(), v.double().abs().sum(), v.double().pow(2).sum()])
                        for v in _whole(trainer).values()])
    mine = sums.clone()
    dist.broadcast(sums, src=0)
    return bool(torch.equal(sums, mine))


def _nccl_world1(tmp):
    """One rank under NCCL: the one-process trainer and the trainer on the
    data-parallel layout (its all-reduce over a group of one), from the
    same seeds, in PyTorch's deterministic mode (an op without a
    deterministic default may sum in an order that changes between
    runs): a warm-up step each, then ``PAR_STEPS`` steps a turn in
    the order one, NCCL, NCCL, one. Returns the losses, whether they and
    the parameters are bit-equal, and each trainer's steps/s by turn."""
    import os
    import warnings

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # before this process makes its cuBLAS handles
    import torch

    from msmd_tpu_torch.measure import build_trainer, train_batch
    from msmd_tpu_torch.parallel.mesh import Layout, make_layout

    dev = _card_setup()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainers = {"one_process": build_trainer(dev, f"{tmp}/one", Layout()),
                    "nccl": build_trainer(dev, f"{tmp}/nccl", make_layout(1))}
        batch = train_batch(trainers["nccl"].cfg, dev)
        out = {k: dict(losses=[t.train_one(batch)["loss"]], steps_per_s=[], distributed=t.layout.distributed)
               for k, t in trainers.items()}  # warm-up
        for name in ("one_process", "nccl", "nccl", "one_process"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name]["losses"] += [trainers[name].train_one(batch)["loss"] for _ in range(PAR_STEPS)]
            torch.cuda.synchronize()
            out[name]["steps_per_s"].append(PAR_STEPS / (time.perf_counter() - t0))
    for o in out.values():
        o["losses"] = [float(l) for l in o["losses"]]
    a, b = (_whole(trainers[k]) for k in ("one_process", "nccl"))
    out["losses_bit_equal"] = out["one_process"]["losses"] == out["nccl"]["losses"]
    out["params_bit_equal"] = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for t in trainers.values():
        t.close()
    return out


def _gloo_rank(tmp):
    """Two ranks on the one card, joined by gloo (NCCL takes one rank a
    device): the deterministic f32 step at dp = 2 and at tp = 2 against the
    one-process step; ``PAR_TRAIN_STEPS`` train-mode steps at dp = 2 and
    at tp = 2 with the kernels each rank ran (the wrappers' counts), then
    one more step's device events in torch.profiler; sharded ``infer_coeffs``
    at R = ``PAR_REPS``: with the initial noise and every step's z pinned
    to one global draw, each rank's rows against an unsharded call of
    R / 2 repetitions on the rank's rows of that draw (the same kernel
    route, so equal to ``PAR_SAMPLE_GATE``); and with the draws from the
    generator (the main path: its launches) against the unsharded call
    at R on rank 0, whose batch takes another route (K1 per-entry for
    K1 flat): that gap is reported, not gated."""
    import torch
    import torch.distributed as dist

    from msmd_tpu_torch.inference_lib import infer_coeffs
    from msmd_tpu_torch.measure import SEED, build_trainer, profiled, seeded_audio, train_batch
    from msmd_tpu_torch.parallel import tp as tpar
    from msmd_tpu_torch.parallel.mesh import Layout, make_layout

    dev = _card_setup()
    rank = dist.get_rank()
    out = {"rank": rank}
    ref = _deterministic(dev, f"{tmp}/det_one_{rank}", Layout(), 1)  # this rank alone, no group
    for tp in (1, 2):  # the deterministic step on the layout
        got = _deterministic(dev, f"{tmp}/det_{tp}_{rank}", make_layout(tp), tp)
        out[f"deterministic_{'dp2' if tp == 1 else 'tp2'}"] = _compare_steps(ref, got)
        del got
        torch.cuda.empty_cache()
    del ref
    ref = _deterministic(dev, f"{tmp}/cut_one_{rank}", Layout(), 1, truncated=True)
    got = _deterministic(dev, f"{tmp}/cut_dp2_{rank}", make_layout(1), 1, truncated=True)
    out["truncated_dp2"] = _compare_steps(ref, got)
    del ref, got
    torch.cuda.empty_cache()

    for tp in (1, 2):  # train mode, bf16, K7 where the layout lets it run
        layout = make_layout(tp)
        t = build_trainer(dev, f"{tmp}/train_{tp}_{rank}", layout, tp_size=tp)
        batch = train_batch(t.cfg, dev)
        losses = [t.train_one(batch)["loss"]]
        _reset_counts()
        losses += [t.train_one(batch)["loss"] for _ in range(PAR_TRAIN_STEPS)]
        torch.cuda.synchronize()
        launches = _counts()
        events = _kernel_events(lambda: losses.append(t.train_one(batch)["loss"]), TRAIN_KERNELS, agree=_all_ranks)
        out[f"train_{'dp2' if tp == 1 else 'tp2'}"] = dict(
            losses=[float(l) for l in losses], launches=launches, device_kernels_one_step=events,
            n_sharded=tpar.count_tp_sharded(t.model), replicas_equal=_replicas_equal(t, layout),
            local_batch=len(layout.rows(t.cfg.batch_size)))
        t.close()
        del t
        torch.cuda.empty_cache()

    # sharded sampling on the bf16 model: R repetitions over the two ranks, one window of 4 s
    layout = make_layout(1)
    model = build_trainer(dev, f"{tmp}/sample_{rank}", Layout()).model.eval()
    cfg = model.cfg
    audio = seeded_audio(cfg.n_motions / cfg.fps, SEED + 41)
    style = torch.randn(1, cfg.d_style, generator=torch.Generator().manual_seed(SEED + 42))
    run = lambda pg, R=PAR_REPS, **kw: infer_coeffs(
        model, audio, torch.zeros(1, 100), style_feats=style, n_repetitions=R, cfg_scale=1.15,
        dynamic_threshold=None, device=dev, process_group=pg,
        generator=torch.Generator(device=dev).manual_seed(SEED + 43), **kw)
    _reset_counts()
    t0 = time.perf_counter()
    sharded = run(layout.dp_group)
    torch.cuda.synchronize()
    out["sample"] = dict(wall_s=time.perf_counter() - t0, launches=_counts(), shape=list(sharded.shape),
                         finite=bool(torch.isfinite(sharded).all()))
    g = torch.Generator().manual_seed(SEED + 44)  # one global draw of every repetition's noise
    at_T = torch.randn(PAR_REPS, cfg.n_motions, cfg.motion_feat_dim, generator=g)
    zs = torch.randn(cfg.n_diff_steps, PAR_REPS, cfg.n_motions, cfg.motion_feat_dim, generator=g)
    mine = layout.rows(PAR_REPS)
    pinned = run(layout.dp_group, motion_at_T=at_T, noise_override=zs)
    alone = run(None, R=PAR_REPS // layout.dp, motion_at_T=at_T[mine], noise_override=zs[:, mine])
    ref = pinned[mine.to(dev)]
    out["sample"].update(same_route_rel_err=float((ref - alone).abs().max() / alone.abs().max()),
                         same_route_bit_equal=bool(torch.equal(ref, alone)), pinned_shape=list(pinned.shape))
    if rank == 0:
        _reset_counts()
        whole = run(None)
        torch.cuda.synchronize()
        out["sample"].update(unsharded_launches=_counts(),
                             cross_route_rel_err=float((sharded - whole).abs().max() / whole.abs().max()),
                             cross_route_max_abs_err=float((sharded - whole).abs().max()))
    dist.barrier()
    out["profiler_sessions_lost"] = profiled.lost
    return out


def _audio_weights(dev, tmp, trainer) -> dict:
    """A HuBERT-base-width HF directory (config.json + pytorch_model.bin)
    written from a second seeded encoder through the port's HF naming, and
    a model.safetensors copy by the port's writer; both loaded into the
    train path as ``--audio_weights`` does (``Trainer.load_pretrained_audio``).
    The encoder's tensors must equal what was written, bit for bit: the
    file's tensors after the loader's conversion (the positional
    convolution's weight-norm pair folded), and the source encoder's
    everywhere but that fold (its round trip is within 1 ulp)."""
    import json as _json
    from pathlib import Path

    import numpy as np
    import torch

    from msmd_tpu_torch.config import AudioEncoderConfig
    from msmd_tpu_torch.hf_loader import load_hf_audio_encoder_params, write_safetensors
    from msmd_tpu_torch.interop import _hf_audio_out, flax_tree
    from msmd_tpu_torch.measure import SEED
    from msmd_tpu_torch.models.audio import AudioEncoder
    from msmd_tpu_torch.models.layers import init_params

    src_tree = flax_tree(init_params(AudioEncoder(AudioEncoderConfig()), SEED + 30))
    sd = {}
    _hf_audio_out(sd, "hubert", src_tree)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    dirs = {"bin": Path(tmp) / "hubert_bin", "safetensors": Path(tmp) / "hubert_st"}
    for d in dirs.values():
        d.mkdir(parents=True)
        (d / "config.json").write_text(_json.dumps({"model_type": "hubert", "hidden_size": 768,
                                                    "num_hidden_layers": 12, "num_attention_heads": 12}))
    torch.save(tensors, dirs["bin"] / "pytorch_model.bin")
    write_safetensors(dirs["safetensors"] / "model.safetensors", tensors)
    src = _flatten(src_tree)
    out = {}
    for name, d in dirs.items():
        trainer.load_pretrained_audio(str(d))
        got = _flatten(flax_tree(trainer.model.audio_encoder))
        written = _flatten(load_hf_audio_encoder_params(str(d)))
        pos = ("encoder", "pos_conv_embed", "conv", "kernel")
        out[name] = dict(
            tensors=len(got), equal_to_file=got.keys() == written.keys()
            and all(np.array_equal(v, written[k]) for k, v in got.items()),
            equal_to_source_but_fold=all(np.array_equal(v, src[k]) for k, v in got.items() if k != pos),
            fold_rel_err=float(np.abs(got[pos] - src[pos]).max() / np.abs(src[pos]).max()),
            file_mb=sum(f.stat().st_size for f in d.iterdir()) / 2 ** 20)
    return out


def _flatten(tree, pre=()) -> dict:
    """A nested dict of arrays as {path tuple: f32 NumPy array}."""
    import numpy as np

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, pre + (k,)))
        else:
            out[pre + (k,)] = np.asarray(v, np.float32)
    return out


TRACE_SESSIONS = 8  # traced fits taken before phase parallel gives up (see measure.profiled)


WAVLM_STEPS = 3


def phase_train_wavlm(dev, smi):
    import dataclasses

    import torch

    from msmd_tpu_torch.config import WAVLM_LARGE
    from msmd_tpu_torch.measure import build_train_path, train_batch
    from msmd_tpu_torch.utils.profiling import counters

    path = build_train_path(dev, vertex=True, cfg_kw={"audio_model": "wavlm"},
                            audio_kw=dataclasses.asdict(WAVLM_LARGE))
    cfg = path["cfg"]
    batch = train_batch(cfg, dev)
    B = batch["motion_0"].shape[0]
    _vertex_steps(path, batch, 1)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    before = counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = _vertex_steps(path, batch, WAVLM_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after, launches = counters(), _counts()
    d = {n: after.get(n, 0) - before.get(n, 0) for n in ("msmd.wavlm.bias_tables", "msmd.k10.calls",
                                                          "msmd.k10.fwd_rows", "msmd.k10.bwd_rows",
                                                          "msmd.k10.plain_calls")}
    layers, T, tokens = WAVLM_LARGE.num_layers, WAVLM_STEPS, 2 * cfg.n_motions
    tables = d["msmd.wavlm.bias_tables"]
    losses = [float(l) for l, _ in out]
    checks = {
        "finite_losses": all(math.isfinite(l) for l in losses),
        "one_trained_encoder_call_a_step": T <= tables <= 2 * T,
        "k10_fwd_launches": launches["relpos_fwd"] == layers * tables,
        "k10_bwd_launches": launches["relpos_bwd"] == layers * T,
        "k10_bwd_rows": d["msmd.k10.bwd_rows"] == layers * T * 2 * B * tokens,
        "k10_calls_counter": d["msmd.k10.calls"] == launches["relpos_fwd"] + launches["relpos_bwd"],
        "no_plain_route": d["msmd.k10.plain_calls"] == 0,
        "no_sampling_kernels": all(launches[k] == 0 for k in ("decoder", "scan", "step")),
    }
    emit({"phase": "train_wavlm", "batch": B, "clips": 2, "tokens_a_clip": tokens, "layers": layers, "steps": T,
          "losses": losses, "wall_s": wall, "steps_per_s": T / wall,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches, "counters": d,
          "checks": checks, "card": smi})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: train_wavlm checks failed: {checks}")
    return {k: launches[k] / T for k in ("relpos_fwd", "relpos_bwd")}


def phase_parallel(dev, smi):
    import tempfile
    from pathlib import Path

    import torch

    from msmd_tpu_torch.config import MSMDConfig
    from msmd_tpu_torch.measure import LAUNCH_CALL, build_trainer, profiled, train_batch
    from msmd_tpu_torch.parallel.mesh import spawn
    from msmd_tpu_torch.utils.profiling import device_memory_stats

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 1 and 4: pretrained audio weights into the train path, then a traced fit on it
        trainer = build_trainer(dev, f"{tmp}/exp")
        weights = _audio_weights(dev, tmp, trainer)
        batch = train_batch(trainer.cfg, dev)
        torch.cuda.reset_peak_memory_stats()
        for session in range(TRACE_SESSIONS):  # a trace with fewer kernel records than launch calls is taken again
            if session:
                trainer = build_trainer(dev, f"{tmp}/exp{session}")
            trainer.fit(iter([batch, batch]), max_iter=1, profile_dir=f"{tmp}/prof{session}", profile_steps=(0, 1))
            trainer.close()
            traces = sorted(Path(f"{tmp}/prof{session}").glob("*.pt.trace.json"))
            data = traces[0].read_bytes() if traces else b""
            events = json.loads(data)["traceEvents"] if data else []
            kernels = sum(e.get("cat") == "kernel" for e in events)
            launches = sum(e.get("cat") == "cuda_runtime" and bool(LAUNCH_CALL.match(e.get("name", "")))
                           for e in events)
            if kernels >= launches:
                break
        trace = dict(files=len(traces), mb=len(data) / 2 ** 20, sessions=session + 1, kernels=kernels,
                     launch_calls=launches, names={k: sub.encode() in data for k, sub in TRAIN_KERNELS.items()})
        memory = device_memory_stats()
        del trainer, batch, data, events
        torch.cuda.empty_cache()
        # 2: NCCL at world size 1, in a process of its own (deterministic mode, cuBLAS's workspace setting)
        nccl = spawn(_nccl_world1, 1, "nccl", f"{tmp}/store_nccl", (tmp,), timeout=PAR_TIMEOUT)[0]
        # 3: two ranks on the one card over gloo
        ranks = spawn(_gloo_rank, 2, "gloo", f"{tmp}/store_gloo", (tmp,), timeout=PAR_TIMEOUT)
    per_rank = {f"rank{r['rank']}": r for r in ranks}
    # a vertex-space step with two_clip_batch: K5 4 and K5 bwd 2 calls (two clips, gt and pred; pred's
    # backward), K7 once a decoder layer forward and once backward
    L, T = MSMDConfig().n_layers, PAR_TRAIN_STEPS
    checks = {
        "audio_weights_bit_equal": all(w["equal_to_file"] and w["equal_to_source_but_fold"]
                                       and w["fold_rel_err"] <= 2.4e-7 for w in weights.values()),
        "trace_written": trace["files"] == 1 and trace["kernels"] >= trace["launch_calls"] > 0
        and all(trace["names"].values()),
        "peak_memory_reported": memory.get("cuda:0", {}).get("peak_mb_in_use", 0) > 0,
        "nccl_world1_bit_equal": nccl["losses_bit_equal"] and nccl["params_bit_equal"] and nccl["nccl"]["distributed"],
        "dp2_matches_one_process": all(r["deterministic_dp2"]["ok"] for r in ranks),
        "tp2_matches_one_process": all(r["deterministic_tp2"]["ok"] for r in ranks),
        "truncated_dp2_matches_one_process": all(r["truncated_dp2"]["ok"] for r in ranks),
        "dp2_ran_k5_k5bwd_k7": all(r["train_dp2"]["launches"]["lbs"] == 4 * T
                                   and r["train_dp2"]["launches"]["lbs_bwd"] == 2 * T
                                   and r["train_dp2"]["launches"]["ffn_train_fwd"] == L * T
                                   and r["train_dp2"]["launches"]["ffn_train_bwd"] == L * T
                                   and all(v > 0 for v in r["train_dp2"]["device_kernels_one_step"].values())
                                   for r in ranks),
        "tp2_ran_k5_k5bwd_not_k7": all(r["train_tp2"]["launches"]["lbs"] == 4 * T
                                       and r["train_tp2"]["launches"]["lbs_bwd"] == 2 * T
                                       and r["train_tp2"]["launches"]["ffn_train_fwd"] == 0
                                       and r["train_tp2"]["launches"]["ffn_train_bwd"] == 0
                                       and r["train_tp2"]["device_kernels_one_step"]["ffn_train"] == 0
                                       and r["train_tp2"]["n_sharded"] > 20 for r in ranks),
        "replicas_equal": all(r[f"train_{k}"]["replicas_equal"] for r in ranks for k in ("dp2", "tp2")),
        "finite_losses": all(math.isfinite(l) for r in ranks for k in ("dp2", "tp2")
                             for l in r[f"train_{k}"]["losses"]),
        "sharded_sample_matches": all(r["sample"]["same_route_rel_err"] <= PAR_SAMPLE_GATE and r["sample"]["finite"]
                                      and r["sample"]["shape"][0] == r["sample"]["pinned_shape"][0] == PAR_REPS
                                      for r in ranks),
        "sharded_sample_ran_k1_or_k3": all(r["sample"]["launches"]["decoder"] + r["sample"]["launches"]["decoder_flat"]
                                           + r["sample"]["launches"]["scan"] > 0 for r in ranks),
    }
    emit({"phase": "parallel", "audio_weights": weights, "trace": trace, "device_memory": memory, "nccl_world1": nccl,
          "gloo_ranks": per_rank, "wall_s": time.perf_counter() - t_phase,
          "profiler_sessions_lost": {"main": profiled.lost,
                                     **{k: r["profiler_sessions_lost"] for k, r in per_rank.items()}},
          "tolerance": f"deterministic f32 step vs one process: loss rtol {PAR_LOSS_RTOL}, gradients "
                       f"{PAR_GRAD_REL} max|g| + {PAR_GRAD_ATOL}, updated parameters rtol {PAR_PARAM_RTOL} atol "
                       f"{PAR_PARAM_ATOL} where |g| >= {PAR_PARAM_FLOOR} max|g|; sharded sampling, a rank's rows "
                       f"against the same route unsharded on the same pinned noise, max|err|/max|ref| <= "
                       f"{PAR_SAMPLE_GATE}", "checks": checks, "card": smi})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: parallel checks failed: {checks}")


def main() -> int:
    smi = phase_device()
    import torch

    from msmd_tpu_torch.measure import build_main_path

    dev = torch.device("cuda", 0)
    logs = phase_build()
    kernels = phase_kernels(dev, logs)
    built = build_main_path(dev)
    main_launches = phase_main(dev, smi, built)
    b1_launches, traj_launches = phase_batch1(dev, smi, built)
    guided_launches = phase_guided(dev, smi, built)
    phase_separate(dev, smi, built)
    serving_launches = phase_serving(dev, smi, built)
    del built
    torch.cuda.empty_cache()
    train_launches = phase_train(dev, smi)
    torch.cuda.empty_cache()
    vertex_launches = phase_train_vertex(dev, smi)
    torch.cuda.empty_cache()
    wavlm_launches = phase_train_wavlm(dev, smi)
    torch.cuda.empty_cache()
    phase_parallel(dev, smi)
    library_launches = phase_library(dev, smi)
    kernels["decoder"]["launches"] = main_launches["decoder"]
    kernels["lbs"]["launches"] = main_launches["lbs"]
    kernels["scan"]["launches"] = b1_launches["scan"]
    kernels["step"]["launches"] = traj_launches["step"]
    for k in ("ffn_train_fwd", "ffn_train_bwd"):
        kernels[k]["launches"] = train_launches[k]
    kernels["lbs_bwd"]["launches"] = vertex_launches["lbs_bwd"]
    for k in ("relpos_fwd", "relpos_bwd"):
        kernels[k]["launches"] = wavlm_launches[k]  # a step
    kernels["ffn"]["launches"] = guided_launches["default"]["ffn"]
    kernels["attn"]["launches"] = guided_launches["attn_kernel"]["attn"]
    for k, B in K8_F32_BATCHES.items():
        kernels[k]["launches"] = library_launches[B]
    kernels["tail"]["launches"] = guided_launches["fused_tail"]["tail"]
    for k in ("decoder_flat", "resident"):
        kernels[k]["launches"] = serving_launches[k]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    order = ("decoder", "decoder_flat", "resident", "scan", "step", "lbs", "lbs_bwd", "ffn_train_fwd",
             "ffn_train_bwd", "ffn", "attn", *K8_F32_BATCHES, "tail", "relpos_fwd", "relpos_bwd")
    emit({"kernels": [{key: kernels[k][key] for key in keys} for k in order]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
