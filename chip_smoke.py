"""Chip smoke test of the PyTorch / CUDA port (``msmd_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: needs ``torch.cuda.is_available()`` (else it exits 1 and prints
   no result); turns TF32 off for float32 products and convolutions.
2. build: compiles ``msmd_tpu_torch/csrc/*.cu`` with ``nvcc``, one process
   per source, all started together.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the same CUDA tensors at the flagship shapes of the main path, and
   timed with CUDA events beside its bound (``msmd_tpu_torch/measure.py``:
   the larger of bytes over 3.35 TB/s and operations over the peak rate of
   their type on an H100 SXM, 989 TFLOP/s bf16 or 67 TFLOP/s f32).
   - decoder stack: Be = 96 (batch 48, two CFG entries), lq = 111,
     8 x 512 layers, bf16 pack; max |err| / max |plain| <= 2e-2.
   - FLAME decode: N = 4800 frames, V = 5023; max |err| <= 1e-4 (f32, no TF32).
4. main path: the flagship bf16 MSMD (8 x 512 denoiser, HuBERT-base
   12 x 768 encoder, 500 DDPM steps) and the VAE2 style encoder with
   seeded random weights; ``infer_coeffs`` on 8 s of seeded audio
   (2 windows) with 48 repetitions and cfg_scale 1.15, then every frame
   decoded to vertices through the FLAME kernel on a synthetic 5023-vertex
   FLAME. Launch counts are set to 0 just before it and read just after:
   the decoder kernel must have run 2 x 500 times, the FLAME kernel once
   per window. A warm-up window runs first, so the timed run holds no
   one-time set-up.

The line before the last is the per-kernel summary
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

AUDIO_SECONDS = 8.0


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
    from msmd_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build(["decoder", "lbs"])
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas {name}] {line.strip()}")
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs)})


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def phase_kernels(dev):
    import torch

    from msmd_tpu_torch.measure import (BF16_PEAK, F32_PEAK, bound, cuda_ms, decoder_case, decoder_work,
                                        lbs_case, lbs_work)
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import lbs as kl

    out = {}
    with torch.no_grad():
        args = decoder_case(dev)
        got = kd.fused_decoder_forward(*args)
        want = kd.fused_decoder_forward_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and rel <= 2e-2
        flops, nbytes = decoder_work(args)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        out["decoder"] = dict(
            name="fused_decoder_forward", route="cuda", source="msmd_tpu_torch/csrc/decoder.cu",
            replaces="msmd_tpu/ops/pallas/decoder_kernel.py:560",
            max_abs_err=err, rel_err=rel, tolerance="max|err|/max|plain| <= 2e-2",
            ms=cuda_ms(lambda: kd.fused_decoder_forward(*args), 20),
            plain_ms=cuda_ms(lambda: kd.fused_decoder_forward_plain(*args), 3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, flops=flops, bytes=nbytes, ok=ok,
        )
        del args, got, want

        fused, (betas_ext, rt) = lbs_case(dev)
        got = kl.skin_cuda(fused, betas_ext, rt)
        want = kl.skin_plain(fused, betas_ext, rt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= 1e-4 and got.shape == (4800, 5023, 3)
        flops, nbytes = lbs_work(fused, betas_ext, rt)
        bound_ms, bound_by = bound(flops, nbytes, F32_PEAK)
        out["lbs"] = dict(
            name="flame_vertices", route="cuda", source="msmd_tpu_torch/csrc/lbs.cu",
            replaces="msmd_tpu/ops/pallas/lbs_kernel.py:197",
            max_abs_err=err, tolerance="max|err| <= 1e-4 (f32)",
            ms=cuda_ms(lambda: kl.skin_cuda(fused, betas_ext, rt), 20),
            plain_ms=cuda_ms(lambda: kl.skin_plain(fused, betas_ext, rt), 3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, flops=flops, bytes=nbytes, ok=ok,
        )
        del got, want
    emit({"phase": "kernels", **out})
    bad = [k for k, v in out.items() if not v["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: kernel(s) disagree with their plain version: {bad}")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path, audio -> guided DDPM -> FLAME vertices
# ---------------------------------------------------------------------------

def phase_main(dev, smi):
    import torch

    from msmd_tpu_torch.measure import BATCH, SEED, build_main_path, generate, seeded_audio
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import lbs as kl

    model, style, fused = build_main_path(dev)
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    # warm-up window: one-time library and allocator set-up stays out of the timed run
    generate(model, style, fused, seeded_audio(cfg.n_motions / cfg.fps, SEED + 6), BATCH, gen, dev)
    torch.cuda.synchronize()

    audio = seeded_audio(AUDIO_SECONDS, SEED + 7)
    n_windows = math.ceil(int(AUDIO_SECONDS * cfg.fps) / cfg.n_motions)
    kd.fused_decoder_forward.launches = 0
    kl.flame_vertices.launches = 0
    t0 = time.perf_counter()
    coeffs, verts = generate(model, style, fused, audio, BATCH, gen, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decoder": kd.fused_decoder_forward.launches, "lbs": kl.flame_vertices.launches}

    frames = int(AUDIO_SECONDS * cfg.fps)
    checks = {
        "coeffs_shape": list(coeffs.shape) == [BATCH, frames, cfg.motion_feat_dim],
        "verts_shape": list(verts.shape) == [BATCH * frames, fused.n_verts, 3],
        "finite": bool(torch.isfinite(coeffs).all()) and bool(torch.isfinite(verts).all()),
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
    return launches, n_windows


def main() -> int:
    smi = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev)
    launches, _ = phase_main(dev, smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        kernels[k]["launches"] = launches[k]
    emit({"kernels": [{key: kernels[k][key] for key in keys} for k in ("decoder", "lbs")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
