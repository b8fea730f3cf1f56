"""Where the time goes on the card: device time by kernel for the decoder
stack and for one window of the main path.

    python -m msmd_tpu_torch.profile

Prints JSON lines:

- ``decoder``: device time per call of each kernel of the decoder stack
  (``csrc/decoder.cu``) at the batch-48 flagship shapes, from
  ``torch.profiler`` over 5 calls.
- ``main_path``: one 4 s window at batch 48 (HuBERT, 500 guided DDPM
  steps, FLAME decode). Its wall time is taken without the profiler
  (host clock, ending in a synchronise); a second, profiled run gives the
  device time by kernel. ``device_busy_share`` is the summed device time
  over the un-profiled wall time; the rest is the card waiting on the host.

Needs a card, like every number it prints.
"""

from __future__ import annotations

import json
import re
import sys
import time

import torch

_DECODER_KERNELS = ("gemm_kernel", "self_attn_kernel", "person_attn_kernel", "ln_kernel", "cast_kernel")


def _short(name: str) -> str:
    """A kernel of this package by its short name and template arguments
    (from the demangled ``<1, 64>`` or the mangled ``ILi1ELi64EE`` form),
    any other kernel by the start of its name."""
    m = re.search(r"(?<![a-z_])(gemm|self_attn|person_attn|ln|cast|lbs)_kernel(?:<([\w, ]+)>|I((?:L[ib]\d+E)+)E)?",
                  name)
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


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_ms_by_kernel(prof)


def main() -> int:
    if not torch.cuda.is_available():
        print("msmd_tpu_torch.profile needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from msmd_tpu_torch.measure import BATCH, SEED, build_main_path, decoder_case, generate, seeded_audio
    from msmd_tpu_torch.ops.kernels import decoder as kd

    dev = torch.device("cuda", 0)
    calls = 5
    with torch.no_grad():
        args = decoder_case(dev)
        kd.fused_decoder_forward(*args)
        by_kernel = _profile(lambda: [kd.fused_decoder_forward(*args) for _ in range(calls)])
    per_call = {k: v / calls for k, v in by_kernel.items()}
    print(json.dumps({"phase": "decoder", "calls": calls, "ms_per_call": per_call,
                      "total_ms_per_call": sum(per_call.values()),
                      "device_time_seen": bool(per_call)}), flush=True)
    del args

    model, style, fused = build_main_path(dev)
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    audio = seeded_audio(cfg.n_motions / cfg.fps, SEED + 6)
    generate(model, style, fused, audio, BATCH, gen, dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, style, fused, audio, BATCH, gen, dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = _profile(lambda: generate(model, style, fused, audio, BATCH, gen, dev))
    busy = sum(by_kernel.values())
    decoder = sum(v for k, v in by_kernel.items() if k.split("<")[0] in _DECODER_KERNELS)
    lbs = sum(v for k, v in by_kernel.items() if k.startswith("lbs_kernel"))
    print(json.dumps({
        "phase": "main_path", "batch": BATCH, "windows": 1, "diff_steps": cfg.n_diff_steps,
        "wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
        "decoder_kernel_ms": decoder, "lbs_kernel_ms": lbs, "other_kernels_ms": busy - decoder - lbs,
        "top_kernels_ms": dict(list(by_kernel.items())[:25]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
