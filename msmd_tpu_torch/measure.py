"""Seeded cases, bounds and timing shared by ``chip_smoke.py`` and
``python -m msmd_tpu_torch.profile``.

The cases are the main path's shapes at the flagship configuration:
the decoder stack at batch 48 with two CFG entries (Be = 96, lq = 111,
8 x 512 layers, FFN 2048) and the FLAME decode of one 4 s window at
batch 48 (N = 4800 frames, V = 5023). A bound is the least time an H100
SXM could take for the same work: the larger of the bytes that must move
(each input read once, each output written once) over the memory rate
and the operations over the peak rate of their type (NVIDIA's data sheet).
"""

from __future__ import annotations

import numpy as np
import torch

BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s
F32_PEAK = 67e12  # f32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12  # HBM3 bytes/s

SEED = 0
BATCH = 48
CFG_SCALE = 1.15


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: int, nbytes: int, peak: float):
    """(bound in ms, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def decoder_case(dev, Be=96, lq=111, F=512, H=8, L=8, FF=2048, seed=SEED):
    """Seeded decoder weights and inputs; returns the wrapper's arguments."""
    from msmd_tpu_torch.models.layers import init_params
    from msmd_tpu_torch.models.transformer import TransformerDecoder
    from msmd_tpu_torch.ops.kernels import decoder as kd

    dec = init_params(TransformerDecoder(L, F, H, FF), seed).to(dev)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(Be, lq, F, generator=g).to(dev)
    mem = torch.randn(Be, lq - 1, F, generator=g).to(dev)
    with torch.no_grad():
        pack = kd.pack_decoder_weights(dec)
        kmem, vmem = kd.pack_memory_kv(dec.cache_memory(mem))
        vmw = kd.build_vmw(vmem, pack["wco"], lq)
    return (pack, kmem, vmem, x, kd.person_rows(Be, lq, dev), H, vmw)


def decoder_work(args):
    """(flops, bytes) of one call of the decoder stack."""
    pack, kmem, vmem, x, aux, H, vmw = args
    Be, lq, F = x.shape
    L, FF = pack["wqkv"].shape[0], pack["wf1"].shape[-1]
    R, lm, dh = Be * lq, lq - 1, F // H
    per_layer = (2 * R * F * 3 * F + 2 * R * F * F + 2 * R * F * FF * 2  # QKV, self-out, FFN
                 + 2 * 2 * Be * H * lq * lq * dh  # per-entry self-attention
                 + 2 * Be * F * F * 2 + 2 * 2 * Be * H * lm * dh)  # person rows: wcq, wco, attention
    nbytes = sum(t.numel() * t.element_size() for t in pack.values())
    nbytes += sum(t.numel() * t.element_size() for t in (kmem, vmem, vmw, x, aux)) + x.numel() * 4
    return L * per_layer, nbytes


def lbs_case(dev, N=4800, V=5023, seed=SEED):
    """Seeded FLAME buffers and coefficients; returns (fused, (betas_ext, rt))."""
    from msmd_tpu_torch.models.flame import synthetic_flame
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame, skin_inputs

    fused = FusedFlame(synthetic_flame(n_verts=V, seed=seed, device=dev))
    rs = np.random.RandomState(seed + 2)
    shape, exp, pose = [torch.as_tensor((rs.randn(N, n) * s).astype(np.float32), device=dev)
                        for n, s in ((100, 0.3), (50, 0.3), (6, 0.4))]
    return fused, skin_inputs(fused, shape, exp, pose)


def lbs_work(fused, betas_ext, rt):
    """(flops, bytes) of one call of the skinning kernel."""
    N, KB, V = betas_ext.shape[0], betas_ext.shape[1], fused.n_verts
    # blendshapes: 3 coordinates x KB multiply-adds; skinning: 5 joints x
    # 3 rows x (3 multiply-adds + 1 add) + 3 weighted accumulations
    flops = N * V * (3 * 2 * KB + 5 * (3 * 7 + 3 * 2))
    nbytes = 4 * (N * KB + N * 60 + 3 * KB * V + 3 * V + 5 * V + N * V * 3)
    return flops, nbytes


def build_main_path(dev, cfg_kw=None, audio_kw=None, n_verts=5023, seed=SEED):
    """The bf16 MSMD and the VAE2 style encoder with seeded weights, a
    style embedding from a seeded 100-frame clip, and synthetic FLAME
    buffers. Defaults are the flagship widths."""
    from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
    from msmd_tpu_torch.models.diffusion import get_diffusion_model
    from msmd_tpu_torch.models.flame import synthetic_flame
    from msmd_tpu_torch.models.layers import init_params
    from msmd_tpu_torch.models.style_encoder import get_style_encoder
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame

    cfg = MSMDConfig(**(cfg_kw or {}))
    model = get_diffusion_model(cfg, audio_config=AudioEncoderConfig(**(audio_kw or {})),
                                dtype=torch.bfloat16, device=dev, seed=seed)
    style_enc = init_params(get_style_encoder(cfg), seed + 3).to(dev).eval()
    clip = np.random.RandomState(seed + 4).randn(1, 100, cfg.motion_feat_dim).astype(np.float32)
    with torch.no_grad():
        style = style_enc.encode_mean(torch.as_tensor(clip, device=dev)).float()
    return model, style, FusedFlame(synthetic_flame(n_verts=n_verts, seed=seed, device=dev))


def seeded_audio(seconds: float, seed: int) -> np.ndarray:
    """z-scored 16 kHz noise."""
    a = np.random.RandomState(seed).randn(int(seconds * 16000)).astype(np.float32)
    return (a - a.mean()) / a.std()


def generate(model, style, fused, audio, reps, generator, dev):
    """``infer_coeffs``, then every window's frames through the FLAME
    kernel (expression and head pose from the motion, zero shape, as
    ``bench.py`` decodes). Returns (coeffs, vertices)."""
    from msmd_tpu_torch.inference_lib import infer_coeffs
    from msmd_tpu_torch.ops.kernels.lbs import flame_vertices

    cfg = model.cfg
    coeffs = infer_coeffs(model, audio, torch.zeros(1, 100), style_feats=style, n_repetitions=reps,
                          cfg_scale=CFG_SCALE, generator=generator, device=dev)
    verts = []
    for w0 in range(0, coeffs.shape[1], cfg.n_motions):
        m = coeffs[:, w0:w0 + cfg.n_motions].reshape(-1, coeffs.shape[-1]).float()
        pose6 = torch.cat([m[:, -3:], torch.zeros_like(m[:, :3])], dim=-1)
        verts.append(flame_vertices(fused, torch.zeros(m.shape[0], 100, device=m.device), m[:, :50], pose6))
    return coeffs, torch.cat(verts, dim=0)
