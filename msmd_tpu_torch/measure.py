"""Seeded cases, bounds and timing shared by ``chip_smoke.py``,
``python -m msmd_tpu_torch.profile`` and ``tests/test_torch_cuda.py``.

The cases are the main paths' shapes at the flagship configuration:
the decoder stack at batch 48 with two CFG entries (Be = 96, lq = 111,
8 x 512 layers, FFN 2048), the batch-1 sampler kernels (E = 2 CFG
entries, lq = 111, the same layers, 500 steps) and the FLAME decode of
one 4 s window at batch 48 (N = 4800 frames, V = 5023), and the training
FFN block K7 at the train step's shapes (batch 16 x 111 rows = 1776 rows,
F 512, FFN 2048, dropout 0.1), and the kernels of the guided batch-48
window (two CFG entries, Be = 96, lq = 111): K6 over Be x lq = 10656 rows,
K8 over 96 entries of 111 rows with 8 heads of 64, and K9 over the motion
rows Be x 110 = 10560; K1's flat-mask mode at the 2-slot serving shape
(Be = 4 entries of lq = 111 rows in one tile, the identity band) and at
the batch-1 shape of a model without the alignment mask (Be = 2, the
full masked cross-attention), and K2 at K1's batch-48 shapes; K5 bwd at a
vertex-space train step's clip-1 frames (N = 1760, batch 16 x 110), and
the training configuration at the HDTF vertex-space layout
(``build_train_path(..., vertex=True)``). A bound is
the least time an H100
SXM could take for the same work: the larger of the bytes that must move
(each input read once, each output written once) over the memory rate
and the operations over the peak rate of their type (NVIDIA's data sheet).
"""

from __future__ import annotations

import re

import numpy as np
import torch

BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s
F32_PEAK = 67e12  # f32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12  # dense TF32 tensor-core FLOP/s
HBM_RATE = 3.35e12  # HBM3 bytes/s

SEED = 0
BATCH = 48
CFG_SCALE = 1.15
TRAIN_BATCH = 16  # the JAX train bench's batch (benchmarks/bench_train.py)


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


LAUNCH_CALL = re.compile(r"^cudaLaunch(Cooperative)?Kernel")  # the runtime's launch calls, as the profiler names them


def kernel_events(prof) -> list:
    """The card's kernel events of a torch.profiler session (no memcpy
    or memset), in start order."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    return sorted(events, key=lambda e: e.time_range.start)


def profiler_session(fn, pad_s: float = 0.0):
    """One torch.profiler session (CPU and CUDA activity) around one call
    of ``fn`` with ``pad_s`` of idle host time inside each end, ended after
    a synchronize: (the session, its kernel events, its runtime launch
    calls)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    launches = [e for e in prof.events() if e.device_type == DeviceType.CPU and LAUNCH_CALL.match(e.name)]
    return prof, kernel_events(prof), sorted(launches, key=lambda e: e.time_range.start)


PROFILE_PAD_S = 0.005  # idle host time inside each profiler session, before and after the call
PROFILE_TRIES = 40  # sessions ``profiled`` takes before it gives up


def profiled(fn, tries: int = PROFILE_TRIES, agree=lambda whole: whole, pad_s: float = PROFILE_PAD_S):
    """A torch.profiler session (CPU and CUDA activity) around one call of
    ``fn``, ended after a synchronize, whose device records are whole.

    On the H100 machines (torch 2.11, Kineto with CUPTI) a session now and
    then keeps its host-side launch calls (``cudaLaunchKernelExC``) and
    none of their kernels' device records, in stretches of a process that
    lose most sessions. The sessions kept in such a stretch show why: their
    kernels' converted start times scatter far before and after their own
    launch calls, and Kineto drops every device record that falls outside
    the session's window ("TraceActivity outside of profiling window").
    ``python -m msmd_tpu_torch.profile --profiler-sessions`` measures both.
    So the call sits ``pad_s`` of idle host time inside each end of the
    session, which keeps a record that is off by less than that, and a
    session with fewer kernel events than runtime launch calls is taken
    again (``fn`` runs again), up to ``tries`` sessions; then this raises.
    A kernel that fails to launch raises in its wrapper, so a retake never
    stands in for one that did not run. ``agree`` maps this process's
    verdict to the one all ranks act on (all retake together when ``fn``
    runs collectives). ``profiled.lost`` holds (kernel events, launch
    calls) of each session taken again."""
    for _ in range(tries):
        prof, kernels, launches = profiler_session(fn, pad_s)
        if agree(len(kernels) >= len(launches)):
            return prof
        profiled.lost.append((len(kernels), len(launches)))
    raise RuntimeError(f"torch.profiler kept fewer kernel records than launch calls in {tries} sessions")


profiled.lost = []


L2_FLUSH_BYTES = 256 << 20  # written between calls: five times the H100's 50 MB L2


def cuda_ms_flushed(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` with the L2 cache flushed
    before each call (a 256 MB buffer written in between), each call
    timed alone by CUDA events, as a caller finds its inputs when other
    work ran in between."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        buf.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    del buf
    return sum(start.elapsed_time(end) for start, end in events) / iters


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


def decoder_products(Be: int, lq: int, F: int, L: int, FF: int) -> dict:
    """The bf16 products of one call of the per-entry decoder stack, by
    name: (M, N, K) of one layer's product, its epilogue in
    ``ops/kernels/gemm.py``'s terms (None for the person rows, which stay
    on the wmma tile), and its operations over all L layers. Their sum is
    ``decoder_work``'s operations less the attention's."""
    R = Be * lq
    shapes = {"qkv": (R, 3 * F, F, "bf16"), "self_out": (R, F, F, "resid_ln_cross"), "ffn1": (R, FF, F, "gelu"),
              "ffn2": (R, F, FF, "resid_ln"), "person_q": (Be, F, F, None), "person_out": (Be, F, F, None)}
    return {name: {"M": M, "N": N, "K": K, "epilogue": epi, "flops": L * 2 * M * N * K}
            for name, (M, N, K, epi) in shapes.items()}


def gemm_case(dev, M: int, N: int, K: int, epilogue: str, seed=SEED, lq: int = 111):
    """Seeded operands of one decoder product for ``ops/kernels/gemm.gemm``:
    (a, b, bias) and, for the LayerNorm epilogues, (res, ln_scale,
    ln_bias); a keyword dict for the call (the q-column scale for "bf16",
    as QKV takes it; for "resid_ln_cross" vmw, zero on the person rows
    e * lq as ``build_vmw`` makes it, bco, the second LayerNorm's
    parameters and the person rows)."""
    rn = _seeded(seed + 50)
    bf = lambda t: t.to(dev, torch.bfloat16).contiguous()
    f32 = lambda t: t.to(dev, torch.float32).contiguous()
    args = (bf(rn(M, K)), bf(rn(K, N) / K ** 0.5), bf(rn(N) * 0.1))
    if epilogue == "resid_ln":
        return args + (f32(rn(M, N)), f32(1.0 + 0.1 * rn(N)), f32(0.1 * rn(N))), {}
    if epilogue == "resid_ln_cross":
        args += (f32(rn(M, N)), f32(1.0 + 0.1 * rn(N)), f32(0.1 * rn(N)))
        aux = torch.arange(0, M, lq, dtype=torch.int32)
        vmw = rn(M, N)
        vmw[aux.long()] = 0.0
        return args, {"vmw": bf(vmw), "bco": bf(rn(N) * 0.1), "ln2_scale": f32(1.0 + 0.1 * rn(N)),
                      "ln2_bias": f32(0.1 * rn(N)), "aux": aux.to(dev).contiguous(), "lq": lq}
    return args, ({"scale": 0.125, "scale_cols": N // 3} if epilogue == "bf16" else {})


def gemm_ws_case(dev, M: int, N: int, K: int, epilogue: str, res_dtype=None, out: str = "bf16", seed=SEED):
    """Seeded operands of one K6 / K9 product for
    ``ops/kernels/gemm_ws.gemm_ws``: (a, w, bias), w (N, K) in the
    nn.Linear layout, and a keyword dict: for "resid_ln" the residual in
    ``res_dtype``, ln_scale, ln_bias and ``out``."""
    rn = _seeded(seed + 51)
    bf = lambda t: t.to(dev, torch.bfloat16).contiguous()
    f32 = lambda t: t.to(dev, torch.float32).contiguous()
    args = (bf(rn(M, K)), bf(rn(N, K) / K ** 0.5), bf(rn(N) * 0.1))
    if epilogue != "resid_ln":
        return args, {}
    return args, {"res": rn(M, N).to(dev, res_dtype).contiguous(), "ln_scale": f32(1.0 + 0.1 * rn(N)),
                  "ln_bias": f32(0.1 * rn(N)), "out": out}


def decoder_flat_case(dev, Be=4, lq=111, width=1, tile=0, F=512, H=8, L=8, FF=2048, seed=SEED):
    """Seeded arguments of K1's flat-mask mode in tiles of ``tile`` entries
    (0: one tile of all Be): (pack, kmem, vmem, x, aux, H, vmw, self_mask,
    cross_mask, tile). Width 1: the identity band (person rows, vmw, the
    person mask); otherwise the full masked cross (the block mask, plus
    the alignment band of that width when it is not 0; no aux or vmw)."""
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.seq import alignment_mask

    tile = tile or Be
    lm = lq - 1
    pack, kmem, vmem, x, aux, H, vmw = decoder_case(dev, Be=Be, lq=lq, F=F, H=H, L=L, FF=FF, seed=seed)
    if width == 1:
        self_mask = kd.build_masks(tile, lq, lm, None, dev)[0]
        return pack, kmem, vmem, x, aux, H, vmw, self_mask, kd.build_person_mask(tile, lm, dev), tile
    self_mask, cross_mask = kd.build_masks(tile, lq, lm, alignment_mask(0, lm, width) if width else None, dev)
    return pack, kmem, vmem, x, None, H, None, self_mask, cross_mask, tile


def decoder_flat_work(args):
    """(flops, bytes) of one flat-mode call. The attention counts the
    (query, key) pairs its masks leave unmasked (the work these inputs
    need), each 2 x 2 x dh operations per head (scores and PV)."""
    pack, kmem, vmem, x, aux, H, vmw, self_mask, cross_mask, tile = args
    Be, lq, F = x.shape
    L, FF = pack["wqkv"].shape[0], pack["wf1"].shape[-1]
    R, dh, n_tiles = Be * lq, F // H, Be // tile
    live = lambda m: int((m > -1e29).sum()) * n_tiles
    per_layer = (2 * R * F * 3 * F + 2 * R * F * F + 2 * R * F * FF * 2  # QKV, self-out, FFN
                 + 4 * H * dh * live(self_mask) + 4 * H * dh * live(cross_mask)  # masked attentions
                 + 2 * (Be if vmw is not None else R) * F * F * 2)  # wcq, wco: person rows or every row
    tensors = list(pack.values()) + [kmem, vmem, x, self_mask, cross_mask] + [t for t in (aux, vmw) if t is not None]
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + x.numel() * 4
    return L * per_layer, nbytes


def sampler_case(dev, P=10, N=100, F=512, H=8, L=8, FF=2048, T=500, seed=SEED, dtype=torch.bfloat16):
    """Seeded inputs of the batch-1 sampler kernels, built by the
    sampler's own ``batch1_sampler_args`` from a denoiser in ``dtype``
    with random weights and biases, with the two CFG entries that equal scales of
    ``CFG_SCALE`` keep. Returns (scan_args, step_args, kw) for
    ``fused_sampler_scan(*scan_args, **kw)`` (T steps) and
    ``fused_sampler_step(*step_args, **kw)`` (the last of them, t = 1,
    where the update of the default ``target="sample"`` is x_0 = target
    (A = 0, B = 1, sigma = 0): there a comparison reads the whole
    denoiser, where at t = T the shared x_T and z would swamp it)."""
    from msmd_tpu_torch.config import MSMDConfig
    from msmd_tpu_torch.models.denoiser import DenoisingNetwork
    from msmd_tpu_torch.models.diffusion import batch1_sampler_args
    from msmd_tpu_torch.models.layers import init_params
    from msmd_tpu_torch.ops.kernels.decoder import build_vmw

    cfg = MSMDConfig(feature_dim=F, n_heads=H, n_layers=L, mlp_ratio=FF // F, n_motions=N, n_prev_motions=P,
                     n_diff_steps=T)
    dn = init_params(DenoisingNetwork(cfg, dtype=dtype), seed)
    g = torch.Generator().manual_seed(seed + 1)
    rn = lambda *shape: torch.randn(*shape, generator=g)
    with torch.no_grad():
        for name, p in dn.named_parameters():
            if name.endswith("bias"):
                p.copy_(rn(*p.shape) * 0.1)
    dn = dn.to(dev).to(dtype)
    D, E = cfg.motion_feat_dim, 2
    stacks = dict(n_entries=E, coefficients=(1.0 - CFG_SCALE, CFG_SCALE),
                  person_in=rn(E, 1, cfg.shape_feat_dim + cfg.d_style).to(dev),
                  style_in=rn(1, 1, cfg.d_style).expand(E, 1, cfg.d_style).to(dev),
                  prev_motion_in=rn(1, P, D).expand(E, P, D).to(dev), indicator_in=None)
    with torch.no_grad():
        memory_kv = dn.cache_memory_kv(rn(E, P, F).to(dev), rn(E, N, F).to(dev))
        a = batch1_sampler_args(dn, cfg, dtype, stacks, memory_kv, N)
        const = dict(a["const"], vmw=build_vmw(a["vmem"], a["pack"]["wco"], 1 + P + N, out_dtype=torch.float32))
    ts = torch.arange(T, 0, -1, device=dev)
    motion_T = rn(N, D).to(dev)
    z = (rn(T, N, D).to(dev) * (ts > 1).float()[:, None, None]).contiguous()
    emb, sc = a["emb_table"][ts][:, None].contiguous(), a["sc_tab"][ts][:, None].contiguous()
    scan = (a["pack"], a["kmem"], a["vmem"], motion_T, emb, sc, z, const)
    step = (a["pack"], a["kmem"], a["vmem"], motion_T, emb[-1], sc[-1], z[-1], a["const"])
    return scan, step, a["kw"]


def sampler_work(args, kw, step: bool = False):
    """(flops, bytes) of one call of the sampler scan (``step`` False: all
    T steps of ``args``) or of one sampler step. Bytes count each input
    read once and the output written once."""
    pack, kmem, vmem, motion, emb, sc, z, const = args
    E, N, D, K, H = kw["n_entries"], kw["n_cur"], kw["d_motion"], kw["num_basis"], kw["n_heads"]
    T = 1 if step else z.shape[0]
    L, F, FF = pack["wqkv"].shape[0], pack["wso"].shape[-1], pack["wf1"].shape[-1]
    Fd, Din = const["wd1"].shape[-1], const["wfp"].shape[0]
    lq = const["pe_flat"].shape[0] // E
    R, lm, dh = E * lq, lq - 1, F // H
    per_layer = (2 * R * F * 3 * F + 2 * R * F * F + 2 * R * F * FF * 2  # QKV, self-out, FFN
                 + 2 * 2 * E * H * lq * lq * dh  # per-entry self-attention
                 + 2 * E * F * F + 2 * 2 * E * H * lm * dh  # person rows: wcq, attention
                 + 2 * (R if step else E) * F * F)  # wco: every row (K4) or the person rows (K3)
    per_step = L * per_layer + 2 * lm * Din * F + 2 * E * N * F * Fd + 2 * E * N * Fd * (D + K)
    tensors = list(pack.values()) + list(const.values()) + [kmem, vmem, motion, emb, sc, z]
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + motion.numel() * 4
    return T * per_step, nbytes


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
    """(blend flops, skinning flops, bytes) of one call of the skinning
    kernel: the blend product once (the kernel's three TF32 products are
    its way of doing it at f32 accuracy), the function's inputs read once
    and its output written once."""
    N, KB, V = betas_ext.shape[0], betas_ext.shape[1], fused.n_verts
    blend = N * V * 3 * 2 * KB  # 3 coordinates x KB multiply-adds
    skin = N * V * 5 * (3 * 7 + 3 * 2)  # 5 joints x 3 rows x (3 multiply-adds + 1 add) + 3 weighted sums
    nbytes = 4 * (N * KB + N * 60 + 3 * KB * V + 3 * V + 5 * V + N * V * 3)
    return blend, skin, nbytes


def lbs_bound(blend: int, skin: int, nbytes: int):
    """K5's bound at f32 accuracy: (ms, what bounds it) of the larger of
    three TF32 products of the blend on the tensor cores, the skinning on
    the f32 CUDA cores and the bytes; and the bound of the whole function on
    the f32 CUDA cores."""
    times = {"operations": max(3 * blend / TF32_PEAK, skin / F32_PEAK), "bytes": nbytes / HBM_RATE}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, bound(blend + skin, nbytes, F32_PEAK)[0]


LBS_BWD_FRAMES = 1760  # clip 1's predicted frames a train step decodes: batch 16 x (10 + 100)


def lbs_bwd_case(dev, N=LBS_BWD_FRAMES, V=5023, seed=SEED):
    """Seeded inputs of K5 bwd: (fused, betas_ext, rt, planes (3, N, Vp), g
    (N, V, 3)), g a seeded cotangent of the vertices."""
    from msmd_tpu_torch.ops.kernels.lbs import posed_planes

    fused, (betas_ext, rt) = lbs_case(dev, N=N, V=V, seed=seed)
    g = torch.randn(N, V, 3, generator=torch.Generator().manual_seed(seed + 5)).to(dev)
    return fused, betas_ext, rt, posed_planes(fused, betas_ext), g


def lbs_bwd_work(fused, N: int):
    """(flops, bytes) of one call of K5 bwd: g, the planes, rt and the
    weights read once, dv and d_rt written once; per vertex and joint 3
    products g w_j, and per row d 3 multiply-adds into dR, 1 add into dt and
    3 multiply-adds into dv."""
    V, vp = fused.n_verts, fused.vp
    flops = N * V * 5 * (3 + 3 * (2 * 3 + 1 + 2 * 3))
    nbytes = 4 * (N * V * 3 + 3 * N * vp + N * 60 + 5 * vp + 3 * N * vp + N * 60)
    return flops, nbytes


def lbs_bwd_bound(fused, N: int):
    """K5 bwd's bound: (ms, what bounds it), f32 on the CUDA cores."""
    return bound(*lbs_bwd_work(fused, N), F32_PEAK)


def ffn_train_case(dev, rows=1776, F=512, FF=2048, p=0.1, seed=SEED):
    """Seeded K7 inputs: ((x, w1, b1, w2, b2, g, b, seed, p), gbar) with
    bf16 activations and weights in the nn.Linear layout, f32 LayerNorm
    parameters and a (1,) int32 seed on ``dev``."""
    from msmd_tpu_torch.ops.kernels.ffn_train import seed_tensor

    g = torch.Generator().manual_seed(seed + 10)
    rn = lambda *shape: torch.randn(*shape, generator=g)
    bf = lambda t: t.to(dev, torch.bfloat16).contiguous()
    f32 = lambda t: t.to(dev, torch.float32).contiguous()
    args = (bf(rn(rows, F)), bf(rn(FF, F) / F ** 0.5), bf(rn(FF) * 0.1), bf(rn(F, FF) / FF ** 0.5),
            bf(rn(F) * 0.1), f32(1.0 + 0.1 * rn(F)), f32(0.1 * rn(F)), seed_tensor(seed + 1234, dev), p)
    return args, bf(rn(rows, F))


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


def generate(model, style, fused, audio, reps, generator, dev, dynamic_threshold=(0, 1, 4)):
    """``infer_coeffs``, then every window's frames through the FLAME
    kernel (expression and head pose from the motion, zero shape, as
    ``bench.py`` decodes). Returns (coeffs, vertices)."""
    from msmd_tpu_torch.inference_lib import infer_coeffs

    cfg = model.cfg
    coeffs = infer_coeffs(model, audio, torch.zeros(1, 100), style_feats=style, n_repetitions=reps,
                          cfg_scale=CFG_SCALE, dynamic_threshold=dynamic_threshold, generator=generator, device=dev)
    verts = [decode_vertices(fused, coeffs[:, w0:w0 + cfg.n_motions])
             for w0 in range(0, coeffs.shape[1], cfg.n_motions)]
    return coeffs, torch.cat(verts, dim=0)


def decode_vertices(fused, motion):
    """One window's frames (B, L, 67) through the FLAME kernel: expression
    and head pose from the motion, zero shape, as ``bench.py`` decodes.
    Returns (B * L, V, 3)."""
    from msmd_tpu_torch.ops.kernels.lbs import flame_vertices

    m = motion.reshape(-1, motion.shape[-1]).float()
    pose6 = torch.cat([m[:, -3:], torch.zeros_like(m[:, :3])], dim=-1)
    return flame_vertices(fused, torch.zeros(m.shape[0], 100, device=m.device), m[:, :50], pose6)


def ffn_train_chain(x, w1, b1, w2, b2, g, b, p):
    """The unfused torch-op chain of K7's forward (F.linear, gelu,
    dropout, layer_norm): a reference time beside the kernel, used nowhere
    in the port."""
    import torch.nn.functional as F

    h = F.dropout(F.gelu(F.linear(x, w1, b1)), p)
    y = F.dropout(F.linear(h, w2, b2), p)
    return F.layer_norm(x + y, (x.shape[-1],), g.to(x.dtype), b.to(x.dtype))


VERTEX_TRAIN = dict(dataset_type="HDTF_TFHP", use_vertex_space=True, rot_repr="aa", two_clip_batch=True)


def flame_coef_stats(seed=SEED) -> dict:
    """Seeded denormalisation statistics in the FLAME layout (shape 100,
    exp 50, pose 6), as NumPy: the real ones come with a dataset."""
    rs = np.random.RandomState(seed + 9)
    out = {}
    for k, n, s in (("shape", 100, 0.3), ("exp", 50, 0.3), ("pose", 6, 0.1)):
        out[f"{k}_mean"] = (rs.randn(n) * 0.1 * s).astype(np.float32)
        out[f"{k}_std"] = (s * (0.5 + rs.rand(n))).astype(np.float32)
    return out


def build_train_path(dev, fused_ffn_train: bool = True, cfg_kw=None, audio_kw=None, seed=SEED, vertex=False):
    """The slice's training configuration: the default MSMD (8 x 512
    denoiser, HuBERT-base encoder, VAE2 style encoder) at bf16 over f32
    parameters, batch 16, ``fused_ffn_train``, seeded random weights, the
    audio encoder's freezing policy, Adam, and the two generators. The
    rate is constant (``warm_iter`` 0): the default warm-up starts at
    rate 0, and a few steps should move every trainable parameter. With
    ``vertex`` the HDTF vertex-space loss (``VERTEX_TRAIN``: the HDTF
    layout, axis-angle pose, ``two_clip_batch``) over a ``FusedFlame`` of
    ``synthetic_flame(5023)`` with ``flame_coef_stats``; the style
    encoder reads the 67-wide motion, as the trainer builds it.
    Returns dict(cfg, model, style_enc, opt, generator, host_generator,
    flame, coef_stats)."""
    from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
    from msmd_tpu_torch.models.diffusion import get_diffusion_model
    from msmd_tpu_torch.models.flame import synthetic_flame
    from msmd_tpu_torch.models.layers import init_params
    from msmd_tpu_torch.models.style_encoder import get_style_encoder
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame
    from msmd_tpu_torch.train.loop import TrainOptimizer, freeze

    kw = dict(batch_size=TRAIN_BATCH, fused_ffn_train=fused_ffn_train, warm_iter=0, use_indicator=True,
              use_cross_style=True, seed=seed, **(VERTEX_TRAIN if vertex else {}))
    kw.update(cfg_kw or {})
    cfg = MSMDConfig(**kw)
    model = get_diffusion_model(cfg, audio_config=AudioEncoderConfig(**(audio_kw or {})), dtype=torch.bfloat16,
                                device=dev, seed=seed)
    style_enc = init_params(get_style_encoder(cfg, dtype=torch.bfloat16, input_dim=cfg.motion_feat_dim),
                            seed + 1).to(dev)
    freeze(cfg, model)
    opt = TrainOptimizer(cfg, list(model.parameters()) + list(style_enc.parameters()))
    flame = coef_stats = None
    if vertex:
        flame = FusedFlame(synthetic_flame(n_verts=5023, seed=seed, device=dev))
        coef_stats = {k: torch.as_tensor(v, device=dev) for k, v in flame_coef_stats(seed).items()}
    return dict(cfg=cfg, model=model, style_enc=style_enc, opt=opt,
                generator=torch.Generator(device=dev).manual_seed(seed + 1),
                host_generator=torch.Generator().manual_seed(seed + 2), flame=flame, coef_stats=coef_stats)


def build_trainer(dev, exp_dir, layout=None, batch_size: int = TRAIN_BATCH, seed=SEED, **cfg_kw):
    """A ``Trainer`` of ``build_train_path(..., vertex=True)``'s configuration
    (the default MSMD at bf16 over f32 parameters, HuBERT-base, the HDTF
    vertex-space loss over a ``FusedFlame`` of ``synthetic_flame(5023)``,
    ``two_clip_batch`` and ``fused_ffn_train``, constant rate) on
    ``layout`` (``parallel.mesh``; default one process). ``cfg_kw``
    overrides the configuration (``tp_size``, ``compute_dtype``)."""
    from msmd_tpu_torch.config import MSMDConfig
    from msmd_tpu_torch.models.flame import synthetic_flame
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame
    from msmd_tpu_torch.train.trainer import Trainer

    kw = dict(batch_size=batch_size, fused_ffn_train=True, warm_iter=0, use_indicator=True, use_cross_style=True,
              seed=seed, **VERTEX_TRAIN)
    kw.update(cfg_kw)
    flame = FusedFlame(synthetic_flame(n_verts=5023, seed=seed, device=dev))
    return Trainer(MSMDConfig(**kw), exp_dir, device=dev, flame=flame, coef_stats=flame_coef_stats(seed),
                   layout=layout)


def train_batch(cfg, dev, batch_size: int = TRAIN_BATCH, seed: int = SEED + 20):
    """Two adjacent clips of seeded z-scored audio (n_motions / fps seconds
    each) and seeded 67-dim motion, zero shape: a loader batch on ``dev``."""
    rs = np.random.RandomState(seed)
    L = cfg.n_audio_samples
    audio = [np.stack([seeded_audio(L / 16000, seed + 2 * b + i) for b in range(batch_size)]) for i in range(2)]
    motion = [rs.randn(batch_size, cfg.n_motions, cfg.motion_feat_dim).astype(np.float32) for _ in range(2)]
    shape = np.zeros((batch_size, cfg.n_motions, cfg.shape_feat_dim), np.float32)
    t = lambda a: torch.as_tensor(a).to(dev)
    return {"audio_0": t(audio[0]), "audio_1": t(audio[1]), "motion_0": t(motion[0]), "motion_1": t(motion[1]),
            "shape_0": t(shape), "shape_1": t(shape)}


def run_train_steps(path: dict, batch, steps: int):
    """``steps`` train steps on the same batch; returns the losses (device
    scalars)."""
    from msmd_tpu_torch.train.loop import train_step

    return [train_step(path["cfg"], path["model"], path["style_enc"], path["opt"], batch, path["generator"],
                       path["host_generator"], path.get("flame"), path.get("coef_stats"))["loss"]
            for _ in range(steps)]


# ---------------------------------------------------------------------------
# the guided window's layer kernels: K6, K8, K9
# ---------------------------------------------------------------------------

def _seeded(seed):
    g = torch.Generator().manual_seed(seed)
    return lambda *shape: torch.randn(*shape, generator=g)


def ffn_case(dev, rows=96 * 111, F=512, FF=2048, seed=SEED):
    """Seeded K6 inputs (x, w1, b1, w2, b2, g, b): bf16 activations and
    weights in the nn.Linear layout, f32 LayerNorm parameters."""
    rn = _seeded(seed + 30)
    bf = lambda t: t.to(dev, torch.bfloat16).contiguous()
    f32 = lambda t: t.to(dev, torch.float32).contiguous()
    return (bf(rn(rows, F)), bf(rn(FF, F) / F ** 0.5), bf(rn(FF) * 0.1), bf(rn(F, FF) / FF ** 0.5),
            bf(rn(F) * 0.1), f32(1.0 + 0.1 * rn(F)), f32(0.1 * rn(F)))


def ffn_chain(x, w1, b1, w2, b2, g, b):
    """The unfused torch-op chain of K6 (F.linear, tanh gelu, F.linear,
    layer_norm): a reference time beside the kernel, used nowhere in the
    port."""
    import torch.nn.functional as F

    y = F.linear(F.gelu(F.linear(x, w1, b1), approximate="tanh"), w2, b2)
    return F.layer_norm(x + y, (x.shape[-1],), g.to(x.dtype), b.to(x.dtype))


def attn_case(dev, B=96, lq=111, F=512, H=8, seed=SEED, dtype=torch.bfloat16):
    """Seeded K8 inputs (q, k, v, H): the three column slices of one
    (B, lq, 3F) projection in ``dtype``, as the fused q/k/v product gives
    them."""
    rn = _seeded(seed + 31)
    qkv = (rn(B, lq, 3 * F) * torch.tensor([1.5, 1.5, 1.0]).repeat_interleave(F)).to(dev, dtype)
    q, k, v = qkv.split(F, dim=-1)
    return q, k, v, H


def sdpa_call(q, k, v, H):
    """``scaled_dot_product_attention`` on the same inputs in its head-major
    layout, made once: (call, heads). A reference time beside K8, used
    nowhere in the port."""
    import torch.nn.functional as F

    B, lq, D = q.shape
    heads = [t.reshape(B, lq, H, D // H).transpose(1, 2).contiguous() for t in (q, k, v)]
    return (lambda: F.scaled_dot_product_attention(*heads)), heads


def tail_case(dev, Be=96, lm=110, F=512, FF=2048, seed=SEED):
    """Seeded K9 inputs (sa_m, x_m, v_rows, wso, bso, wco, bco, w1, b1, w2,
    b2, ln_scale, ln_bias): bf16 activations and weights in the nn.Linear
    layout, (3, F) f32 LayerNorm parameters."""
    rn = _seeded(seed + 32)
    bf = lambda t: t.to(dev, torch.bfloat16).contiguous()
    f32 = lambda t: t.to(dev, torch.float32).contiguous()
    return (bf(rn(Be, lm, F)), bf(rn(Be, lm, F)), bf(rn(Be * lm, F)),
            bf(rn(F, F) / F ** 0.5), bf(rn(F) * 0.1), bf(rn(F, F) / F ** 0.5), bf(rn(F) * 0.1),
            bf(rn(FF, F) / F ** 0.5), bf(rn(FF) * 0.1), bf(rn(F, FF) / FF ** 0.5), bf(rn(F) * 0.1),
            f32(1.0 + 0.1 * rn(3, F)), f32(0.1 * rn(3, F)))


def tail_chain(sa_m, x_m, v_rows, wso, bso, wco, bco, w1, b1, w2, b2, ln_scale, ln_bias):
    """The unfused torch-op chain of K9 (out-projection, layer_norm, the
    cross out-projection, layer_norm, F.linear, erf gelu, F.linear,
    layer_norm): a reference time beside the kernel, used nowhere in the
    port."""
    import torch.nn.functional as F

    n, dt = (x_m.shape[-1],), x_m.dtype
    s, b = ln_scale.to(dt), ln_bias.to(dt)
    x1 = F.layer_norm(x_m + F.linear(sa_m, wso, bso), n, s[0], b[0])
    x2 = F.layer_norm(x1 + F.linear(v_rows, wco, bco).reshape(x_m.shape), n, s[1], b[1])
    return F.layer_norm(x2 + F.linear(F.gelu(F.linear(x2, w1, b1)), w2, b2), n, s[2], b[2])


# ---------------------------------------------------------------------------
# the guided window: sample_with_guide at batch 48
# ---------------------------------------------------------------------------

GUIDE_EVERY = 10  # keyframes at frames 0, 10, ..., 90 of a 100-frame window


def guided_inputs(cfg, dev, batch: int = BATCH, seed: int = SEED + 40) -> dict:
    """Seeded inputs of one guided window: 4 s of z-scored audio per stream
    (raw, so the window runs HuBERT), zero shape, x_T and the per-step
    noise made on the card, and keyframes at every ``GUIDE_EVERY``-th frame
    with seeded values."""
    n, D, T = cfg.n_motions, cfg.motion_feat_dim, cfg.n_diff_steps
    audio = np.stack([seeded_audio(n / cfg.fps, seed + i) for i in range(batch)])
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.arange(0, n, GUIDE_EVERY)
    vals = np.random.RandomState(seed).randn(len(idx), D).astype(np.float32)
    return dict(audio_or_feat=torch.as_tensor(audio, device=dev), shape_feat=torch.zeros(batch, 100, device=dev),
                motion_at_T=torch.randn(batch, n, D, generator=g, device=dev),
                noise_override=torch.randn(T, batch, n, D, generator=g, device=dev),
                guidance_indice=idx.to(dev), guidance_values=torch.as_tensor(vals, device=dev))


def run_guided(model, style, inputs: dict, dev, **route):
    """``sample_with_guide`` on ``inputs`` at cfg_scale 1.15 with the
    dynamic threshold (0, 1, 4); ``route``: ``attn_kernel``, ``fused_tail``.
    Returns x_0 (B, n_motions, D)."""
    from msmd_tpu_torch.models.diffusion import sample_with_guide

    B = inputs["shape_feat"].shape[0]
    style_b = style.reshape(1, -1).expand(B, -1)
    out, _, _ = sample_with_guide(model, style_feat=style_b, cfg_scale=CFG_SCALE, dynamic_threshold=(0, 1, 4),
                                  device=dev, **inputs, **route)
    return out
