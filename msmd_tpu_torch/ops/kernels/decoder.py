"""The decoder stack of one DDPM sampler step: a hand-written CUDA kernel
family (``csrc/decoder.cu``), its plain PyTorch version, and the packing
helpers.

Replaces ``msmd_tpu/ops/pallas/decoder_kernel.py::fused_decoder_forward``
in its production mode: per-entry self-attention, identity-band
cross-attention (only the person row of each entry attends the cached
memory K/V; the motion rows take the hoisted, projected V-gather
``vmw``), FFN and three post-LNs, for all L layers. Both versions
compute what ``_layer_compute`` computes and round where it rounds:

- every product casts its left operand to the weights' dtype (bf16)
  and accumulates in f32; biases are added in f32; ``x`` stays f32;
- q is scaled in f32, then cast; the unnormalised ``exp`` scores are
  cast to bf16 before the PV product; the person rows are read from a
  bf16 copy of ``x`` and their projected cross output is cast to bf16;
- at bf16 the softmax is the "fast" form ``exp(clamp(s - 20, -80, 60))``
  normalised after the PV product, and GELU is the tanh form; at f32
  (the plain version only) the softmax subtracts the max and GELU is erf.

Layouts are the JAX package's: weights (L, in, out), memory K/V
(L, Be*lm, F) batch-major with head-contiguous columns, entries
entry-major in Be.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch

from msmd_tpu_torch import _build


# ---------------------------------------------------------------------------
# packing helpers (once per sampling window)
# ---------------------------------------------------------------------------

def pack_decoder_weights(transformer, dtype=torch.bfloat16) -> dict:
    """Stack a ``TransformerDecoder``'s per-layer parameters into (L, ...)
    arrays in the JAX layout (in, out). LayerNorm parameters stay f32."""
    layers = transformer.layers

    def stack(fn):
        return torch.stack([fn(l) for l in layers])

    kern = lambda d: d.weight.t()
    pack = {
        "wqkv": stack(lambda l: torch.cat([kern(l.self_attn.q_proj), kern(l.self_attn.k_proj), kern(l.self_attn.v_proj)], 1)),
        "bqkv": stack(lambda l: torch.cat([l.self_attn.q_proj.bias, l.self_attn.k_proj.bias, l.self_attn.v_proj.bias]))[:, None, :],
        "wso": stack(lambda l: kern(l.self_attn.out_proj)),
        "bso": stack(lambda l: l.self_attn.out_proj.bias)[:, None, :],
        "wcq": stack(lambda l: kern(l.cross_attn.q_proj)),
        "bcq": stack(lambda l: l.cross_attn.q_proj.bias)[:, None, :],
        "wco": stack(lambda l: kern(l.cross_attn.out_proj)),
        "bco": stack(lambda l: l.cross_attn.out_proj.bias)[:, None, :],
        "wf1": stack(lambda l: kern(l.ffn.linear1)),
        "bf1": stack(lambda l: l.ffn.linear1.bias)[:, None, :],
        "wf2": stack(lambda l: kern(l.ffn.linear2)),
        "bf2": stack(lambda l: l.ffn.linear2.bias)[:, None, :],
        "ln_scale": stack(lambda l: torch.stack([l.norm1.weight, l.norm2.weight, l.norm3.weight])),
        "ln_bias": stack(lambda l: torch.stack([l.norm1.bias, l.norm2.bias, l.norm3.bias])),
    }
    return {k: v.detach().to(torch.float32 if k.startswith("ln") else dtype).contiguous()
            for k, v in pack.items()}


def pack_memory_kv(memory_kv: List[Tuple[torch.Tensor, torch.Tensor]], dtype=torch.bfloat16):
    """Per-layer [(k, v)], each (B, Lm, H, Dh) -> two (L, B*Lm, H*Dh)."""
    ks, vs = [], []
    for k, v in memory_kv:
        B, Lm, H, Dh = k.shape
        ks.append(k.reshape(B * Lm, H * Dh))
        vs.append(v.reshape(B * Lm, H * Dh))
    return torch.stack(ks).to(dtype).contiguous(), torch.stack(vs).to(dtype).contiguous()


def person_rows(n_entries: int, lq: int, device=None) -> torch.Tensor:
    """Row of each entry's person token in the flattened (Be*lq, F)
    activations: row e*lq. The kernel gathers the person rows by it."""
    return (torch.arange(n_entries, dtype=torch.int32, device=device) * lq).contiguous()


def build_vmw(vmem: torch.Tensor, wco: torch.Tensor, lq: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The hoisted, projected identity-band V-gather ``(sel_vm @ vm) @ wco``
    (``decoder_kernel.py::build_vmw``): motion row e*lq + 1 + i takes
    memory row e*lm + i projected by ``wco``; person rows are 0. Both
    factors are constant over a sampling window. vmem (L, Be*lm, F),
    wco (L, F, F) -> (L, Be*lq, F) in ``out_dtype``."""
    L, Mtot, F = vmem.shape
    lm = lq - 1
    Be = Mtot // lm
    proj = torch.bmm(vmem.float(), wco.float()).reshape(L, Be, lm, F)
    out = torch.zeros(L, Be, lq, F, dtype=torch.float32, device=vmem.device)
    out[:, :, 1:] = proj
    return out.reshape(L, Be * lq, F).to(out_dtype).contiguous()


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def fused_decoder_forward_plain(pack, kmem, vmem, x, aux, n_heads: int, vmw) -> torch.Tensor:
    """The decoder stack in plain PyTorch with the kernel's rounding
    points and formula choices. x (Be, lq, F) -> (Be, lq, F) float32."""
    Be, lq, F = x.shape
    L = pack["wqkv"].shape[0]
    H, dh = n_heads, F // n_heads
    lm = lq - 1
    cdt = pack["wqkv"].dtype
    fast = cdt == torch.bfloat16
    scale = 1.0 / math.sqrt(dh)
    rnd = lambda a: a.to(cdt).float()  # the left-operand cast of every product
    dot = lambda a, w: rnd(a) @ w.float()
    rows = aux.long()

    def attend(q, k, v, mask_neg=None):
        # q (.., Lq, dh), k/v (.., Lk, dh), all f32; returns f32 (.., Lq, dh)
        s = rnd(q) @ rnd(k).transpose(-1, -2)
        if fast:
            e = torch.exp(torch.clamp(s - 20.0, -80.0, 60.0))
            return (rnd(e) @ rnd(v)) * torch.reciprocal(e.sum(dim=-1, keepdim=True))
        return torch.softmax(s, dim=-1) @ v

    x = x.float().reshape(Be * lq, F)
    for l in range(L):
        ln_s, ln_b = pack["ln_scale"][l].float(), pack["ln_bias"][l].float()
        qkv = dot(x, pack["wqkv"][l]) + pack["bqkv"][l].float()
        heads = lambda t: t.reshape(Be, lq, H, dh).transpose(1, 2)
        q, k, v = heads(qkv[:, :F] * scale), heads(qkv[:, F:2 * F]), heads(qkv[:, 2 * F:])
        sa = attend(q, k, v).transpose(1, 2).reshape(Be * lq, F)
        sa = dot(sa, pack["wso"][l]) + pack["bso"][l].float()
        x = _layernorm(x + sa, ln_s[0], ln_b[0])

        xp = rnd(x[rows])  # person rows, read through the bf16 copy of x
        qp = dot(xp, pack["wcq"][l]) + pack["bcq"][l].float()
        qh = (qp * scale).reshape(Be, H, 1, dh)
        km = kmem[l].float().reshape(Be, lm, H, dh).transpose(1, 2)
        vm = vmem[l].float().reshape(Be, lm, H, dh).transpose(1, 2)
        person = attend(qh, km, vm).reshape(Be, F)
        po = dot(person, pack["wco"][l])
        ca = vmw[l].float().clone()
        ca[rows] = ca[rows] + rnd(po)
        ca = ca + pack["bco"][l].float()
        x = _layernorm(x + ca, ln_s[1], ln_b[1])

        h1 = dot(x, pack["wf1"][l]) + pack["bf1"][l].float()
        h1 = gelu_tanh(h1) if fast else torch.nn.functional.gelu(h1)
        ff = dot(h1, pack["wf2"][l]) + pack["bf2"][l].float()
        x = _layernorm(x + ff, ln_s[2], ln_b[2])
    return x.reshape(Be, lq, F)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

_PACK_KEYS = ("wqkv", "bqkv", "wso", "bso", "wcq", "bcq", "wco", "bco",
              "wf1", "bf1", "wf2", "bf2", "ln_scale", "ln_bias")


def _lib():
    lib = _build.load("decoder")
    if not getattr(lib, "_msmd_typed", False):
        lib.msmd_decoder_forward.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.msmd_decoder_forward.restype = ctypes.c_int
        lib.msmd_decoder_workspace_bytes.argtypes = [ctypes.c_int] * 4
        lib.msmd_decoder_workspace_bytes.restype = ctypes.c_size_t
        lib._msmd_typed = True
    return lib


def _check_inputs(pack, kmem, vmem, x, aux, n_heads, vmw):
    Be, lq, F = x.shape
    L = pack["wqkv"].shape[0]
    FF = pack["wf1"].shape[-1]
    lm = lq - 1
    want = {
        "wqkv": (L, F, 3 * F), "bqkv": (L, 1, 3 * F), "wso": (L, F, F), "bso": (L, 1, F),
        "wcq": (L, F, F), "bcq": (L, 1, F), "wco": (L, F, F), "bco": (L, 1, F),
        "wf1": (L, F, FF), "bf1": (L, 1, FF), "wf2": (L, FF, F), "bf2": (L, 1, F),
        "ln_scale": (L, 3, F), "ln_bias": (L, 3, F),
    }
    named = {k: pack[k] for k in _PACK_KEYS}
    named.update(kmem=kmem, vmem=vmem, x=x, aux=aux, vmw=vmw)
    want.update(kmem=(L, Be * lm, F), vmem=(L, Be * lm, F), x=(Be, lq, F), aux=(Be,), vmw=(L, Be * lq, F))
    for name, t in named.items():
        dtype = (torch.float32 if name in ("x", "ln_scale", "ln_bias")
                 else torch.int32 if name == "aux" else torch.bfloat16)
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"fused_decoder_forward: {name} must be on {x.device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"fused_decoder_forward: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_decoder_forward: {name} has shape {tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"fused_decoder_forward: {name} must be contiguous")
    if F // n_heads != 64 or F % n_heads or F % 128 or FF % 128:
        raise ValueError(f"fused_decoder_forward: kernel needs head dim 64 and F, FFN multiples of 128 (F={F}, H={n_heads}, FFN={FF})")
    if not 2 <= lq <= 128:
        raise ValueError(f"fused_decoder_forward: kernel needs 2 <= lq <= 128, got {lq}")


def fused_decoder_forward(pack: dict, kmem: torch.Tensor, vmem: torch.Tensor, x: torch.Tensor,
                          aux: torch.Tensor, n_heads: int, vmw: torch.Tensor) -> torch.Tensor:
    """All decoder layers of one sampler step, per-entry identity-band
    mode. x (Be, lq, F) f32 -> (Be, lq, F) f32.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel (bf16 pack, head dim 64) or raises: there is no fallback."""
    if x.device.type == "cpu":
        return fused_decoder_forward_plain(pack, kmem, vmem, x, aux, n_heads, vmw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decoder_forward: unsupported device {x.device}")
    _check_inputs(pack, kmem, vmem, x, aux, n_heads, vmw)
    Be, lq, F = x.shape
    L, FF = pack["wqkv"].shape[0], pack["wf1"].shape[-1]
    lib = _lib()
    out = torch.empty_like(x)
    ws = torch.empty(lib.msmd_decoder_workspace_bytes(Be, lq, F, FF), dtype=torch.uint8, device=x.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = lib.msmd_decoder_forward(
        ptr(x), ptr(out), ptr(ws), *(ptr(pack[k]) for k in _PACK_KEYS),
        ptr(kmem), ptr(vmem), ptr(vmw), ptr(aux),
        Be, lq, F, n_heads, L, FF,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(lib, rc, "fused_decoder_forward")
    fused_decoder_forward.launches += 1
    return out


fused_decoder_forward.launches = 0
