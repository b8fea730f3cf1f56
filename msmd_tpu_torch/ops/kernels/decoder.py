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

The flat-mask mode (``fused_decoder_forward`` with ``self_mask``; the JAX
kernel's ``_layer_compute`` with a self mask, ``decoder_kernel.py``
:392-400 and :459-467) cuts the batch into tiles of ``tile_entries``
whole entries and runs each attention over all of a tile's rows with an
additive f32 mask from ``build_masks`` (``NEG`` where a query may not
look): the self-attention over the tile's flattened rows, and either the
identity-band cross (width 1: the person rows through the person mask,
the motion rows through ``vmw``) or, at ``align_mask_width != 1``, the
full masked cross-attention of every row. In the bf16 softmax the mask
is added before the ``_clamp_unmasked`` floor test (scores at or below
``MASK_FLOOR`` are not clamped, so their ``exp`` is exactly 0). On the
card the flat-mask mode is, below the Hopper GEMM's 1024 rows, one
cooperative launch of the persistent small-row stack
(``csrc/decoder_small.cuh``, plan in ``ops/kernels/small_stack.py``) and,
from there on (``small_stack.flat_uses_chain``), a chain of launches whose
four large products run on the Hopper GEMM as K1 per-entry's do.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.utils.profiling import count


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


NEG = -1e30  # the additive mask value (decoder_kernel.py:44)
MASK_FLOOR = -1e29  # scores at or below are structural masks (decoder_kernel.py:151)


def build_masks(tile: int, lq: int, lm: int, alignment_bool=None, device=None):
    """Additive f32 masks over one tile's flattened rows, as
    ``decoder_kernel.py::build_masks`` builds them: the self mask
    (tile*lq, tile*lq) is block-diagonal (entry isolation); the cross mask
    (tile*lq, tile*lm) is block-diagonal plus, where given, the
    alignment band (bool (lq, lm), True = disallowed) tiled over all
    blocks (NEG + NEG stays an effective -inf)."""
    eye = np.eye(tile, dtype=np.float32)
    self_mask = (1.0 - np.kron(eye, np.ones((lq, lq), np.float32))) * NEG
    cross_mask = (1.0 - np.kron(eye, np.ones((lq, lm), np.float32))) * NEG
    if alignment_bool is not None:
        align = np.where(np.asarray(alignment_bool), np.float32(NEG), np.float32(0.0))
        cross_mask = cross_mask + np.tile(align, (tile, tile))
    return (torch.as_tensor(self_mask.astype(np.float32), device=device),
            torch.as_tensor(cross_mask.astype(np.float32), device=device))


def build_person_mask(tile: int, lm: int, device=None) -> torch.Tensor:
    """The identity band's person mask (tile, tile*lm) f32: the person
    row of entry e may attend only its own entry's memory block
    (``build_identity_band_aux``'s ``person_mask``)."""
    eye = np.eye(tile, dtype=np.float32)
    return torch.as_tensor(((1.0 - np.kron(eye, np.ones((1, lm), np.float32))) * NEG).astype(np.float32),
                           device=device)


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


def decoder_layers_plain(pack, kmem, vmem, x, aux, n_heads: int, vmw, cross: str = "bf16",
                         self_mask=None, cross_mask=None, tile: int = 0) -> torch.Tensor:
    """The decoder stack in plain PyTorch with the kernels' rounding points
    and formula choices. x (Be, lq, F) -> (Be, lq, F) float32.

    ``cross`` is where the identity-band cross output is rounded, as in
    ``csrc/decoder_small.cuh::SmallMode``: "bf16" (K1) adds bf16(person
    output @ wco) to a bf16 ``vmw``; "f32" (K3) keeps both in f32; "gather"
    (K4) takes [bf16(person output) | memory V rows] @ wco over all rows
    and reads no ``vmw``.

    Flat-mask mode (``self_mask`` given, tiles of ``tile`` entries, 0 =
    all): the self-attention runs over each tile's flattened rows with
    ``self_mask``; with ``vmw`` the person rows attend the tile's memory
    through the person mask ``cross_mask`` (tile, tile*lm), without it
    every row attends through ``cross_mask`` (tile*lq, tile*lm) and the
    result goes through wco (the full masked cross)."""
    Be, lq, F = x.shape
    L = pack["wqkv"].shape[0]
    H, dh = n_heads, F // n_heads
    lm = lq - 1
    flat = self_mask is not None
    T = tile or Be
    nt = Be // T
    cdt = pack["wqkv"].dtype
    fast = cdt == torch.bfloat16
    scale = 1.0 / math.sqrt(dh)
    rnd = lambda a: a.to(cdt).float()  # the left-operand cast of every product
    dot = lambda a, w: rnd(a) @ w.float()

    def attend(q, k, v, mask=None):
        # q (.., Lq, dh), k/v (.., Lk, dh), all f32; mask (Lq, Lk) additive;
        # returns f32 (.., Lq, dh)
        s = rnd(q) @ rnd(k).transpose(-1, -2)
        if mask is not None:
            s = s + mask.float()
        if fast:
            sh = s - 20.0
            e = torch.exp(torch.where(sh > MASK_FLOOR, torch.clamp(sh, -80.0, 60.0), sh))
            return (rnd(e) @ rnd(v)) * torch.reciprocal(e.sum(dim=-1, keepdim=True))
        return torch.softmax(s, dim=-1) @ v

    def tiles(t, rows):  # (nt * rows, F) -> (nt, H, rows, dh)
        return t.reshape(nt, rows, H, dh).transpose(1, 2)

    def untile(t):  # (nt, H, rows, dh) -> (nt * rows, F)
        return t.transpose(1, 2).reshape(-1, F)

    x = x.float().reshape(Be * lq, F)
    for l in range(L):
        ln_s, ln_b = pack["ln_scale"][l].float(), pack["ln_bias"][l].float()
        qkv = dot(x, pack["wqkv"][l]) + pack["bqkv"][l].float()
        q, k, v = qkv[:, :F] * scale, qkv[:, F:2 * F], qkv[:, 2 * F:]
        if flat:
            sa = untile(attend(tiles(q, T * lq), tiles(k, T * lq), tiles(v, T * lq), self_mask))
        else:
            heads = lambda t: t.reshape(Be, lq, H, dh).transpose(1, 2)
            sa = attend(heads(q), heads(k), heads(v)).transpose(1, 2).reshape(Be * lq, F)
        sa = dot(sa, pack["wso"][l]) + pack["bso"][l].float()
        x = _layernorm(x + sa, ln_s[0], ln_b[0])

        km, vm = kmem[l].float(), vmem[l].float()
        if flat and vmw is None:  # full masked cross-attention of every row
            qc = (dot(x, pack["wcq"][l]) + pack["bcq"][l].float()) * scale
            ca = untile(attend(tiles(qc, T * lq), tiles(km, T * lm), tiles(vm, T * lm), cross_mask))
            ca = dot(ca, pack["wco"][l]) + pack["bco"][l].float()
            x = _layernorm(x + ca, ln_s[1], ln_b[1])
        else:
            rows = aux.long()
            xp = rnd(x[rows])  # person rows, read through the bf16 copy of x
            qp = (dot(xp, pack["wcq"][l]) + pack["bcq"][l].float()) * scale
            if flat:  # the tile's person rows against its memory, person-masked
                person = untile(attend(tiles(qp, T), tiles(km, T * lm), tiles(vm, T * lm), cross_mask))
            else:
                kh = km.reshape(Be, lm, H, dh).transpose(1, 2)
                vh = vm.reshape(Be, lm, H, dh).transpose(1, 2)
                person = attend(qp.reshape(Be, H, 1, dh), kh, vh).reshape(Be, F)
            if cross == "gather":
                ca = torch.empty(Be, lq, F, dtype=torch.float32, device=x.device)
                ca[:, 0] = rnd(person)
                ca[:, 1:] = vm.reshape(Be, lm, F)
                ca = dot(ca.reshape(Be * lq, F), pack["wco"][l]) + pack["bco"][l].float()
            else:
                po = dot(person, pack["wco"][l])
                ca = vmw[l].float().clone()
                ca[rows] = ca[rows] + (rnd(po) if cross == "bf16" else po)
                ca = ca + pack["bco"][l].float()
            x = _layernorm(x + ca, ln_s[1], ln_b[1])

        h1 = dot(x, pack["wf1"][l]) + pack["bf1"][l].float()
        h1 = gelu_tanh(h1) if fast else torch.nn.functional.gelu(h1)
        ff = dot(h1, pack["wf2"][l]) + pack["bf2"][l].float()
        x = _layernorm(x + ff, ln_s[2], ln_b[2])
    return x.reshape(Be, lq, F)


def fused_decoder_forward_plain(pack, kmem, vmem, x, aux, n_heads: int, vmw, self_mask=None, cross_mask=None,
                                tile_entries: int = 0) -> torch.Tensor:
    """K1 in plain PyTorch: ``decoder_layers_plain`` with the bf16 cross
    output, per-entry or (``self_mask`` given) flat-mask mode. x (Be, lq,
    F) -> (Be, lq, F) float32."""
    return decoder_layers_plain(pack, kmem, vmem, x, aux, n_heads, vmw, cross="bf16", self_mask=self_mask,
                                cross_mask=cross_mask, tile=tile_entries)


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------

_PACK_KEYS = ("wqkv", "bqkv", "wso", "bso", "wcq", "bcq", "wco", "bco",
              "wf1", "bf1", "wf2", "bf2", "ln_scale", "ln_bias")


def _lib():
    lib = _build.load("decoder")
    if not getattr(lib, "_msmd_typed", False):
        lib.msmd_decoder_forward.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.msmd_decoder_forward.restype = ctypes.c_int
        lib.msmd_decoder_forward_flat.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 8
                                                  + [ctypes.c_void_p] * 2)
        lib.msmd_decoder_forward_flat.restype = ctypes.c_int
        lib.msmd_flat_workspace_bytes.argtypes = [ctypes.c_int] * 8
        lib.msmd_flat_workspace_bytes.restype = ctypes.c_size_t
        lib.msmd_flat_plan.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.msmd_flat_plan.restype = ctypes.c_int
        lib.msmd_flat_uses_chain.argtypes = [ctypes.c_int] * 4
        lib.msmd_flat_uses_chain.restype = ctypes.c_int
        lib.msmd_decoder_workspace_bytes.argtypes = [ctypes.c_int] * 4
        lib.msmd_decoder_workspace_bytes.restype = ctypes.c_size_t
        lib._msmd_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def cluster_products(Be: int, lq: int, F: int, FF: int, L: int, full_cross: bool = False) -> int:
    """How many products of one K1 call run on the warp-specialised Hopper
    GEMM (``csrc/gemm_sm90.cuh``, two-CTA clusters for the LayerNorm
    ones): of QKV, self-out, FFN1 and FFN2 (and the full masked cross's q
    and out products with ``full_cross``) those it takes, times L. 4 L at
    the batch-48 rows, 0 below ``gemm.MIN_ROWS``."""
    from msmd_tpu_torch.ops.kernels.gemm import hopper_takes

    R = Be * lq
    shapes = [(R, 3 * F, F, "bf16"), (R, F, F, "resid_ln"), (R, FF, F, "gelu"), (R, F, FF, "resid_ln")]
    if full_cross:
        shapes += [(R, F, F, "bf16"), (R, F, F, "resid_ln")]
    return L * sum(hopper_takes(*shape) for shape in shapes)


def check_decoder_inputs(name: str, pack, kmem, vmem, x, n_heads, **extra):
    """Raise unless the pack, the memory K/V and x have the shapes, types
    and layout the decoder kernels take (bf16 pack, head dim 64, F and
    FFN multiples of 128, 2 <= lq <= 128), nor each of ``extra``'s
    ``name=(tensor, shape, dtype)``."""
    Be, lq, F = x.shape
    L = pack["wqkv"].shape[0]
    FF = pack["wf1"].shape[-1]
    lm = lq - 1
    bf, f32 = torch.bfloat16, torch.float32
    want = {
        "wqkv": (L, F, 3 * F), "bqkv": (L, 1, 3 * F), "wso": (L, F, F), "bso": (L, 1, F),
        "wcq": (L, F, F), "bcq": (L, 1, F), "wco": (L, F, F), "bco": (L, 1, F),
        "wf1": (L, F, FF), "bf1": (L, 1, FF), "wf2": (L, FF, F), "bf2": (L, 1, F),
        "ln_scale": (L, 3, F), "ln_bias": (L, 3, F),
    }
    named = {k: (pack[k], want[k], f32 if k.startswith("ln") else bf) for k in _PACK_KEYS}
    named.update(kmem=(kmem, (L, Be * lm, F), bf), vmem=(vmem, (L, Be * lm, F), bf), x=(x, (Be, lq, F), f32))
    named.update(extra)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be on a CUDA device, got {x.device}")
    _build.check_args(name, x.device, **named)
    if F // n_heads != 64 or F % n_heads or F % 128 or FF % 128:
        raise ValueError(f"{name}: kernel needs head dim 64 and F, FFN multiples of 128 (F={F}, H={n_heads}, FFN={FF})")
    if not 2 <= lq <= 128:
        raise ValueError(f"{name}: kernel needs 2 <= lq <= 128, got {lq}")


def _launch_args(pack, kmem, vmem, x, ws_bytes):
    """(out, workspace, the leading pointer arguments of every entry point)."""
    out = torch.empty_like(x)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    ptr = _build.ptr
    return out, ws, [ptr(x), ptr(out), ptr(ws), *(ptr(pack[k]) for k in _PACK_KEYS), ptr(kmem), ptr(vmem)]


def fused_decoder_forward(pack: dict, kmem: torch.Tensor, vmem: torch.Tensor, x: torch.Tensor,
                          aux: Optional[torch.Tensor], n_heads: int, vmw: Optional[torch.Tensor],
                          self_mask: Optional[torch.Tensor] = None, cross_mask: Optional[torch.Tensor] = None,
                          tile_entries: int = 0) -> torch.Tensor:
    """All decoder layers of one sampler step. x (Be, lq, F) f32 -> (Be,
    lq, F) f32. Without ``self_mask``: the per-entry identity-band mode
    (aux the person rows, vmw the hoisted projected V-gather). With it:
    the flat-mask mode, ``fused_decoder_forward_flat``.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel (bf16 pack, head dim 64) or raises: there is no fallback."""
    if self_mask is not None:
        return fused_decoder_forward_flat(pack, kmem, vmem, x, aux, n_heads, vmw, self_mask, cross_mask,
                                          tile_entries)
    if _build.on_cpu("fused_decoder_forward", x):
        return fused_decoder_forward_plain(pack, kmem, vmem, x, aux, n_heads, vmw)
    Be, lq, F = x.shape
    L, FF = pack["wqkv"].shape[0], pack["wf1"].shape[-1]
    check_decoder_inputs("fused_decoder_forward", pack, kmem, vmem, x, n_heads,
                         aux=(aux, (Be,), torch.int32), vmw=(vmw, (L, Be * lq, F), torch.bfloat16))
    lib = _lib()
    out, ws, head = _launch_args(pack, kmem, vmem, x, lib.msmd_decoder_workspace_bytes(Be, lq, F, FF))
    rc = lib.msmd_decoder_forward(*head, _build.ptr(vmw), _build.ptr(aux), Be, lq, F, n_heads, L, FF,
                                  _build.stream(x.device))
    _build.check(lib, rc, "fused_decoder_forward")
    fused_decoder_forward.launches += 1
    count("msmd.k1.cluster_products", cluster_products(Be, lq, F, FF, L))
    return out


fused_decoder_forward.launches = 0


def flat_plan(Be: int, lq: int, F: int, H: int, L: int, FF: int, tile: int, band: bool) -> dict:
    """The flat mode's small-stack plan on the current card
    (``msmd_flat_plan``) as ``small_stack.c_plan_rows`` gives it; refused
    where the shapes take the chain (``small_stack.flat_uses_chain``)."""
    from msmd_tpu_torch.ops.kernels.small_stack import c_plan_rows

    lib = _lib()
    out = (ctypes.c_long * (4 + 7 * (1 + 11 * L)))()
    _build.check(lib, lib.msmd_flat_plan(Be, lq, F, H, L, FF, tile, int(band), 0, out), "msmd_flat_plan")
    return c_plan_rows(out)


def fused_decoder_forward_flat(pack: dict, kmem: torch.Tensor, vmem: torch.Tensor, x: torch.Tensor,
                               aux: Optional[torch.Tensor], n_heads: int, vmw: Optional[torch.Tensor],
                               self_mask: torch.Tensor, cross_mask: torch.Tensor,
                               tile_entries: int = 0) -> torch.Tensor:
    """K1's flat-mask mode: tiles of ``tile_entries`` whole entries (0 =
    all Be), ``self_mask`` (tile*lq, tile*lq) f32. With ``vmw`` (width
    1): ``aux`` the person rows and ``cross_mask`` the person mask (tile,
    tile*lm); without (aux None): ``cross_mask`` (tile*lq, tile*lm), the
    full masked cross-attention. x (Be, lq, F) f32 -> (Be, lq, F) f32.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises: below the Hopper GEMM's rows one cooperative launch
    of the persistent small-row stack (it raises where the card cannot hold
    its grid: there is no fallback), from there on
    (``small_stack.flat_uses_chain``) a chain of launches whose large
    products run on the Hopper GEMM."""
    if _build.on_cpu("fused_decoder_forward_flat", x):
        return fused_decoder_forward_plain(pack, kmem, vmem, x, aux, n_heads, vmw, self_mask, cross_mask,
                                           tile_entries)
    out = _launch_flat(pack, kmem, vmem, x, aux, n_heads, vmw, self_mask, cross_mask, tile_entries)
    fused_decoder_forward_flat.launches += 1
    Be, lq, F = x.shape
    count("msmd.k1.cluster_products",
          cluster_products(Be, lq, F, pack["wf1"].shape[-1], pack["wqkv"].shape[0], full_cross=vmw is None))
    return out


def flat_stamps(pack, kmem, vmem, x, aux, n_heads, vmw, self_mask, cross_mask, tile_entries=0) -> torch.Tensor:
    """One flat-mode call with the card's clock (ns, int64) recorded by
    block 0 at its start and after each of its 1 + 11 L phases, for the
    per-phase split of ``python -m msmd_tpu_torch.profile``. Not counted as
    a launch of the main path. Only where the small stack runs."""
    from msmd_tpu_torch.ops.kernels.small_stack import flat_uses_chain

    Be, lq, F = x.shape
    if flat_uses_chain(Be, lq, F, pack["wf1"].shape[-1]):
        raise ValueError(f"flat_stamps: at {Be * lq} rows the flat mode runs a chain of launches, which records "
                         "no phases")
    stamps = torch.zeros(2 + 11 * pack["wqkv"].shape[0], dtype=torch.int64, device=x.device)
    _launch_flat(pack, kmem, vmem, x, aux, n_heads, vmw, self_mask, cross_mask, tile_entries, stamps)
    return stamps


def _launch_flat(pack, kmem, vmem, x, aux, n_heads, vmw, self_mask, cross_mask, tile_entries, stamps=None,
                 _grid_blocks=0):
    # _grid_blocks: the cooperative grid (0: every block the card holds at
    # once; more is refused)
    Be, lq, F = x.shape
    L, FF = pack["wqkv"].shape[0], pack["wf1"].shape[-1]
    T = tile_entries or Be
    if Be % T:
        raise ValueError(f"fused_decoder_forward_flat: tile {T} does not divide {Be} entries")
    if T * lq > 128 * 64:
        raise ValueError(f"fused_decoder_forward_flat: a tile of {T} x {lq} rows exceeds 8192")
    if (vmw is None) != (aux is None):
        raise ValueError("fused_decoder_forward_flat: give vmw and aux together (width 1) or neither")
    f32 = torch.float32
    extra = dict(self_mask=(self_mask, (T * lq, T * lq), f32))
    if vmw is not None:
        extra.update(aux=(aux, (Be,), torch.int32), vmw=(vmw, (L, Be * lq, F), torch.bfloat16),
                     cross_mask=(cross_mask, (T, T * (lq - 1)), f32))
    else:
        extra.update(cross_mask=(cross_mask, (T * lq, T * (lq - 1)), f32))
    check_decoder_inputs("fused_decoder_forward_flat", pack, kmem, vmem, x, n_heads, **extra)
    lib = _lib()
    ws_bytes = lib.msmd_flat_workspace_bytes(Be, lq, F, n_heads, FF, T, int(vmw is not None), _grid_blocks)
    if ws_bytes == 0:
        raise RuntimeError(f"fused_decoder_forward_flat: no cooperative grid of {_grid_blocks or 'all'} blocks "
                           "fits on this card")
    out, ws, head = _launch_args(pack, kmem, vmem, x, ws_bytes)
    opt = lambda t: _build.ptr(t) if t is not None else ctypes.c_void_p(None)
    rc = lib.msmd_decoder_forward_flat(*head, opt(vmw), opt(aux), _build.ptr(self_mask), _build.ptr(cross_mask),
                                       Be, lq, F, n_heads, L, FF, T, _grid_blocks, opt(stamps),
                                       _build.stream(x.device))
    _build.check(lib, rc, "fused_decoder_forward_flat")
    return out


fused_decoder_forward_flat.launches = 0
