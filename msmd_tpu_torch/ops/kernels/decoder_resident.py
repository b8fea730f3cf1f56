"""K2, the layer-outer activation-resident decoder stack of one DDPM sampler
step: a hand-written cooperative CUDA kernel (``csrc/decoder_resident.cu``)
and its plain PyTorch version.

Replaces ``msmd_tpu/ops/pallas/decoder_kernel.py::
fused_decoder_forward_resident``: K1's per-entry identity-band math
(``ops/kernels/decoder.py``) with the grid turned layer-outer, so that
each layer's weights stream once per step while the batch's activations
stay resident. The JAX sampler takes it under ``MSMD_DECODER_RESIDENT=1``
(per-entry mode, Be > 4, and ``Be*lq*F*4 <= 40 MiB``); the port's
``sample`` takes it with ``resident=True`` under the same gate.

On the card it is one persistent cooperative launch per step that runs
all layers, phase by phase, with grid-wide barriers between phases, from
K1's own device functions; so it computes K1's numbers. Every phase but
the Hopper GEMM's is an out-of-line device function with registers of
its own (``csrc/decoder_resident.cu``). The plain version
is the layer-outer loop over tiles of ``tile_entries`` entries of the
same per-layer math as K1's plain version (``decoder_layers_plain``),
which makes the tile order visible where K1's plain version runs the
whole batch at once.
"""

from __future__ import annotations

import ctypes

import torch

from msmd_tpu_torch import _build
from msmd_tpu_torch.ops.kernels.decoder import _launch_args, check_decoder_inputs, decoder_layers_plain

TILE = 8  # entries per tile of the plain version's inner loop (JAX's MSMD_DECODER_TILE default)


def fused_decoder_forward_resident_plain(pack, kmem, vmem, x, aux, n_heads: int, vmw,
                                         tile_entries: int = TILE) -> torch.Tensor:
    """Layer outer, tiles of ``tile_entries`` entries inner: each layer of
    ``decoder_layers_plain`` (bf16 cross output) on one tile's rows, its
    memory K/V and vmw rows, and its person rows. x (Be, lq, F) -> (Be,
    lq, F) float32."""
    Be, lq, F = x.shape
    L, lm = pack["wqkv"].shape[0], lq - 1
    T = tile_entries if tile_entries and Be % tile_entries == 0 else Be
    x = x.float().clone()
    for l in range(L):
        layer = {k: v[l:l + 1] for k, v in pack.items()}
        for t in range(0, Be, T):
            x[t:t + T] = decoder_layers_plain(
                layer, kmem[l:l + 1, t * lm:(t + T) * lm], vmem[l:l + 1, t * lm:(t + T) * lm], x[t:t + T],
                aux[t:t + T] - aux[t], n_heads, vmw[l:l + 1, t * lq:(t + T) * lq], cross="bf16")
    return x


def _lib():
    lib = _build.load("decoder_resident")
    if not getattr(lib, "_msmd_typed", False):
        lib.msmd_decoder_forward_resident.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 6
                                                      + [ctypes.c_void_p] * 2)
        lib.msmd_decoder_forward_resident.restype = ctypes.c_int
        lib.msmd_resident_workspace_bytes.argtypes = [ctypes.c_int] * 4
        lib.msmd_resident_workspace_bytes.restype = ctypes.c_size_t
        lib.msmd_resident_grid.argtypes = []
        lib.msmd_resident_grid.restype = ctypes.c_int
        lib.msmd_resident_attributes.argtypes = [ctypes.c_void_p]
        lib.msmd_resident_attributes.restype = ctypes.c_int
        lib._msmd_typed = True
    return lib


def resident_grid() -> int:
    """Blocks of K2's cooperative launch on the current card (all
    resident at once: one an SM)."""
    lib = _lib()
    g = lib.msmd_resident_grid()
    _build.check(lib, -g if g < 0 else 0, "resident_grid")
    return g


def resident_attributes() -> dict:
    """The compiled kernel's ``registers`` a thread, ``local_bytes`` a
    thread (stack frame and spills: ``cudaFuncGetAttributes``),
    ``static_smem``, ``dynamic_smem`` and ``threads`` a block, on the
    current card."""
    lib = _lib()
    out = (ctypes.c_long * 5)()
    _build.check(lib, lib.msmd_resident_attributes(out), "resident_attributes")
    return {"registers": int(out[0]), "local_bytes": int(out[1]), "static_smem": int(out[2]),
            "dynamic_smem": int(out[3]), "threads": int(out[4])}



def resident_phases(Be: int, lq: int, F: int, FF: int, L: int) -> list:
    """The phase names of one call, in order, each ending at a grid
    barrier: the copy of x in, then per layer QKV, the self-attention,
    self-out, the person rows' q, their attention, wco, the cross
    LayerNorm, FFN1 and FFN2. Where the Hopper GEMM takes the residual
    products, their epilogues hold LN1 (with the motion rows' cross step
    and its LayerNorm: the cross LayerNorm phase then covers the person
    rows only) and LN3; elsewhere those are phases of their own (``ln1``,
    ``ln3``)."""
    from msmd_tpu_torch.ops.kernels.gemm import gemm_plan

    R = Be * lq
    fused = gemm_plan(R, F, F, "resid_ln")["route"] == "wgmma"
    names = ["load"]
    for _ in range(L):
        names += ["qkv", "self_attention", "self_out"] + ([] if fused else ["ln1"])
        names += ["person_q", "person_attention", "wco", "cross_ln", "ffn1", "ffn2"]
        if gemm_plan(R, F, FF, "resid_ln")["route"] != "wgmma":
            names.append("ln3")
    return names


def fused_decoder_forward_resident(pack: dict, kmem: torch.Tensor, vmem: torch.Tensor, x: torch.Tensor,
                                   aux: torch.Tensor, n_heads: int, vmw: torch.Tensor) -> torch.Tensor:
    """All decoder layers of one sampler step, per-entry identity-band mode,
    layer-outer. The arguments are ``fused_decoder_forward``'s per-entry
    ones. x (Be, lq, F) f32 -> (Be, lq, F) f32.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    cooperative kernel (bf16 pack, head dim 64) or raises."""
    if _build.on_cpu("fused_decoder_forward_resident", x):
        return fused_decoder_forward_resident_plain(pack, kmem, vmem, x, aux, n_heads, vmw)
    out = _launch(pack, kmem, vmem, x, aux, n_heads, vmw)
    fused_decoder_forward_resident.launches += 1
    return out


def _launch(pack, kmem, vmem, x, aux, n_heads, vmw, stamps=None):
    Be, lq, F = x.shape
    L, FF = pack["wqkv"].shape[0], pack["wf1"].shape[-1]
    check_decoder_inputs("fused_decoder_forward_resident", pack, kmem, vmem, x, n_heads,
                         aux=(aux, (Be,), torch.int32), vmw=(vmw, (L, Be * lq, F), torch.bfloat16))
    lib = _lib()
    out, ws, head = _launch_args(pack, kmem, vmem, x, lib.msmd_resident_workspace_bytes(Be, lq, F, FF))
    rc = lib.msmd_decoder_forward_resident(*head, _build.ptr(vmw), _build.ptr(aux), Be, lq, F, n_heads, L, FF,
                                           None if stamps is None else _build.ptr(stamps), _build.stream(x.device))
    _build.check(lib, rc, "fused_decoder_forward_resident")
    return out


def resident_stamps(pack, kmem, vmem, x, aux, n_heads, vmw) -> torch.Tensor:
    """One K2 call with the card's clock (ns, int64) recorded by block 0 at
    its start and after each grid barrier (``resident_phases``), for the
    per-phase split of ``python -m msmd_tpu_torch.profile --resident``.
    Not counted as a launch of the main path."""
    Be, lq, F = x.shape
    L, FF = pack["wqkv"].shape[0], pack["wf1"].shape[-1]
    stamps = torch.zeros(1 + len(resident_phases(Be, lq, F, FF, L)), dtype=torch.int64, device=x.device)
    _launch(pack, kmem, vmem, x, aux, n_heads, vmw, stamps=stamps)
    return stamps


fused_decoder_forward_resident.launches = 0
