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
K1's own device functions; so it computes K1's numbers. The plain version
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
        lib.msmd_decoder_forward_resident.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.msmd_decoder_forward_resident.restype = ctypes.c_int
        lib.msmd_resident_workspace_bytes.argtypes = [ctypes.c_int] * 4
        lib.msmd_resident_workspace_bytes.restype = ctypes.c_size_t
        lib.msmd_resident_grid.argtypes = [ctypes.c_int] * 2
        lib.msmd_resident_grid.restype = ctypes.c_int
        lib._msmd_typed = True
    return lib


def resident_grid(lq: int, n_heads: int) -> int:
    """Blocks of K2's cooperative launch on the current card (all
    resident at once)."""
    lib = _lib()
    g = lib.msmd_resident_grid(lq, n_heads)
    _build.check(lib, -g if g < 0 else 0, "resident_grid")
    return g


def fused_decoder_forward_resident(pack: dict, kmem: torch.Tensor, vmem: torch.Tensor, x: torch.Tensor,
                                   aux: torch.Tensor, n_heads: int, vmw: torch.Tensor) -> torch.Tensor:
    """All decoder layers of one sampler step, per-entry identity-band mode,
    layer-outer. The arguments are ``fused_decoder_forward``'s per-entry
    ones. x (Be, lq, F) f32 -> (Be, lq, F) f32.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    cooperative kernel (bf16 pack, head dim 64) or raises."""
    if _build.on_cpu("fused_decoder_forward_resident", x):
        return fused_decoder_forward_resident_plain(pack, kmem, vmem, x, aux, n_heads, vmw)
    Be, lq, F = x.shape
    L, FF = pack["wqkv"].shape[0], pack["wf1"].shape[-1]
    check_decoder_inputs("fused_decoder_forward_resident", pack, kmem, vmem, x, n_heads,
                         aux=(aux, (Be,), torch.int32), vmw=(vmw, (L, Be * lq, F), torch.bfloat16))
    lib = _lib()
    out, ws, head = _launch_args(pack, kmem, vmem, x, lib.msmd_resident_workspace_bytes(Be, lq, F, FF))
    rc = lib.msmd_decoder_forward_resident(*head, _build.ptr(vmw), _build.ptr(aux), Be, lq, F, n_heads, L, FF,
                                           _build.stream(x.device))
    _build.check(lib, rc, "fused_decoder_forward_resident")
    fused_decoder_forward_resident.launches += 1
    return out


fused_decoder_forward_resident.launches = 0
