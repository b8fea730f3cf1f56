"""K2, the layer-outer resident decoder stack: the port's plain version
equals the JAX Pallas kernel ``fused_decoder_forward_resident``
(interpret mode) and the port's K1 per-entry plain version.

Be = 8 entries of lq = 16 rows in tiles of 4 and 8 entries; f32: atol
1e-5; bf16 packs: max |err| / max |reference| <= 2e-2 (the same bf16
rounding points on both sides, other f32 summation orders).

The CUDA kernel is held against this plain version, and against K1's
kernel bit for bit, on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.ops.pallas import decoder_kernel as jdk
from msmd_tpu_torch.ops.kernels import decoder as tdk
from msmd_tpu_torch.ops.kernels import decoder_resident as tdr

from test_torch_common import build_decoder_pair, rel_err

Be, LQ, F, H, L, FFN = 8, 16, 32, 4, 2, 64


def _port_args(tdec, tkv, tdt):
    pack = tdk.pack_decoder_weights(tdec, dtype=tdt)
    kmem, vmem = tdk.pack_memory_kv(tkv, dtype=tdt)
    return pack, kmem, vmem, tdk.person_rows(Be, LQ), tdk.build_vmw(vmem, pack["wco"], LQ, out_dtype=tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [4, 8])
def test_resident_plain_matches_pallas_kernel(dtype, tile):
    _, v, tdec, x, jkv, tkv = build_decoder_pair("float32", Be=Be, lq=LQ, F=F, H=H, L=L, FFN=FFN, seed=60 + tile)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    pack = jdk.pack_decoder_weights(v["params"], L, dtype=jdt)
    km, vm = jdk.pack_memory_kv(jkv, dtype=jdt)
    aux = jdk.build_identity_band_aux(tile, LQ, LQ - 1, dtype=jdt)
    vmw = jdk.build_vmw(aux[3], vm, pack["wco"], Be // tile, out_dtype=jdt)
    want = np.asarray(jdk.fused_decoder_forward_resident(pack, km, vm, jnp.asarray(x), aux, n_heads=H,
                                                         tile_entries=tile, interpret=True, vmw=vmw))
    with torch.no_grad():
        pack_t, kmem, vmem, rows, vmw_t = _port_args(tdec, tkv, tdt)
        before = tdr.fused_decoder_forward_resident.launches
        got = tdr.fused_decoder_forward_resident_plain(pack_t, kmem, vmem, torch.as_tensor(x), rows, H, vmw_t,
                                                       tile_entries=tile)
        via_wrapper = tdr.fused_decoder_forward_resident(pack_t, kmem, vmem, torch.as_tensor(x), rows, H, vmw_t)
    assert tdr.fused_decoder_forward_resident.launches == before  # the plain version is no launch
    assert got.dtype == torch.float32 and got.shape == (Be, LQ, F)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(via_wrapper.numpy(), want, atol=1e-5, rtol=1e-4)
    else:
        assert rel_err(got.numpy(), want) <= 2e-2
        assert rel_err(via_wrapper.numpy(), want) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_plain_matches_k1_per_entry(dtype):
    _, _, tdec, x, _, tkv = build_decoder_pair("float32", Be=Be, lq=LQ, F=F, H=H, L=L, FFN=FFN, seed=70)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    with torch.no_grad():
        args = _port_args(tdec, tkv, tdt)
        pack, kmem, vmem, rows, vmw = args
        k1 = tdk.fused_decoder_forward_plain(pack, kmem, vmem, torch.as_tensor(x), rows, H, vmw)
        k2 = tdr.fused_decoder_forward_resident_plain(pack, kmem, vmem, torch.as_tensor(x), rows, H, vmw,
                                                      tile_entries=4)
    if dtype == "float32":
        np.testing.assert_allclose(k2.numpy(), k1.numpy(), atol=1e-5, rtol=1e-5)
    else:
        assert rel_err(k2.numpy(), k1.numpy()) <= 2e-2


@pytest.mark.parametrize("Be,lq,per_layer", [(96, 111, 9), (10, 111, 9), (9, 111, 11), (6, 111, 11), (8, 16, 11)])
def test_resident_phases_follow_the_product_routes(Be, lq, per_layer):
    """The Python list of K2's phases (one card-clock stamp each) mirrors
    the kernel: the copy of x in, then per layer nine phases where the
    residual products take the Hopper GEMM's LayerNorm epilogues (>= 1024
    rows: LN1 with the motion rows' cross step, LN3) and eleven (a phase
    for each of them) below."""
    from msmd_tpu_torch.ops.kernels.gemm import gemm_plan

    L = 3
    names = tdr.resident_phases(Be, lq, 512, 2048, L)
    assert names[0] == "load" and len(names) == 1 + L * per_layer
    layer = names[1:1 + per_layer]
    assert names[1:] == layer * L
    assert layer[:3] == ["qkv", "self_attention", "self_out"] and "cross_ln" in layer
    assert layer[-3:-1] == ["ffn1", "ffn2"] or layer[-2:] == ["ffn1", "ffn2"]
    hopper = gemm_plan(Be * lq, 512, 2048, "resid_ln")["route"] == "wgmma"
    assert ("ln1" in layer) == ("ln3" in layer) == (not hopper)
