"""The decoder kernel's plain version equals the JAX Pallas kernel
``fused_decoder_forward`` (interpret mode) in its production mode:
per-entry self-attention, identity-band cross-attention, hoisted vmw.
f32: atol 1e-5. bf16: max error over max |reference| <= 2e-2 (both sides
round every product's operands to bf16 at the same points; what differs
is only the f32 summation order).

The CUDA kernel itself is held against this plain version on the card
(``chip_smoke.py`` phase 3, and ``tests/test_torch_cuda.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.models import transformer as jtr
from msmd_tpu.ops.pallas import decoder_kernel as jdk
from msmd_tpu_torch.interop import load_flax_params
from msmd_tpu_torch.models import transformer as ttr
from msmd_tpu_torch.ops.kernels import decoder as tdk

from test_torch_common import np_params

Be, LQ, F, H, L, FFN = 8, 16, 32, 4, 2, 64


def _setup(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(Be, LQ, F).astype(np.float32)
    mem = rs.randn(Be, LQ - 1, F).astype(np.float32)
    jdec = jtr.TransformerDecoder(L, F, H, FFN)
    v = jdec.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mem))
    tdec = load_flax_params(ttr.TransformerDecoder(L, F, H, FFN), np_params(v))
    jkv = jdec.apply(v, jnp.asarray(mem), method=jtr.TransformerDecoder.cache_memory)
    return x, mem, v, jkv, tdec


def _jax_forward(v, jkv, x, jdt):
    pack = jdk.pack_decoder_weights(v["params"], L, dtype=jdt)
    km, vm = jdk.pack_memory_kv(jkv, dtype=jdt)
    aux = jdk.build_identity_band_aux(Be, LQ, LQ - 1, dtype=jdt)
    vmw = jdk.build_vmw(aux[3], vm, pack["wco"], 1, out_dtype=jdt)
    out = jdk.fused_decoder_forward(pack, km, vm, jnp.asarray(x), None, aux, n_heads=H, tile_entries=Be,
                                    per_entry_attention=True, interpret=True, vmw=vmw)
    return pack, np.asarray(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype):
    x, mem, v, jkv, tdec = _setup(seed=1 if dtype == "float32" else 2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jpack, want = _jax_forward(v, jkv, x, jdt)

    with torch.no_grad():
        pack = tdk.pack_decoder_weights(tdec, dtype=tdt)
        for k, a in pack.items():
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(jpack[k]).astype(np.float32), err_msg=k)
        kmem, vmem = tdk.pack_memory_kv(tdec.cache_memory(torch.as_tensor(mem)), dtype=tdt)
        vmw = tdk.build_vmw(vmem, pack["wco"], LQ, out_dtype=tdt)
        got = tdk.fused_decoder_forward(pack, kmem, vmem, torch.as_tensor(x), tdk.person_rows(Be, LQ), H, vmw)
    assert got.dtype == torch.float32 and got.shape == (Be, LQ, F)
    got = got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 2e-2, rel


def test_plain_equals_modules_at_f32():
    """At f32 the decoder stack the kernel replaces is the plain module
    stack with the identity band."""
    x, mem, v, jkv, tdec = _setup(seed=3)
    with torch.no_grad():
        kv = tdec.cache_memory(torch.as_tensor(mem))
        want = tdec(torch.as_tensor(x), memory_kv=kv, cross_identity_band=True).numpy()
        pack = tdk.pack_decoder_weights(tdec, dtype=torch.float32)
        kmem, vmem = tdk.pack_memory_kv(kv, dtype=torch.float32)
        vmw = tdk.build_vmw(vmem, pack["wco"], LQ, out_dtype=torch.float32)
        got = tdk.fused_decoder_forward(pack, kmem, vmem, torch.as_tensor(x), tdk.person_rows(Be, LQ), H, vmw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)

