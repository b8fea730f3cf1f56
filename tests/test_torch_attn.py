"""K8 (``attention_middle``): the port's plain version against the JAX
Pallas kernel in interpret mode, and the decoder with ``attn_kernel``
against the JAX decoder under ``MSMD_ATTN_KERNEL=1``.

- ``attention_middle_plain`` at B in {2, 8}, and at B = 8 over the lq
  edges of the CUDA kernel's 16-row tiles (1, 15, 16, 17, 64, 111, 128):
  f32 atol 1e-5; bf16 (q scaled
  in f32 then cast, exact max-subtracting softmax, P cast before P v, as
  ``_attn_mid_kernel`` rounds; other f32 summation orders) max |err| /
  max |ref| <= 1e-2.
- ``TransformerDecoder(attn_kernel=True)``: f32 atol 1e-5, bf16 max |err| /
  max |ref| <= 2e-2 over two layers. At lq = 16 every entry count forms an
  8-aligned row tile, so the JAX gate ``attn_middle_viable`` opens; a spy
  shows that JAX ran its kernel (and the port its K8 wrapper) in every
  layer.

The CUDA kernel is held against this plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.ops.pallas import attn_kernel as jattn
from msmd_tpu_torch.models import transformer as ttr
from msmd_tpu_torch.ops.kernels import attn as tattn

from test_torch_common import build_decoder_pair, counting_spy, rel_err

LQ, F, H = 16, 64, 4


@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype, B):
    rs = np.random.RandomState(B)
    q, k, v = (rs.randn(B, LQ, F).astype(np.float32) * s for s in (2.0, 2.0, 1.0))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert jattn.attn_middle_viable(B, LQ, F, H)
    want = jattn.attention_middle(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), n_heads=H, interpret=True)
    got = tattn.attention_middle(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)), H)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == want.shape == (B, LQ, F)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        assert rel_err(got.float(), want) <= 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq", [1, 15, 16, 17, 64, 111, 128])
def test_plain_matches_pallas_kernel_at_lq_edges(lq, dtype):
    """The lq edges of the CUDA kernel's 16-row warp tiles (one row, one
    short of a tile, whole tiles, one past) and the guided lq 111, each
    a shape JAX's gate ``attn_middle_viable`` opens at B = 8; the same
    bounds as above."""
    B = 8
    rs = np.random.RandomState(100 + lq)
    q, k, v = (rs.randn(B, lq, F).astype(np.float32) * s for s in (2.0, 2.0, 1.0))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert jattn.attn_middle_viable(B, lq, F, H)
    want = jattn.attention_middle(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), n_heads=H, interpret=True)
    got = tattn.attention_middle(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)), H)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == want.shape == (B, lq, F)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        assert rel_err(got.float(), want) <= 1e-2


def test_plain_takes_column_slices_of_one_projection():
    """q, k, v as the three column slices of one (B, lq, 3F) product, as the
    fused q/k/v projection gives them, equal the same tensors made
    contiguous."""
    qkv = torch.randn(3, LQ, 3 * F)
    q, k, v = qkv.split(F, dim=-1)
    torch.testing.assert_close(tattn.attention_middle(q, k, v, H),
                               tattn.attention_middle(q.contiguous(), k.contiguous(), v.contiguous(), H),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_with_attn_kernel_matches_jax(monkeypatch, dtype):
    from msmd_tpu.ops.pallas import attn_kernel

    monkeypatch.setenv("MSMD_ATTN_KERNEL", "1")
    calls = {}
    counting_spy(monkeypatch, attn_kernel, "attention_middle", calls, "jax")
    counting_spy(monkeypatch, ttr, "attention_middle", calls, "port")
    jdec, v, tdec, x, jkv, tkv = build_decoder_pair(dtype, Be=8, seed=12)
    want = jdec.apply(v, jnp.asarray(x), None, None, True, memory_kv=jkv, cross_identity_band=True)
    with torch.no_grad():
        got = tdec(torch.as_tensor(x), memory_kv=tkv, cross_identity_band=True, attn_kernel=True)
    assert calls == {"jax": 2, "port": 2}
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    else:
        assert rel_err(got.float(), want) <= 2e-2
