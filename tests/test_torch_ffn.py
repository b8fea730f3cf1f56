"""K6 (``fused_ffn_ln``): the port's plain version against the JAX Pallas
kernel in interpret mode, and the decoder with ``fused_ffn`` against the
JAX decoder's.

- ``ffn_ln_plain`` at f32 (erf GELU): atol 1e-5; at bf16 (tanh GELU, bf16
  operands at the same points, other f32 summation orders): max |err| /
  max |ref| <= 1e-2; at a row count that is one JAX row tile (48) and one
  that is five (1040 = 5 x 208).
- ``TransformerDecoder(fused_ffn=True)``: f32 atol 1e-5, bf16 max |err| /
  max |ref| <= 2e-2 over two layers; a spy shows that the JAX side ran
  its kernel (and the port its K6 wrapper) in every layer.

The CUDA kernel is held against this plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.ops.pallas import ffn_kernel as jffn
from msmd_tpu_torch.models import transformer as ttr
from msmd_tpu_torch.ops.kernels import ffn as tffn

from test_torch_common import build_decoder_pair, counting_spy, rel_err

F, FFN = 64, 256


def _inputs(rows, dtype, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, F).astype(np.float32)
    w1 = (rs.randn(F, FFN) / np.sqrt(F)).astype(np.float32)  # JAX layout (in, out)
    w2 = (rs.randn(FFN, F) / np.sqrt(FFN)).astype(np.float32)
    b1, b2 = (rs.randn(FFN) * 0.1).astype(np.float32), (rs.randn(F) * 0.1).astype(np.float32)
    g, b = (1.0 + 0.1 * rs.randn(F)).astype(np.float32), (0.1 * rs.randn(F)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jffn.fused_ffn_ln(*(jnp.asarray(a).astype(jdt) for a in (x, w1, b1, w2, b2)), jnp.asarray(g),
                             jnp.asarray(b), interpret=True)
    t = lambda a: torch.as_tensor(a).to(tdt)
    got = tffn.fused_ffn_ln(t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2), torch.as_tensor(g),
                            torch.as_tensor(b))
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("rows", [48, 1040])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype, rows):
    assert jffn._pick_tile(rows) == (48 if rows == 48 else 208)
    got, want = _inputs(rows, dtype, seed=rows)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert got.shape == want.shape == (rows, F)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        assert rel_err(got.float(), want) <= 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_with_fused_ffn_matches_jax(monkeypatch, dtype):
    from msmd_tpu.ops.pallas import ffn_kernel

    calls = {}
    counting_spy(monkeypatch, ffn_kernel, "fused_ffn_ln", calls, "jax")
    counting_spy(monkeypatch, ttr, "fused_ffn_ln", calls, "port")
    jdec, v, tdec, x, jkv, tkv = build_decoder_pair(dtype, Be=8, seed=11)
    want = jdec.apply(v, jnp.asarray(x), None, None, True, memory_kv=jkv, cross_identity_band=True,
                      fused_ffn=True)
    with torch.no_grad():
        got = tdec(torch.as_tensor(x), memory_kv=tkv, cross_identity_band=True, fused_ffn=True)
    assert calls == {"jax": 2, "port": 2}
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    else:
        assert got.dtype == torch.bfloat16
        assert rel_err(got.float(), want) <= 2e-2
