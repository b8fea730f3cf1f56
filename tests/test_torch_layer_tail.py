"""K9 (``fused_layer_tail``): the port's plain version against the JAX
Pallas kernel in interpret mode, and the decoder with ``fused_tail``
against the JAX decoder's.

- ``layer_tail_plain`` at Be in {2, 8}: f32 atol 5e-5 (as
  ``tests/test_ffn_kernel.py`` holds the JAX kernel); bf16 (every product's
  left operand bf16, x1 and x2 f32 between the stages, erf GELU, as
  ``_tail_kernel`` rounds; other f32 summation orders) max |err| / max |ref|
  <= 1e-2.
- ``TransformerDecoder(fused_tail=True)`` with the identity band and a
  memory K/V cache: f32 atol 1e-5, bf16 max |err| / max |ref| <= 2e-2 over
  two layers; a spy shows that the JAX side ran its kernel (and the port
  its K9 wrapper) in every layer.

The CUDA kernel is held against this plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.ops.pallas import layer_tail_kernel as jtail
from msmd_tpu_torch.models import transformer as ttr
from msmd_tpu_torch.ops.kernels import layer_tail as ttail

from test_torch_common import build_decoder_pair, counting_spy, rel_err

LM, F, FFN = 15, 64, 128


@pytest.mark.parametrize("Be", [2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype, Be):
    rs = np.random.RandomState(Be + 20)
    sa, x = rs.randn(Be, LM, F).astype(np.float32), rs.randn(Be, LM, F).astype(np.float32)
    vrows = rs.randn(Be * LM, F).astype(np.float32)
    shapes = ((F, F), (F,), (F, F), (F,), (F, FFN), (FFN,), (FFN, F), (F,))  # JAX layout (in, out)
    ws = [(rs.randn(*s) / np.sqrt(s[0]) if len(s) == 2 else rs.randn(*s) * 0.1).astype(np.float32) for s in shapes]
    ln_s, ln_b = (1.0 + 0.1 * rs.randn(3, F)).astype(np.float32), (0.1 * rs.randn(3, F)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert jtail.tail_rows_tile(Be * LM)
    want = jtail.fused_layer_tail(*(jnp.asarray(a).astype(jdt) for a in [sa, x, vrows] + ws), jnp.asarray(ln_s),
                                  jnp.asarray(ln_b), interpret=True)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(tdt)
    got = ttail.fused_layer_tail(t(sa), t(x), t(vrows), *(t(w.T if w.ndim == 2 else w) for w in ws),
                                 torch.as_tensor(ln_s), torch.as_tensor(ln_b))
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == want.shape == (Be, LM, F)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    else:
        assert rel_err(got.float(), want) <= 1e-2


@pytest.mark.parametrize("Be", [2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_with_fused_tail_matches_jax(monkeypatch, dtype, Be):
    from msmd_tpu.ops.pallas import layer_tail_kernel

    calls = {}
    counting_spy(monkeypatch, layer_tail_kernel, "fused_layer_tail", calls, "jax")
    counting_spy(monkeypatch, ttr, "fused_layer_tail", calls, "port")
    jdec, v, tdec, x, jkv, tkv = build_decoder_pair(dtype, Be=Be, FFN=FFN, seed=13 + Be)
    want = jdec.apply(v, jnp.asarray(x), None, None, True, memory_kv=jkv, cross_identity_band=True,
                      fused_tail=True)
    with torch.no_grad():
        got = tdec(torch.as_tensor(x), memory_kv=tkv, cross_identity_band=True, fused_tail=True)
    assert calls == {"jax": 2, "port": 2}
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    else:
        assert rel_err(got.float(), want) <= 2e-2
