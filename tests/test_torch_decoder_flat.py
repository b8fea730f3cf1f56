"""K1's flat-mask mode: the port's plain version equals the JAX Pallas
kernel ``fused_decoder_forward`` with a self mask (interpret mode), and
``sample`` takes that mode where the JAX sampler does.

- The masks: ``build_masks`` and the person mask equal the JAX package's
  bit for bit.
- The decoder stack, Be = 4 entries of lq = 16 rows: the width-1 identity
  band (tiles of 2 and 4 entries, the person mask and the hoisted vmw),
  width 0 (block mask only) and width 3 (block mask plus the alignment
  band), each at f32 (atol 1e-5) and with bf16 packs (max |err| / max
  |reference| <= 2e-2: both sides round every product's operands to bf16
  at the same points, only the f32 summation order differs).
- ``sample`` of a bf16 model with ``align_mask_width=0`` at batch 1 (two
  CFG entries, Be = 2): both packages take the flat-mask decoder kernel
  with the full masked cross-attention (spies on both), from the same
  weights, inputs and noise; the tolerance of ``test_torch_sample.py``'s
  bf16 case (mean error over mean |reference| <= 1.5e-2, max over max
  <= 3e-2).

The CUDA kernel is held against this plain version on the card
(``chip_smoke.py`` phase 3 and ``tests/test_torch_cuda.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.ops import seq as jseq
from msmd_tpu.ops.pallas import decoder_kernel as jdk
from msmd_tpu_torch.ops import seq as tseq
from msmd_tpu_torch.ops.kernels import decoder as tdk

from test_torch_common import build_decoder_pair, build_msmd_pair, counting_spy, rel_err

Be, N_PREV, N_CUR, F, H, L, FFN = 4, 7, 8, 32, 4, 2, 64
LQ, LM = 1 + N_PREV + N_CUR, N_PREV + N_CUR


def _align(width):
    return None if width == 0 else np.asarray(jseq.alignment_mask(N_PREV, N_CUR, width))


@pytest.mark.parametrize("tile,width", [(2, 1), (4, 1), (4, 0), (2, 3)])
def test_masks_match_jax(tile, width):
    jsm, jcm = jdk.build_masks(tile, LQ, LM, _align(width) if width != 1 else None)
    talign = tseq.alignment_mask(N_PREV, N_CUR, width) if width > 1 else None
    sm, cm = tdk.build_masks(tile, LQ, LM, talign)
    np.testing.assert_array_equal(sm.numpy(), np.asarray(jsm))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    pm = jdk.build_identity_band_aux(tile, LQ, LM)[0]
    np.testing.assert_array_equal(tdk.build_person_mask(tile, LM).numpy(), np.asarray(pm))


def _jax_flat(v, jkv, x, jdt, tile, width):
    pack = jdk.pack_decoder_weights(v["params"], L, dtype=jdt)
    km, vm = jdk.pack_memory_kv(jkv, dtype=jdt)
    if width == 1:
        sm = jdk.build_masks(tile, LQ, LM, None)[0]
        aux = jdk.build_identity_band_aux(tile, LQ, LM, dtype=jdt)
        vmw = jdk.build_vmw(aux[3], vm, pack["wco"], Be // tile, out_dtype=jdt)
        out = jdk.fused_decoder_forward(pack, km, vm, jnp.asarray(x), sm, aux, n_heads=H, tile_entries=tile,
                                        interpret=True, vmw=vmw)
    else:
        sm, cm = jdk.build_masks(tile, LQ, LM, _align(width))
        out = jdk.fused_decoder_forward(pack, km, vm, jnp.asarray(x), sm, cm, n_heads=H, tile_entries=tile,
                                        interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile,width", [(2, 1), (4, 1), (4, 0), (2, 3)])
def test_flat_plain_matches_pallas_kernel(dtype, tile, width):
    jdec, v, tdec, x, jkv, tkv = build_decoder_pair("float32", Be=Be, lq=LQ, F=F, H=H, L=L, FFN=FFN,
                                                    seed=20 + tile + 3 * width)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = _jax_flat(v, jkv, x, jdt, tile, width)

    with torch.no_grad():
        pack = tdk.pack_decoder_weights(tdec, dtype=tdt)
        kmem, vmem = tdk.pack_memory_kv(tkv, dtype=tdt)
        if width == 1:
            sm = tdk.build_masks(tile, LQ, LM)[0]
            aux, vmw, cm = tdk.person_rows(Be, LQ), tdk.build_vmw(vmem, pack["wco"], LQ, out_dtype=tdt), \
                tdk.build_person_mask(tile, LM)
        else:
            talign = tseq.alignment_mask(N_PREV, N_CUR, width) if width else None
            (sm, cm), aux, vmw = tdk.build_masks(tile, LQ, LM, talign), None, None
        before = tdk.fused_decoder_forward_flat.launches
        got = tdk.fused_decoder_forward(pack, kmem, vmem, torch.as_tensor(x), aux, H, vmw, self_mask=sm,
                                        cross_mask=cm, tile_entries=tile)
    assert tdk.fused_decoder_forward_flat.launches == before  # the plain version is no launch
    assert got.dtype == torch.float32 and got.shape == (Be, LQ, F)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    else:
        assert rel_err(got.numpy(), want) <= 2e-2


def test_flat_identity_band_equals_per_entry_mode():
    """At width 1 the flat mode's block-diagonal masks leave exactly the
    per-entry mode's attention (masked scores exp to 0): the two plain
    modes agree to f32 summation order."""
    _, _, tdec, x, _, tkv = build_decoder_pair("float32", Be=Be, lq=LQ, F=F, H=H, L=L, FFN=FFN, seed=31)
    with torch.no_grad():
        pack = tdk.pack_decoder_weights(tdec, dtype=torch.float32)
        kmem, vmem = tdk.pack_memory_kv(tkv, dtype=torch.float32)
        vmw, aux = tdk.build_vmw(vmem, pack["wco"], LQ, out_dtype=torch.float32), tdk.person_rows(Be, LQ)
        per_entry = tdk.fused_decoder_forward(pack, kmem, vmem, torch.as_tensor(x), aux, H, vmw)
        flat = tdk.fused_decoder_forward(pack, kmem, vmem, torch.as_tensor(x), aux, H, vmw,
                                         self_mask=tdk.build_masks(2, LQ, LM)[0],
                                         cross_mask=tdk.build_person_mask(2, LM), tile_entries=2)
    np.testing.assert_allclose(flat.numpy(), per_entry.numpy(), atol=1e-5, rtol=1e-5)


def test_sample_without_alignment_mask_matches_jax(monkeypatch):
    from msmd_tpu.models.diffusion import sample as jsample
    from msmd_tpu_torch.models.diffusion import sample

    counts = {}
    counting_spy(monkeypatch, jdk, "fused_decoder_forward", counts, "jax")
    counting_spy(monkeypatch, tdk, "fused_decoder_forward_flat", counts, "flat")
    counting_spy(monkeypatch, tdk, "fused_decoder_forward", counts, "k1")
    jm, jv, tm, kw = build_msmd_pair("bfloat16", seed=41, batch=1, align_mask_width=0)
    rs = np.random.RandomState(42)
    n, T = kw["n_motions"], kw["n_diff_steps"]
    feat = rs.randn(1, n, kw["feature_dim"]).astype(np.float32)
    shape = (rs.randn(1, 100) * 0.3).astype(np.float32)
    style = rs.randn(1, kw["d_style"]).astype(np.float32)
    mT, nz = rs.randn(1, n, 67).astype(np.float32), rs.randn(T, 1, n, 67).astype(np.float32)
    jax.clear_caches()
    want, _, _ = jsample(jm, jv, jax.random.PRNGKey(0), *map(jnp.asarray, (feat, shape, style)),
                         motion_at_T=jnp.asarray(mT), noise_override=jnp.asarray(nz))
    want = np.asarray(want).astype(np.float32)
    got, _, _ = sample(tm, feat, shape, style, motion_at_T=mT, noise_override=nz, device="cpu")
    assert counts["jax"] >= 1  # traced into JAX's decoder kernel (flat: Be = 2 <= 4)
    assert counts["flat"] == counts["k1"] == T  # every step through the flat mode
    err = np.abs(got.numpy() - want)
    assert err.mean() / np.abs(want).mean() <= 1.5e-2, err.mean()
    assert err.max() / np.abs(want).max() <= 3e-2, err.max()
