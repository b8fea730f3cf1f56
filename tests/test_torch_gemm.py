"""The launch planning of the decoder's Hopper GEMM and of K8, and the
per-product work counts, on the CPU.

- ``ops/kernels/gemm.gemm_plan`` mirrors ``msmd_gemm_plan``
  (``csrc/decoder.cu``): which products take the Hopper GEMM (by rows, K
  and N), its tile, tiles, persistent grid and shared memory, the wmma
  tile elsewhere, and the shapes neither takes. The card test
  ``test_torch_cuda.py::test_gemm_plan_matches_the_library`` holds the two
  equal on the card.
- ``ops/kernels/attn.attn_plan``: warps, threads, shared memory and grid of
  K8, and its refusals.
- ``measure.decoder_products``: the products of one K1 call sum to the
  GEMM share of ``measure.decoder_work``.
- ``ops/kernels/gemm.gemm`` on CPU tensors takes its plain version, whose
  epilogues are the decoder's.
"""

import math

import pytest
import torch

from msmd_tpu_torch import measure
from msmd_tpu_torch.ops.kernels import attn as k8
from msmd_tpu_torch.ops.kernels import gemm as kg
from msmd_tpu_torch.ops.kernels.decoder import gelu_tanh

SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90


WS_SMEM = 4 * (128 + 256) * 128 + 1024 + 2 * 2 * 128 * 4 + 10 * 8  # the ring, alignment, exchanges, mbarriers
LN_SMEM, CROSS_SMEM = WS_SMEM + 3 * 256 * 4, WS_SMEM + 6 * 256 * 4  # and the LayerNorm products' column tables


@pytest.mark.parametrize("M,N,K,epilogue,route,tile,cluster,clusters,tiles,grid,smem", [
    # K1's four products at batch 48 (R = Be * lq = 96 * 111): 84 row blocks of 128
    (10656, 1536, 512, "bf16", "wgmma", (128, 256), 1, 132, 84 * 6, 132, WS_SMEM),
    (10656, 512, 512, "resid_ln_cross", "wgmma", (128, 256), 2, 66, 2 * 84, 132, CROSS_SMEM),
    (10656, 2048, 512, "gelu", "wgmma", (128, 256), 1, 132, 84 * 8, 132, WS_SMEM),
    (10656, 512, 2048, "resid_ln", "wgmma", (128, 256), 2, 66, 2 * 84, 132, LN_SMEM),
    # the flat chain's self-out and FFN2 (plain LayerNorm) at the same rows
    (10656, 512, 512, "resid_ln", "wgmma", (128, 256), 2, 66, 2 * 84, 132, LN_SMEM),
    # a ragged R (Be = 17): fewer row blocks than cluster slots
    (1887, 512, 2048, "resid_ln", "wgmma", (128, 256), 2, 15, 30, 30, LN_SMEM),
    # below MIN_ROWS (K3 and K4 at 222 rows, K1 flat at 444): the wmma tile
    (1023, 512, 512, "resid_ln", "wmma", (64, 128), 1, 64, 4 * 16, 64, 65536),
    (222, 1536, 512, "bf16", "wmma", (128, 128), 1, 24, 12 * 2, 24, 86016),
    (444, 2048, 512, "gelu", "wmma", (128, 128), 1, 64, 16 * 4, 64, 86016),
    # N that the Hopper tiles do not cover: 384 for the LayerNorm fold, 640
    (10656, 384, 512, "resid_ln", "wmma", (64, 128), 1, 3 * 167, 3 * 167, 501, 65536),
    (10656, 640, 512, "bf16", "wmma", (128, 128), 1, 5 * 84, 5 * 84, 420, 86016),
])
def test_gemm_plan(M, N, K, epilogue, route, tile, cluster, clusters, tiles, grid, smem):
    plan = kg.gemm_plan(M, N, K, epilogue)
    assert plan == {"route": route, "tile": tile, "cluster": cluster, "clusters": clusters, "tiles": tiles,
                    "grid": grid, "smem": smem}
    assert plan["smem"] <= SMEM_LIMIT and plan["grid"] == clusters * cluster
    row_tiles = plan["tiles"] // (N // tile[1])
    assert row_tiles * tile[0] >= M > (row_tiles - 1) * tile[0]


def test_gemm_plan_grid_follows_the_card():
    assert kg.gemm_plan(10656, 512, 512, "resid_ln", sms=114)["grid"] == 114
    assert kg.gemm_plan(10656, 512, 512, "resid_ln", sms=200)["grid"] == 168
    assert kg.gemm_plan(10656, 512, 512, "resid_ln", sms=131)["clusters"] == 65


def test_gemm_plan_at_batch_48_runs_layernorm_pairs_over_the_card():
    """At 10656 rows the two LayerNorm products run as 66 clusters of two
    CTAs, each a 256-column half of the same 128 rows, over 84 row blocks
    (1.27 waves). A 64-deep stage of a CTA then copies 48 KB (A 128 x 64,
    B 256 x 64) for the operations that took 72 KB on the tile loop's
    64 x 512 tiles (A 64 x 64, B 512 x 64)."""
    for K, epilogue in ((512, "resid_ln_cross"), (2048, "resid_ln")):
        plan = kg.gemm_plan(10656, 512, K, epilogue)
        assert (plan["cluster"], plan["clusters"], plan["grid"]) == (2, 66, 132)
        assert plan["tiles"] // plan["cluster"] == -(-10656 // 128) == 84
        bm, bn = plan["tile"]
        assert bm * bn == 64 * 512 and (bm + bn) * 64 * 2 == 48 * 1024 < (64 + 512) * 64 * 2 == 72 * 1024
        assert plan["smem"] - kg.WS_SMEM == kg.WS_COLUMN_PARAMS[epilogue] * 256 * 4
    assert kg.WS_SMEM == WS_SMEM


@pytest.mark.parametrize("M,N,K,epilogue,match", [
    (0, 512, 512, "bf16", "M=0"), (10656, 100, 512, "bf16", "multiple of 128"),
    (10656, 512, 48, "gelu", "multiple of 32"), (10656, 512, 512, "resid", "unknown epilogue"),
    (1023, 512, 512, "resid_ln_cross", "only on the Hopper GEMM"),
])
def test_gemm_plan_refuses(M, N, K, epilogue, match):
    with pytest.raises(ValueError, match=match):
        kg.gemm_plan(M, N, K, epilogue)


def test_gemm_wrapper_refuses_a_device_other_than_cpu_or_cuda():
    a = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kg.gemm(a, a, a, "bf16")


@pytest.mark.parametrize("lq,warps,smem", [(1, 1, 12288), (15, 1, 12288), (16, 1, 12288), (17, 2, 24576),
                                           (64, 4, 49152), (111, 7, 86016), (128, 8, 98304), (256, 16, 196608)])
def test_attn_plan(lq, warps, smem):
    plan = k8.attn_plan(96, lq, 8)
    assert plan == {"items": 8 * 96, "warps": warps, "threads": 32 * warps, "smem": smem}
    assert plan["smem"] <= SMEM_LIMIT and plan["threads"] <= 1024


@pytest.mark.parametrize("B,lq,match", [(96, 0, "lq=0"), (96, 257, "lq=257"), (0, 111, "B=0")])
def test_attn_plan_refuses(B, lq, match):
    with pytest.raises(ValueError, match=match):
        k8.attn_plan(B, lq, 8)


@pytest.mark.parametrize("Be,lq,L", [(3, 16, 2), (5, 37, 1)])
def test_decoder_products_sum_to_the_gemm_share_of_decoder_work(Be, lq, L):
    F, H, FF = 128, 2, 256
    args = measure.decoder_case(torch.device("cpu"), Be=Be, lq=lq, F=F, H=H, L=L, FF=FF)
    flops, _ = measure.decoder_work(args)
    dh, lm = F // H, lq - 1
    attention = L * (2 * 2 * Be * H * lq * lq * dh + 2 * 2 * Be * H * lm * dh)
    products = measure.decoder_products(Be, lq, F, L, FF)
    assert sum(p["flops"] for p in products.values()) == flops - attention
    assert products["ffn2"] == {"M": Be * lq, "N": F, "K": FF, "epilogue": "resid_ln",
                                "flops": L * 2 * Be * lq * F * FF}
    for p in products.values():
        if p["epilogue"] is not None:
            assert kg.gemm_work(p["M"], p["N"], p["K"], p["epilogue"])[0] * L == p["flops"]


def test_flagship_products_take_the_hopper_gemm():
    """At batch 48 (Be 96, lq 111, F 512, FFN 2048) the four large products
    of every layer run on the Hopper GEMM; the person rows stay on wmma."""
    products = measure.decoder_products(96, 111, 512, 8, 2048)
    routes = {name: kg.gemm_plan(p["M"], p["N"], p["K"], p["epilogue"])["route"]
              for name, p in products.items() if p["epilogue"] is not None}
    assert routes == {"qkv": "wgmma", "self_out": "wgmma", "ffn1": "wgmma", "ffn2": "wgmma"}
    total = sum(p["flops"] for p in products.values())
    assert math.isclose(total / 1e9, 537.14, rel_tol=1e-4)


def test_gemm_on_cpu_tensors_takes_its_plain_version():
    g = torch.Generator().manual_seed(0)
    M, N, K = 7, 256, 64
    a = torch.randn(M, K, generator=g).bfloat16()
    b = (torch.randn(K, N, generator=g) / 8).bfloat16()
    bias = torch.randn(N, generator=g).bfloat16()
    acc = a.float() @ b.float() + bias.float()

    out = kg.gemm(a, b, bias, "bf16", scale=0.125, scale_cols=N // 2)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out[:, :N // 2], (acc[:, :N // 2] * 0.125).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(out[:, N // 2:], acc[:, N // 2:].bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(kg.gemm(a, b, bias, "gelu"), gelu_tanh(acc).bfloat16(), rtol=0, atol=0)

    res = torch.randn(M, N, generator=g)
    x, xb = kg.gemm(a, b, bias, "resid_ln", res, torch.ones(N), torch.zeros(N))
    assert x.dtype == torch.float32 and xb.dtype == torch.bfloat16
    torch.testing.assert_close(x.mean(-1), torch.zeros(M), rtol=0, atol=1e-5)
    torch.testing.assert_close(x.var(-1, unbiased=False), torch.ones(M), rtol=0, atol=1e-3)
    torch.testing.assert_close(xb, x.bfloat16(), rtol=0, atol=0)
    y = res + acc
    want = (y - y.mean(-1, keepdim=True)) / torch.sqrt(y.var(-1, unbiased=False, keepdim=True) + 1e-5)
    torch.testing.assert_close(x, want, rtol=0, atol=1e-5)


def test_gemm_cross_epilogue_keeps_the_person_rows():
    """"resid_ln_cross" (K1's self-out): the person rows e * lq keep the
    first LayerNorm; every other row takes the identity band's cross step
    and the second LayerNorm, as the decoder's plain version does."""
    from msmd_tpu_torch.ops.kernels.decoder import _layernorm

    args, kw = measure.gemm_case(torch.device("cpu"), 250, 512, 64, "resid_ln_cross", lq=111)
    x, xb = kg.gemm(*args[:3], "resid_ln_cross", *args[3:], **kw)
    first, _ = kg.gemm(*args[:3], "resid_ln", *args[3:])
    person = torch.zeros(250, dtype=torch.bool)
    person[kw["aux"].long()] = True
    assert kw["aux"].tolist() == [0, 111, 222]
    torch.testing.assert_close(x[person], first[person], rtol=0, atol=0)
    cross = _layernorm(first + (kw["vmw"].float() + kw["bco"].float()), kw["ln2_scale"], kw["ln2_bias"])
    torch.testing.assert_close(x[~person], cross[~person], rtol=0, atol=0)
    torch.testing.assert_close(xb, x.bfloat16(), rtol=0, atol=0)


def test_k1_counts_the_products_on_the_clustered_gemm():
    """``msmd.k1.cluster_products``: a K1 call adds the products that took
    the warp-specialised Hopper GEMM, 4 L at batch 48 and 0 below its 1024
    rows (6 L in the flat mode's full cross); the plain version on the CPU
    adds nothing."""
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.utils.profiling import counters

    assert kd.cluster_products(96, 111, 512, 2048, 8) == 32
    assert kd.cluster_products(9, 111, 512, 2048, 8) == 0
    assert kd.cluster_products(10, 111, 512, 2048, 8, full_cross=True) == 48
    args = measure.decoder_case(torch.device("cpu"), Be=2, lq=5, F=128, H=2, L=1, FF=256)
    before = counters().get("msmd.k1.cluster_products", 0)
    kd.fused_decoder_forward(*args)
    assert counters().get("msmd.k1.cluster_products", 0) == before
