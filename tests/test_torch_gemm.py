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


@pytest.mark.parametrize("M,N,K,epilogue,route,tile,tiles,grid,smem", [
    # K1's four products at batch 48 (R = Be * lq = 96 * 111)
    (10656, 1536, 512, "bf16", "wgmma", (128, 256), 84 * 6, 132, 4 * (128 + 256) * 128 + 2048 + 32),
    (10656, 512, 512, "resid_ln", "wgmma", (64, 512), 167, 132, 3 * (64 + 512) * 128 + 2048 + 24),
    (10656, 2048, 512, "gelu", "wgmma", (128, 256), 84 * 8, 132, 4 * (128 + 256) * 128 + 2048 + 32),
    (10656, 512, 2048, "resid_ln", "wgmma", (64, 512), 167, 132, 3 * (64 + 512) * 128 + 2048 + 24),
    # a ragged R (Be = 17): fewer tiles than SMs
    (1887, 512, 2048, "resid_ln", "wgmma", (64, 512), 30, 30, 3 * (64 + 512) * 128 + 2048 + 24),
    # below MIN_ROWS (K3 and K4 at 222 rows, K1 flat at 444): the wmma tile
    (1023, 512, 512, "resid_ln", "wmma", (64, 128), 4 * 16, 64, 65536),
    (222, 1536, 512, "bf16", "wmma", (128, 128), 12 * 2, 24, 86016),
    (444, 2048, 512, "gelu", "wmma", (128, 128), 16 * 4, 64, 86016),
    # N that the Hopper tiles do not cover: 384 for the LayerNorm fold, 640
    (10656, 384, 512, "resid_ln", "wmma", (64, 128), 3 * 167, 501, 65536),
    (10656, 640, 512, "bf16", "wmma", (128, 128), 5 * 84, 420, 86016),
])
def test_gemm_plan(M, N, K, epilogue, route, tile, tiles, grid, smem):
    plan = kg.gemm_plan(M, N, K, epilogue)
    assert plan == {"route": route, "tile": tile, "tiles": tiles, "grid": grid, "smem": smem}
    assert plan["smem"] <= SMEM_LIMIT
    row_tiles = plan["tiles"] // (N // tile[1])
    assert row_tiles * tile[0] >= M > (row_tiles - 1) * tile[0]


def test_gemm_plan_grid_follows_the_card():
    assert kg.gemm_plan(10656, 512, 512, "resid_ln", sms=114)["grid"] == 114
    assert kg.gemm_plan(10656, 512, 512, "resid_ln", sms=200)["grid"] == 167


@pytest.mark.parametrize("M,N,K,epilogue,match", [
    (0, 512, 512, "bf16", "M=0"), (10656, 100, 512, "bf16", "multiple of 128"),
    (10656, 512, 48, "gelu", "multiple of 32"), (10656, 512, 512, "resid", "unknown epilogue"),
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
