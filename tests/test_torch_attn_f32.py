"""K8's f32 mode (the style encoders' attention) on the CPU: its launch
plan, its arithmetic and the wrapper's one-pass argument check.

- ``attn_f32_plan`` pins the launch ``csrc/attn.cu`` makes (grid, CTAs a
  head, query rows a CTA, key tiles, shared memory, launches a call) at B
  1 and 16 and lq 1, 100 (the style clip), 128, 129 and 256; it refuses
  lq 257 as ``attn_plan`` does; at every lq it fits the card (shared
  memory under 227 KB) and covers the rows and the keys.
  The card test ``test_torch_cuda.py::test_attn_f32_kernel_matches_plain``
  holds it equal to the library's own plan query.
- ``attention_middle_f32_model``, the kernel's arithmetic (both products
  as three TF32 products, each operand split as K5 splits it), stays
  within 1e-6 of max |plain| of an f64 reference at the style encoders'
  shapes (B 1 and 16, lq 100, F 512, 8 heads), where the plain f32 version
  itself is about 1e-6 off; one TF32 product a product misses that by far.
  The model and the plain f32 version differ by their two errors (up to
  about 1.5e-6), so the f64 reference is the yardstick.
- ``_check_f32``, the wrapper's check in one pass, takes what ``_check``
  and ``attn_plan`` take (q, k, v as column slices of one projection) and
  refuses what they refuse, with the same exception and message.
"""

import re

import numpy as np
import pytest
import torch

from msmd_tpu_torch.ops.kernels import attn as k8

H = 8
# lq -> (CTAs a head, pairs of 8-key tiles, shared memory a CTA)
PLANS = {1: (1, 1, 30464), 100: (2, 7, 108800), 128: (2, 8, 121856), 129: (3, 9, 134912), 256: (4, 16, 226304)}


@pytest.mark.parametrize("lq", sorted(PLANS))
@pytest.mark.parametrize("B", [1, 16])
def test_f32_plan_pins_the_launch(B, lq):
    ctas, nc, smem = PLANS[lq]
    plan = k8.attn_f32_plan(B, lq, H)
    assert plan == {"grid": B * H * ctas, "ctas_per_head": ctas, "threads": 128, "query_rows": 64, "nc": nc,
                    "smem": smem, "launches": 1}


@pytest.mark.parametrize("B", [1, 16])
def test_f32_plan_refuses_rows_past_max_lq(B):
    with pytest.raises(ValueError, match=f"lq=257 \\(B={B}\\)"):
        k8.attn_f32_plan(B, k8.MAX_LQ + 1, H)


def test_f32_plan_fits_the_card_at_every_lq():
    for lq in range(1, k8.MAX_LQ + 1):
        p = k8.attn_f32_plan(3, lq, H)
        assert p["smem"] <= 227 * 1024
        assert p["query_rows"] * p["ctas_per_head"] >= lq > p["query_rows"] * (p["ctas_per_head"] - 1)
        assert 16 * p["nc"] >= lq > 16 * (p["nc"] - 1) and p["grid"] == 3 * H * p["ctas_per_head"]


def _style_case(B, seed):
    """A style encoder's projected q, k, v (B, 100, 512) in f32, drawn as
    ``measure.attn_case`` draws them (q and k at 1.5, v at 1)."""
    rs = np.random.RandomState(seed)
    qkv = torch.as_tensor((rs.randn(B, 100, 3 * 512) * np.repeat([1.5, 1.5, 1.0], 512)).astype(np.float32))
    return qkv.split(512, dim=-1)


def _f64(q, k, v):
    heads = lambda t: t.double().reshape(*t.shape[:2], H, 64).transpose(1, 2)
    p = torch.softmax(heads(q) / 8.0 @ heads(k).transpose(-1, -2), dim=-1)
    return (p @ heads(v)).transpose(1, 2).reshape(q.shape)


@pytest.mark.parametrize("B,seed", [(1, 0), (16, 1)])
def test_three_tf32_products_hold_f32_accuracy(B, seed):
    q, k, v = _style_case(B, seed)
    want, plain = _f64(q, k, v), k8.attention_middle_plain(q, k, v, H)
    scale = float(plain.abs().max())
    model = k8.attention_middle_f32_model(q, k, v, H)
    assert model.dtype == torch.float32 and model.shape == q.shape
    assert float((model.double() - want).abs().max()) <= 1e-6 * scale
    assert float((plain.double() - want).abs().max()) <= 2e-6 * scale  # the plain f32 version's own error


def test_one_tf32_product_misses_f32_accuracy():
    q, k, v = _style_case(1, 0)
    one = k8.attention_middle_f32_model(q, k, v, H, passes=1)
    assert float((one.double() - _f64(q, k, v)).abs().max()) > 1e-4 * float(one.abs().max())
    with pytest.raises(ValueError, match="passes must be 1 or 3"):
        k8.attention_middle_f32_model(q, k, v, H, passes=2)


def _qkv(B=2, lq=100, F=512, dtype=torch.float32):
    qkv = torch.randn(B, lq, 3 * F, generator=torch.Generator().manual_seed(3)).to(dtype)
    return list(qkv.split(F, dim=-1))


def _slow(q, k, v, n_heads):
    ld = k8._check(q, k, v, n_heads, torch.float32)
    k8.attn_plan(*q.shape[:2], n_heads)
    return ld


def test_one_pass_check_takes_column_slices():
    q, k, v = _qkv()
    ptrs = tuple(t.data_ptr() for t in (q, k, v))
    assert k8._check_f32(q, k, v, H) == (_slow(q, k, v, H), -1, ptrs) == (3 * 512, -1, ptrs)  # -1: the CPU
    c = [t.contiguous() for t in (q, k, v)]
    assert k8._check_f32(*c, H)[:2] == (512, -1)


def _misaligned(t):
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape).copy_(t)


BAD = {
    "dtype": lambda q, k, v: ((q, k.double(), v), H),
    "bf16": lambda q, k, v: ((q.bfloat16(), k, v), H),
    "shape": lambda q, k, v: ((q, k, v[:, :99]), H),
    "entries": lambda q, k, v: ((q, k[:1], v), H),
    "row_stride": lambda q, k, v: ((q.contiguous(), k, v), H),
    "not_rows": lambda q, k, v: ((q, k.transpose(0, 1).contiguous().transpose(0, 1), v), H),
    "misaligned": lambda q, k, v: ((_misaligned(q.contiguous()), k.contiguous(), v.contiguous()), H),
    "head_dim": lambda q, k, v: ((q, k, v), 4),
    "no_heads": lambda q, k, v: ((q[..., :0], k[..., :0], v[..., :0]), 0),
    "rows_past_max": lambda q, k, v: (tuple(torch.zeros(1, 257, 512) for _ in range(3)), H),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_one_pass_check_refuses_as_check(case):
    args, n_heads = BAD[case](*_qkv())
    with pytest.raises((TypeError, ValueError)) as want:
        _slow(*args, n_heads)
    with pytest.raises(want.type, match=re.escape(str(want.value))):
        k8._check_f32(*args, n_heads)
