"""The products of K6 (``fused_ffn_ln``) and K9 (``fused_layer_tail``) on
the CPU: their launch plan, their work, their plain versions, and the
prepared weights a decoder layer keeps for them.

- ``ops/kernels/gemm_ws.gemm_ws_plan`` mirrors ``msmd_ws_gemm_plan``
  (``csrc/gemm_ws.cuh``): the guided batch-48 shapes (K6 10656 rows, K9
  10560, F 512, FFN 2048) take the warp-specialized GEMM, 128 x 256 tiles,
  the N = 512 LayerNorm products as two-CTA clusters; the small card-test
  shapes and fewer than 1024 rows keep the wmma tile; shapes neither takes
  are refused. The card test
  ``test_torch_cuda.py::test_gemm_ws_plan_matches_the_library`` holds the
  two equal on the card.
- ``ffn_products`` and ``tail_products``: the products' operations sum to
  ``ffn_work`` and ``tail_work``.
- The per-product plain versions (``gemm_ws_plain``: B in the nn.Linear
  layout, bf16 or f32 residual, LayerNorm with a bf16-only or an f32 + bf16
  output, tanh or erf GELU), composed as the kernels compose them, equal
  ``ffn_ln_plain`` bit for bit (both on one CPU thread), and ``layer_tail_plain`` to within the
  order of one addition (K9's cross step adds the bias to the product
  before the residual, as the kernels do, where ``layer_tail_plain`` adds
  it last): f32 atol 2e-6, bf16 within one bf16 rounding step of the value.
- A decoder layer's K6 / K9 weights are made once (``_prepared``): a second
  layer call (of a layer converted to its dtype, as ``sample`` converts
  the denoiser) casts, detaches and stacks none of the kernel's parameters
  for the kernel;
  an in-place change of a parameter makes them again; the result is that
  of the per-call casts; a copy of the layer (``sample`` deep-copies the
  denoiser) starts without them.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from msmd_tpu_torch.models.layers import init_params
from msmd_tpu_torch.models.transformer import TransformerDecoderLayer
from msmd_tpu_torch.ops.kernels import ffn as k6
from msmd_tpu_torch.ops.kernels import gemm_ws as kw
from msmd_tpu_torch.ops.kernels import layer_tail as k9

SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90
WS_SMEM = 4 * (128 + 256) * 128 + 1024 + 2 * 64 * 16 + 10 * 8


@pytest.mark.parametrize("M,N,K,epilogue,route,tile,cluster,tiles,grid,smem", [
    # K6 at the guided batch-48 shape (96 x 111 rows)
    (10656, 2048, 512, "gelu", "wgmma_ws", (128, 256), 1, 84 * 8, 132, WS_SMEM),
    (10656, 512, 2048, "resid_ln", "wgmma_ws", (128, 256), 2, 2 * 84, 132, WS_SMEM),
    # K9's motion rows (96 x 110)
    (10560, 512, 512, "resid_ln", "wgmma_ws", (128, 256), 2, 2 * 83, 132, WS_SMEM),
    (10560, 2048, 512, "gelu_erf", "wgmma_ws", (128, 256), 1, 83 * 8, 132, WS_SMEM),
    # 17 entries of 111 rows: fewer row blocks than SM pairs
    (1887, 512, 2048, "resid_ln", "wgmma_ws", (128, 256), 2, 2 * 15, 30, WS_SMEM),
    (1887, 2048, 512, "gelu", "wgmma_ws", (128, 256), 1, 15 * 8, 120, WS_SMEM),
    # the card tests' small shapes and fewer than 1024 rows: the wmma tile
    (100, 256, 128, "gelu", "wmma", (64, 128), 1, 2 * 2, 4, 71680),
    (100, 128, 256, "resid_ln", "wmma", (64, 128), 1, 2, 2, 71680),
    (1023, 2048, 512, "gelu_erf", "wmma", (128, 128), 1, 16 * 8, 128, 92160),
    (1023, 512, 2048, "resid_ln", "wmma", (64, 128), 1, 4 * 16, 64, 71680),
    # widths the warp-specialized tiles do not cover
    (10656, 384, 512, "resid_ln", "wmma", (64, 128), 1, 3 * 167, 501, 71680),
    (10656, 640, 512, "gelu", "wmma", (128, 128), 1, 5 * 84, 420, 92160),
    (10656, 512, 96, "resid_ln", "wmma", (64, 128), 1, 4 * 167, 668, 71680),
])
def test_gemm_ws_plan(M, N, K, epilogue, route, tile, cluster, tiles, grid, smem):
    plan = kw.gemm_ws_plan(M, N, K, epilogue)
    assert plan == {"route": route, "tile": tile, "cluster": cluster, "tiles": tiles, "grid": grid, "smem": smem}
    assert plan["smem"] <= SMEM_LIMIT and plan["grid"] % cluster == 0
    column_tiles = N // tile[1]
    row_tiles = plan["tiles"] // column_tiles
    assert row_tiles * tile[0] >= M > (row_tiles - 1) * tile[0]


def test_gemm_ws_plan_grid_follows_the_card():
    assert kw.gemm_ws_plan(10656, 512, 2048, "resid_ln", sms=114)["grid"] == 114
    assert kw.gemm_ws_plan(10656, 512, 2048, "resid_ln", sms=200)["grid"] == 168
    assert kw.gemm_ws_plan(10656, 2048, 512, "gelu", sms=114)["grid"] == 114


@pytest.mark.parametrize("M,N,K,epilogue,match", [
    (0, 512, 512, "gelu", "M=0"), (10656, 100, 512, "gelu", "multiple of 128"),
    (10656, 512, 48, "resid_ln", "multiple of 32"), (10656, 512, 512, "resid", "unknown epilogue"),
    (10656, 1280, 512, "resid_ln", "N <= 1024"),
])
def test_gemm_ws_plan_refuses(M, N, K, epilogue, match):
    with pytest.raises(ValueError, match=match):
        kw.gemm_ws_plan(M, N, K, epilogue)


def test_guided_shapes_take_the_warp_specialized_gemm():
    """K6 is two launches and K9 four, every one on the new GEMM; the
    LayerNorm products as two-CTA clusters."""
    ffn = k6.ffn_products(96 * 111, 512, 2048)
    tail = k9.tail_products(96 * 110, 512, 2048)
    assert list(ffn) == ["ffn1", "ffn2"] and list(tail) == ["self_out", "cross_out", "ffn1", "ffn2"]
    for p in list(ffn.values()) + list(tail.values()):
        assert p["plan"]["route"] == "wgmma_ws"
        assert p["plan"]["cluster"] == (2 if p["epilogue"] == "resid_ln" else 1)
    assert ffn["ffn1"]["epilogue"] == "gelu" and tail["ffn1"]["epilogue"] == "gelu_erf"
    assert [tail[k]["res"] for k in ("self_out", "cross_out", "ffn2")] == ["bf16", "f32", "f32"]
    assert [tail[k]["out"] for k in ("self_out", "cross_out", "ffn2")] == ["x", "x_xb", "bf16"]
    assert ffn["ffn2"]["res"] == "bf16" and ffn["ffn2"]["out"] == "bf16"


@pytest.mark.parametrize("rows,F,FF", [(100, 128, 256), (1023, 512, 2048), (45, 128, 256)])
def test_small_shapes_keep_the_wmma_tile(rows, F, FF):
    for p in list(k6.ffn_products(rows, F, FF).values()) + list(k9.tail_products(rows, F, FF).values()):
        assert p["plan"]["route"] == "wmma"


@pytest.mark.parametrize("rows,F,FF", [(10656, 512, 2048), (10560, 512, 2048), (100, 128, 256), (1887, 256, 1024)])
def test_products_sum_to_the_kernels_work(rows, F, FF):
    assert sum(p["flops"] for p in k6.ffn_products(rows, F, FF).values()) == k6.ffn_work(rows, F, FF)[0]
    assert sum(p["flops"] for p in k9.tail_products(rows, F, FF).values()) == k9.tail_work(rows, F, FF)[0]
    ffn2 = k6.ffn_products(rows, F, FF)["ffn2"]
    assert ffn2["bytes"] == 2 * (rows * FF + F * FF + F) + rows * F * (2 + 2) + 2 * F * 4


def _case(rows, F, FF, dtype, seed, n_res=1):
    rs = np.random.RandomState(seed)
    t = lambda *shape, s=1.0: torch.as_tensor((rs.randn(*shape) * s).astype(np.float32)).to(dtype)
    f32 = lambda *shape, s=1.0, o=0.0: torch.as_tensor((o + rs.randn(*shape) * s).astype(np.float32))
    acts = [t(rows, F) for _ in range(n_res)]
    ws = dict(w1=t(FF, F, s=F ** -0.5), b1=t(FF, s=0.1), w2=t(F, FF, s=FF ** -0.5), b2=t(F, s=0.1))
    ln = (f32(3, F, s=0.1, o=1.0), f32(3, F, s=0.1))
    return acts, ws, ln


@pytest.fixture
def one_cpu_thread():
    """The CPU's f32 products on one thread while the test runs: how a
    product is split over threads is the one thing that differs between two
    calls of the same torch op on the same tensors, so under one thread
    the two sides' bits can be compared."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_composed_twins_equal_ffn_ln_plain(dtype, one_cpu_thread):
    (x,), w, (g, b) = _case(37, 64, 256, dtype, seed=1)
    h = kw.gemm_ws_plain(x, w["w1"], w["b1"], "gelu" if dtype == torch.bfloat16 else "gelu_erf")
    out = kw.gemm_ws_plain(h, w["w2"], w["b2"], "resid_ln", x, g[0], b[0])
    want = k6.ffn_ln_plain(x, w["w1"], w["b1"], w["w2"], w["b2"], g[0], b[0])
    assert out.dtype == want.dtype == dtype
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_composed_twins_equal_layer_tail_plain(dtype):
    Be, lm, F, FF = 3, 13, 64, 256
    (sa, x, v), w, (s, b) = _case(Be * lm, F, FF, dtype, seed=2, n_res=3)
    rs = np.random.RandomState(3)
    wso, bso, wco, bco = (torch.as_tensor((rs.randn(*shape) * sc).astype(np.float32)).to(dtype)
                          for shape, sc in (((F, F), F ** -0.5), ((F,), 0.1), ((F, F), F ** -0.5), ((F,), 0.1)))
    x1 = kw.gemm_ws_plain(sa, wso, bso, "resid_ln", x, s[0], b[0], out="x")
    x2, x2b = kw.gemm_ws_plain(v, wco, bco, "resid_ln", x1, s[1], b[1], out="x_xb")
    assert x1.dtype == x2.dtype == torch.float32 and x2b.dtype == dtype
    assert torch.equal(x2b, x2.to(dtype))
    h = kw.gemm_ws_plain(x2b, w["w1"], w["b1"], "gelu_erf")
    out = kw.gemm_ws_plain(h, w["w2"], w["b2"], "resid_ln", x2, s[2], b[2])
    want = k9.layer_tail_plain(sa.reshape(Be, lm, F), x.reshape(Be, lm, F), v, wso, bso, wco, bco, w["w1"],
                               w["b1"], w["w2"], w["b2"], s, b).reshape(-1, F)
    assert out.dtype == want.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=2e-6)
    else:
        step = want.float().abs() * 2.0 ** -7 + 1e-6  # one bf16 rounding step at the value
        assert bool(((out.float() - want.float()).abs() <= step).all())


def test_gemm_ws_on_cpu_tensors_takes_its_plain_version():
    g = torch.Generator().manual_seed(0)
    M, N, K = 7, 256, 64
    a = torch.randn(M, K, generator=g).bfloat16()
    w = (torch.randn(N, K, generator=g) / 8).bfloat16()
    bias = torch.randn(N, generator=g).bfloat16()
    acc = a.float() @ w.float().t() + bias.float()
    tanh, erf = kw.gemm_ws(a, w, bias, "gelu"), kw.gemm_ws(a, w, bias, "gelu_erf")
    torch.testing.assert_close(tanh, torch.nn.functional.gelu(acc, approximate="tanh").bfloat16(), rtol=0,
                               atol=1e-2)
    torch.testing.assert_close(erf, torch.nn.functional.gelu(acc).bfloat16(), rtol=0, atol=1e-2)
    assert tanh.dtype == erf.dtype == torch.bfloat16 and not torch.equal(tanh, erf)
    res = torch.randn(M, N, generator=g)
    for r in (res, res.bfloat16()):
        x, xb = kw.gemm_ws(a, w, bias, "resid_ln", r, torch.ones(N), torch.zeros(N), out="x_xb")
        assert x.dtype == torch.float32 and torch.equal(xb, x.bfloat16())
        torch.testing.assert_close(x.mean(-1), torch.zeros(M), rtol=0, atol=1e-5)
        assert torch.equal(kw.gemm_ws(a, w, bias, "resid_ln", r, torch.ones(N), torch.zeros(N)), xb)
        assert torch.equal(kw.gemm_ws(a, w, bias, "resid_ln", r, torch.ones(N), torch.zeros(N), out="x"), x)
    with pytest.raises(ValueError, match="unknown route"):
        kw.gemm_ws(a, w, bias, "gelu", route="cublas")
    with pytest.raises(ValueError, match="unknown output"):
        kw.gemm_ws(a, w, bias, "resid_ln", res, torch.ones(N), torch.zeros(N), out="f16")


class _Casts(TorchFunctionMode):
    """Records every ``Tensor.to``, ``Tensor.float``, ``Tensor.detach`` and
    ``torch.stack`` call on the tensors ``watched`` that makes a new tensor
    (a ``.to`` or ``.float`` to the tensor's own dtype returns it, and is
    not recorded)."""

    def __init__(self, watched):
        super().__init__()
        self.ids, self.seen = {id(t) for t in watched}, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.Tensor.to, torch.Tensor.float, torch.Tensor.detach, torch.stack):
            flat = list(args[0]) if func is torch.stack else [args[0]]
            self.seen += [func.__name__ for t in flat if id(t) in self.ids and out is not t]
        return out


@pytest.mark.parametrize("route", ["fused_ffn", "fused_tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_prepares_kernel_weights_once(route, dtype):
    F, FF, Be, lq = 64, 128, 3, 9
    layer = init_params(TransformerDecoderLayer(F, 2, FF, dtype=dtype), 3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))  # biases and norms away from 0 and 1
    layer.to(dtype)  # as ``sample`` converts the denoiser
    x = torch.randn(Be, lq, F, generator=g).to(dtype)
    kv = layer.memory_kv(torch.randn(Be, lq - 1, F, generator=g))
    kwargs = dict(memory_kv=kv, cross_identity_band=True, **{route: True})
    l1, l2 = layer.ffn.linear1, layer.ffn.linear2
    owned = [l1.weight, l1.bias, l2.weight, l2.bias, layer.norm3.weight, layer.norm3.bias]
    if route == "fused_tail":
        so, co = layer.self_attn.out_proj, layer.cross_attn.out_proj
        owned += [so.weight, so.bias, co.weight, co.bias, layer.norm1.weight, layer.norm1.bias,
                  layer.norm2.weight, layer.norm2.bias]
    name = "k6" if route == "fused_ffn" else "k9"
    with torch.no_grad():
        first = layer(x, **kwargs)
        prepared = layer._kernel_weights[name][1]
        with _Casts(owned) as casts:
            second = layer(x, **kwargs)
        # K9's person rows run the plain LayerNorm modules, which take
        # their parameters in f32 (at bf16 a cast each, as on every route)
        person_norms = ["float"] * 6 if route == "fused_tail" and dtype == torch.bfloat16 else []
        assert casts.seen == person_norms and layer._kernel_weights[name][1] is prepared
        assert torch.equal(first, second)
        assert prepared.maps is None  # tensor maps are made on the card only
        if route == "fused_ffn":
            n3 = layer.norm3
            x1 = layer.norm1(x + layer.self_attn(x))
            y = layer.norm2(x1 + layer.cross_attn(x1, kv_cache=kv, identity_band=True))
            direct = k6.fused_ffn_ln(y, l1.weight.to(dtype), l1.bias.to(dtype), l2.weight.to(dtype),
                                     l2.bias.to(dtype), n3.weight.float(), n3.bias.float())
            assert torch.equal(first, direct)
        else:
            plain = layer(x, memory_kv=kv, cross_identity_band=True)
            tol = 1e-5 if dtype == torch.float32 else 3e-2
            assert float((first.float() - plain.float()).abs().max()) <= tol * float(plain.float().abs().max())
        l2.bias.add_(1.0)
        with _Casts(owned) as casts:
            third = layer(x, **kwargs)
    assert layer._kernel_weights[name][1] is not prepared and casts.seen
    assert not torch.equal(third, first)


def test_layer_copy_drops_prepared_weights():
    """``sample`` deep-copies the denoiser for each call: the copy's
    parameters are other tensors, so it prepares its own weights, and the
    original's (whose tensor maps cannot be copied) are not carried over."""
    import copy

    layer = init_params(TransformerDecoderLayer(64, 2, 128, dtype=torch.bfloat16), 5)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 9, 64, generator=g).bfloat16()
    kv = layer.memory_kv(torch.randn(2, 8, 64, generator=g))
    with torch.no_grad():
        want = layer(x, memory_kv=kv, cross_identity_band=True, fused_ffn=True)
        assert set(layer._kernel_weights) == {"k6"}
        twin = copy.deepcopy(layer)
        assert twin._kernel_weights == {} and set(layer._kernel_weights) == {"k6"}
        assert torch.equal(twin(x, memory_kv=kv, cross_identity_band=True, fused_ffn=True), want)
    assert twin._kernel_weights["k6"][1].w1.data_ptr() != layer._kernel_weights["k6"][1].w1.data_ptr()
