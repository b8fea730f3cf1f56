"""K7 (``msmd_tpu_torch/ops/kernels/ffn_train.py``) on the CPU: the plain
forward and backward against the JAX kernel
``msmd_tpu/ops/pallas/ffn_train_kernel.py::fused_ffn_ln_train`` in
interpret mode, and the statistics of the port's Philox masks.

Tolerances: f32 atol 1e-5 for out and dx; 1e-5 x max|ref| for the six
parameter grads, the bias and LayerNorm sums (db1, db2, dg, db) as well as
dW1 and dW2. Each is a sum over all rows, taken in another order, and at
1040 rows the bias and LayerNorm sums reach |g| up to 150, where one f32
ulp is 1.5e-5: their measured errors there are 1.1e-5 (db1), 3.4e-5
(db2), 1.9e-5 (dg) and 1.5e-5 (db), a few ulps, so a flat 1e-5 cannot
hold; at 48 rows all seven stay under 1e-5 absolute. bf16 within 2e-2 of
max|ref| (the same rounding points, other summation orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.ops.pallas.ffn_train_kernel import fused_ffn_ln_train as jax_k7

from msmd_tpu_torch.ops.kernels import ffn_train as k7

NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dg", "db")


def _inputs(T, F, FF, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(T, F).astype(np.float32) * 0.5
    w1 = rs.randn(F, FF).astype(np.float32) * 0.1
    b1 = rs.randn(FF).astype(np.float32) * 0.1
    w2 = rs.randn(FF, F).astype(np.float32) * 0.1
    b2 = rs.randn(F).astype(np.float32) * 0.1
    g = (1.0 + 0.1 * rs.randn(F)).astype(np.float32)
    b = (0.1 * rs.randn(F)).astype(np.float32)
    gbar = rs.randn(T, F).astype(np.float32)
    return x, w1, b1, w2, b2, g, b, gbar


def _jax(x, w1, b1, w2, b2, g, b, gbar, seed, p, dtype):
    cast = lambda a: jnp.asarray(a).astype(dtype)
    args = (cast(x), cast(w1), cast(b1), cast(w2), cast(b2), jnp.asarray(g), jnp.asarray(b))
    out, vjp = jax.vjp(lambda *a: jax_k7(*a, jnp.int32(seed), p, True), *args)
    grads = vjp(cast(gbar))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(t.astype(jnp.float32)) for t in grads]


def _port(x, w1, b1, w2, b2, g, b, gbar, seed, p, dtype, masks):
    cast = lambda a: torch.from_numpy(a).to(dtype)
    xt, w1t, b1t, w2t, b2t = cast(x), cast(w1.T.copy()), cast(b1), cast(w2.T.copy()), cast(b2)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    out = k7.ffn_train_forward_plain(xt, w1t, b1t, w2t, b2t, gt, bt, seed, p, masks)
    grads = k7.ffn_train_backward_plain(xt, cast(gbar), w1t, b1t, w2t, b2t, gt, bt, seed, p, masks)
    grads = [t.float().numpy() for t in grads]
    grads[1], grads[3] = grads[1].T, grads[3].T  # nn.Linear layout -> the JAX (in, out) layout
    return out.float().numpy(), grads


@pytest.mark.parametrize("T,p", [(48, 0.0), (1040, 0.1)])
def test_plain_matches_jax_interpret_f32(T, p):
    """p = 0, and p = 0.1 with the interpret-mode masks over 1040 rows
    (five JAX tiles of 208)."""
    if p > 0:
        assert k7.pick_tile(T) == 208
    ins = _inputs(T, 32, 64, seed=T)
    want_out, want = _jax(*ins, seed=11, p=p, dtype=jnp.float32)
    got_out, got = _port(*ins, seed=11, p=p, dtype=torch.float32, masks="jax")
    np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=0)
    for name, a, w in zip(NAMES, got, want):
        atol = 1e-5 if name == "dx" else 1e-5 * np.abs(w).max()
        np.testing.assert_allclose(a, w, atol=atol, rtol=0, err_msg=name)


def test_plain_matches_jax_interpret_bf16():
    ins = _inputs(64, 128, 256, seed=3)
    want_out, want = _jax(*ins, seed=5, p=0.1, dtype=jnp.bfloat16)
    got_out, got = _port(*ins, seed=5, p=0.1, dtype=torch.bfloat16, masks="jax")
    assert np.abs(got_out - want_out).max() <= 2e-2 * np.abs(want_out).max()
    for name, a, w in zip(NAMES, got, want):
        assert np.abs(a - w).max() <= 2e-2 * np.abs(w).max(), name


def _det_bits_np(shape, salt, seed, tile_i):
    """numpy replica of ``ffn_train_kernel._det_bits`` with its seed/tile offset."""
    with np.errstate(over="ignore"):
        off = np.uint32(seed) * np.uint32(2946901) + np.uint32(tile_i) * np.uint32(83492791)
        i0 = np.arange(shape[0], dtype=np.uint32)[:, None] * np.uint32(2654435761)
        i1 = np.arange(shape[1], dtype=np.uint32)[None, :] * np.uint32(40503)
        r = (i0 + i1 + np.uint32(salt * 97) + off) * np.uint32(2246822519)
        return r ^ (r >> np.uint32(13))


def test_interpret_bits_match_the_jax_hash():
    """The torch replica of the interpret-mode hash against numpy's uint32
    arithmetic, tile by tile."""
    T, F, FF, seed = 1040, 32, 64, 9
    tile = k7.pick_tile(T)
    for salt, cols in ((1, FF), (2, F)):
        got = k7.jax_interpret_bits(seed, salt, T, cols).numpy()
        for i in range(T // tile):
            want = _det_bits_np((tile, cols), salt, seed, i).astype(np.int64)
            np.testing.assert_array_equal(got[i * tile:(i + 1) * tile], want)


def test_philox_matches_known_answer():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    def run(ctr, key):
        c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        return [int(t) for t in k7.philox4x32_10(torch.tensor(key[0]), key[1], *c)]

    assert run((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_philox_mask_statistics():
    """Keep rate within 4 sigma of 0.9 over >= 1e6 bits, no correlation of
    neighbouring rows or columns above 0.01, fresh bits per seed and salt."""
    p, R, C = 0.1, 1024, 1024
    bits = k7.philox_bits(123, 1, R, C)
    keep = (bits >= int(p * 2 ** 32)).double()
    n = keep.numel()
    assert abs(float(keep.mean()) - 0.9) <= 4 * np.sqrt(0.9 * 0.1 / n)
    z = keep - keep.mean()
    corr = lambda a, b: float((a * b).mean() / (z.var()))
    assert abs(corr(z[1:], z[:-1])) < 0.01
    assert abs(corr(z[:, 1:], z[:, :-1])) < 0.01
    for other in (k7.philox_bits(124, 1, R, C), k7.philox_bits(123, 2, R, C)):
        assert float((other == bits).double().mean()) < 1e-3
    m = k7.keep_mask(bits[:4, :8], p)
    assert set(torch.unique(m).tolist()) <= {0.0, float(np.float32(1.0) / np.float32(0.9))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_grads_equal_autograd_of_plain(dtype):
    """The Function's recompute backward against autograd through the
    plain forward, with the production masks."""
    torch.manual_seed(0)
    T, F, FF, p = 40, 32, 64, 0.1
    x, w1, b1, w2, b2, g, b, gbar = (torch.from_numpy(a) for a in _inputs(T, F, FF, seed=7))
    leaves = [x.to(dtype), w1.t().contiguous().to(dtype), b1.to(dtype), w2.t().contiguous().to(dtype), b2.to(dtype),
              g, b]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    seed = k7.seed_tensor(77, "cpu")
    f0, b0 = k7.ffn_train_forward.launches, k7.ffn_train_backward.launches
    out = k7.fused_ffn_ln_train(*leaves, seed, p)
    got = torch.autograd.grad(out, leaves, gbar.to(dtype))
    assert (k7.ffn_train_forward.launches, k7.ffn_train_backward.launches) == (f0, b0)  # CPU: plain, no launch
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    ref_out = k7.ffn_train_forward_plain(*ref_leaves, seed, p)
    want = torch.autograd.grad(ref_out, ref_leaves, gbar)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.detach().float(), ref_out.detach(), atol=tol * float(ref_out.detach().abs().max()), rtol=0)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == leaves[NAMES.index(name)].dtype, name
        assert float((a.float() - w).abs().max()) <= tol * max(float(w.abs().max()), 1e-3), name


def test_wrappers_refuse_non_cpu_tensors():
    x = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k7.ffn_train_forward(x, None, None, None, None, None, None, None, 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        k7.ffn_train_backward(x, x, None, None, None, None, None, None, None, 0.1)
