"""The port's sequence and schedule ops equal the JAX package's
(f32, atol 1e-5, rtol 1e-4)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.ops import schedule as jsched
from msmd_tpu.ops import seq as jseq
from msmd_tpu_torch.ops import schedule as tsched
from msmd_tpu_torch.ops import seq as tseq

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("mode", ["linear", "quadratic", "sigmoid", "cosine"])
def test_schedule_tables(mode):
    j = jsched.DiffusionSchedule.create(50, mode)
    t = tsched.DiffusionSchedule.create(50, mode)
    for name in ("betas", "alphas", "alpha_bars", "sigmas_flex", "sigmas_inflex"):
        np.testing.assert_allclose(getattr(t, name), np.asarray(getattr(j, name)), **TOL)
    ts = np.arange(51)
    np.testing.assert_allclose(t.get_sigmas(ts, 0.3), np.asarray(j.get_sigmas(jnp.asarray(ts), 0.3)), **TOL)


def test_sinusoidal_pe_single_row_and_alignment_mask():
    table_j = np.asarray(jseq.sinusoidal_table(16, 40))
    table_t = tseq.sinusoidal_table(16, 40)
    np.testing.assert_allclose(table_t.numpy(), table_j, **TOL)
    x = np.random.RandomState(0).randn(2, 7, 16).astype(np.float32)
    np.testing.assert_allclose(
        tseq.apply_pe_single_row(torch.as_tensor(x), table_t).numpy(),
        np.asarray(jseq.apply_pe_single_row(jnp.asarray(x), jnp.asarray(table_j))), **TOL)
    for width in (1, 3):
        np.testing.assert_array_equal(tseq.alignment_mask(4, 6, width).numpy(),
                                      np.asarray(jseq.alignment_mask(4, 6, width)))


@pytest.mark.parametrize("length", [5120, 5000, 4801, 321])
def test_pad_audio(length):
    a = np.random.RandomState(length).randn(2, length).astype(np.float32)
    np.testing.assert_allclose(tseq.pad_audio(torch.as_tensor(a)).numpy(),
                               np.asarray(jseq.pad_audio(jnp.asarray(a))), **TOL)


@pytest.mark.parametrize("in_len,out_len", [(32, 16), (17, 40), (200, 100), (9, 9)])
def test_linear_interpolate(in_len, out_len):
    f = np.random.RandomState(in_len).randn(2, 3, in_len).astype(np.float32)
    np.testing.assert_allclose(tseq.linear_interpolate(torch.as_tensor(f), out_len).numpy(),
                               np.asarray(jseq.linear_interpolate(jnp.asarray(f), out_len)), **TOL)
    np.testing.assert_allclose(
        tseq.linear_interpolation_fps(torch.as_tensor(f), 50, 25).numpy(),
        np.asarray(jseq.linear_interpolation_fps(jnp.asarray(f), 50, 25)), **TOL)
