"""The batch-1 sampler's trajectory route through the port's K4
(``fused_sampler_step``, once per step) against the JAX package's, with
the same weights, inputs and noise: the whole trajectory x_T .. x_0 is
compared. Tolerances and their reasons are those of
``test_torch_sampler.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.ops.pallas import decoder_kernel as jdk
from msmd_tpu_torch.measure import sampler_case
from msmd_tpu_torch.ops.kernels import sampler as tks

from test_torch_sampler import compare_batch1, jax_sampler_inputs

# (dtype, n_prev_motions, cfg_scale, regularize_alpha)
K4_CASES = [
    ("bfloat16", 7, 1.15, "sigmoid"), ("bfloat16", 4, [1.15, 1.4], "None"),
    ("float32", 4, 1.15, "None"), ("float32", 7, [1.15, 1.4], "sigmoid"),
]


@pytest.mark.parametrize("dtype,n_prev,scale,alpha", K4_CASES)
def test_batch1_trajectory_matches_jax(dtype, n_prev, scale, alpha):
    traj = compare_batch1(dtype, n_prev, scale, alpha, ret_traj=True)
    assert np.isfinite(traj).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_kernel_matches_jax_kernel(dtype):
    _, step, kw = sampler_case("cpu", P=7, N=8, F=32, H=4, L=2, FF=64, T=3, seed=4, dtype=dtype)
    got = tks.fused_sampler_step(*step, **kw).numpy()
    jargs, static = jax_sampler_inputs(step, kw, step=True)
    want = np.asarray(jdk.fused_sampler_step(*jargs, **static, interpret=True))
    assert got.shape == want.shape == (8, 67)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed,T,at", [(11, 5, -1), (12, 5, 0)])
def test_step_kernel_matches_jax_kernel_at_other_steps(dtype, seed, T, at):
    """K4's plain twin (the kernel's rounding points, the gathered cross
    output over every row) against the JAX kernel on a second seed, with
    the step's rows taken from T-step tables at the last step (t = 1) and
    at the first (t = T)."""
    scan, step, kw = sampler_case("cpu", P=7, N=8, F=32, H=4, L=2, FF=64, T=T, seed=seed, dtype=dtype)
    pack, kmem, vmem, motion, emb, sc, z, _ = scan
    step = (pack, kmem, vmem, motion, emb[at], sc[at], z[at], step[7])
    got = tks.fused_sampler_step(*step, **kw).numpy()
    jargs, static = jax_sampler_inputs(step, kw, step=True)
    want = np.asarray(jdk.fused_sampler_step(*jargs, **static, interpret=True))
    assert got.shape == want.shape == (8, 67)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2
