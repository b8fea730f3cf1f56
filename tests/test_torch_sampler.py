"""The batch-1 sampler through the port's K3 (``fused_sampler_scan``)
against the JAX package's, with the same weights, inputs and noise.

JAX runs its Pallas kernels in interpret mode on the CPU; the port's
wrappers take their plain versions for CPU tensors. ``sample`` is
compared over a padded (lq = 13, P = 4) and an unpadded (lq = 16, P = 7)
geometry, two and three CFG entries (three with unequal scales) and both
``regularize_alpha`` modes, in a half fraction of those factors that
holds every pair of levels:

- f32 (``fused_decoder=True`` on both sides): atol 1e-4.
- bf16 (the automatic route): the kernels round at the same points, but
  the memory K/V cache and the step-embedding MLP in front of them run
  through the bf16 modules, which round at other points in the two
  frameworks, and four DDPM steps carry that on: measured at most 0.44%
  of max |reference| (mean 0.46% of mean |reference|). Held to max error
  <= 2e-2 of max |reference| and mean error <= 1e-2 of mean |reference|.

The kernel functions are also compared directly, on the same packed
inputs: f32 atol 1e-5, bf16 max error <= 2e-2 of max |reference| (the
same rounding points, other f32 summation orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.models.diffusion import sample as jsample
from msmd_tpu.ops.pallas import decoder_kernel as jdk
from msmd_tpu_torch.measure import sampler_case
from msmd_tpu_torch.models.diffusion import sample
from msmd_tpu_torch.ops.kernels import sampler as tks

from test_torch_common import build_msmd_pair
from test_torch_sample import _sample_inputs

# (dtype, n_prev_motions, cfg_scale, regularize_alpha): a half fraction of
# dtype x lq x CFG entries x alpha mode
K3_CASES = [
    ("bfloat16", 4, 1.15, "None"), ("bfloat16", 4, [1.15, 1.4], "sigmoid"),
    ("bfloat16", 7, 1.15, "sigmoid"), ("bfloat16", 7, [1.15, 1.4], "None"),
    ("float32", 4, 1.15, "sigmoid"), ("float32", 4, [1.15, 1.4], "None"),
    ("float32", 7, 1.15, "None"), ("float32", 7, [1.15, 1.4], "sigmoid"),
]


def compare_batch1(dtype, n_prev, scale, alpha, ret_traj):
    """Port vs JAX ``sample`` at batch 1 on one case; returns the port's
    output after the check."""
    jm, jv, tm, kw = build_msmd_pair(dtype, seed=5, batch=1, n_prev_motions=n_prev, regularize_alpha=alpha)
    feat, shape, style, mT, nz, ind = _sample_inputs(6, 1, kw)
    fd = True if dtype == "float32" else None
    want, _, _ = jsample(jm, jv, jax.random.PRNGKey(0), *map(jnp.asarray, (feat, shape, style)),
                         motion_at_T=jnp.asarray(mT), noise_override=jnp.asarray(nz), indicator=jnp.asarray(ind),
                         cfg_scale=scale, fused_decoder=fd, ret_traj=ret_traj)
    want = np.asarray(want).astype(np.float32)
    got, got_T, _ = sample(tm, feat, shape, style, motion_at_T=mT, noise_override=nz, indicator=ind,
                           cfg_scale=scale, fused_decoder=fd, ret_traj=ret_traj, device="cpu")
    got = got.numpy()
    T, n = kw["n_diff_steps"], kw["n_motions"]
    assert got.shape == want.shape == ((T + 1, 1, n, 67) if ret_traj else (1, n, 67))
    np.testing.assert_array_equal(got_T.numpy(), mT)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        err = np.abs(got - want)
        assert err.max() / np.abs(want).max() <= 2e-2, err.max()
        assert err.mean() / np.abs(want).mean() <= 1e-2, err.mean()
    return got


@pytest.mark.parametrize("dtype,n_prev,scale,alpha", K3_CASES)
def test_batch1_sample_matches_jax(dtype, n_prev, scale, alpha):
    compare_batch1(dtype, n_prev, scale, alpha, ret_traj=False)


def jax_sampler_inputs(args, kw, step: bool):
    """The port's packed kernel inputs as the JAX kernel takes them: the
    same arrays, plus the selectors and masks the JAX ``const`` carries."""
    pack, kmem, vmem, motion, emb, sc, z, const = args
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    E, N = kw["n_entries"], kw["n_cur"]
    lq = const["pe_flat"].shape[0] // E
    lm, P = lq - 1, lq - 1 - N
    jconst = {k: to_j(v) for k, v in const.items()}
    cdt = jconst["wfp"].dtype
    pm, spq, sps, svm = jdk.build_identity_band_aux(E, lq, lm, dtype=cdt)
    spp, smm, stl = jdk.build_sampler_step_aux(E, lq, lm, P, N, dtype=cdt)
    jconst.update(person_mask=pm, sel_pq=spq, sel_ps=sps, sel_vm=svm, sel_pp=spp, sel_mm=smm, sel_tail=stl)
    if step:
        jconst["self_mask"] = jdk.build_masks(E, lq, lm, None)[0]
    static = dict(kw, coefficients=tuple(kw["coefficients"]))
    return ({k: to_j(v) for k, v in pack.items()}, to_j(kmem), to_j(vmem), to_j(motion), to_j(emb), to_j(sc),
            to_j(z), jconst), static


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_matches_jax_kernel(dtype):
    scan, _, kw = sampler_case("cpu", P=4, N=8, F=32, H=4, L=2, FF=64, T=3, seed=3, dtype=dtype)
    got = tks.fused_sampler_scan(*scan, **kw).numpy()
    jargs, static = jax_sampler_inputs(scan, kw, step=False)
    want = np.asarray(jdk.fused_sampler_scan(*jargs, **static, interpret=True))
    assert got.shape == want.shape == (8, 67)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2
