"""The port's FLAME decode equals the JAX package's: the plain version
of the LBS kernel against the Pallas kernel ``flame_vertices_fused``
(interpret mode) and against ``flame_forward``, on the same synthetic
FLAME buffers (atol 1e-5). The CUDA kernel is held against the plain
version on the card (``chip_smoke.py`` phase 3, ``tests/test_torch_cuda.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.models.flame import flame_forward as jflame_forward
from msmd_tpu.models.flame import synthetic_flame as jsynthetic
from msmd_tpu.ops.pallas.lbs_kernel import FusedFlame as JFused
from msmd_tpu.ops.pallas.lbs_kernel import flame_vertices_fused
from msmd_tpu_torch.models.flame import flame_forward, synthetic_flame
from msmd_tpu_torch.ops.kernels.lbs import FusedFlame, flame_vertices

V = 300


def _inputs(seed, B=6):
    rs = np.random.RandomState(seed)
    return [(rs.randn(B, n) * s).astype(np.float32) for n, s in ((100, 0.3), (50, 0.3), (6, 0.4))]


def test_synthetic_flame_buffers_equal():
    j, t = jsynthetic(n_verts=V), synthetic_flame(n_verts=V, device="cpu")
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(t.parents, j.parents)


@pytest.mark.parametrize("ignore_global_rot", [False, True])
def test_plain_matches_pallas_kernel_and_flame_forward(ignore_global_rot):
    shape, exp, pose = _inputs(0 if not ignore_global_rot else 1)
    jmodel = jsynthetic(n_verts=V)
    want_k = np.asarray(flame_vertices_fused(JFused(jmodel), *map(jnp.asarray, (shape, exp, pose)),
                                             ignore_global_rot=ignore_global_rot, batch_tile=2,
                                             vertex_tile=128, interpret=True))
    want_f = np.asarray(jflame_forward(jmodel, *map(jnp.asarray, (shape, exp, pose)),
                                       ignore_global_rot=ignore_global_rot)[0])
    tmodel = synthetic_flame(n_verts=V, device="cpu")
    args = [torch.as_tensor(a) for a in (shape, exp, pose)]
    got = flame_vertices(FusedFlame(tmodel), *args, ignore_global_rot=ignore_global_rot)
    assert got.shape == (6, V, 3)
    np.testing.assert_allclose(got.numpy(), want_k, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_f, atol=1e-5)
    np.testing.assert_allclose(flame_forward(tmodel, *args, ignore_global_rot=ignore_global_rot)[0].numpy(),
                               want_f, atol=1e-5)

