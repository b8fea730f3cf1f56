"""The port's vertex-space loss against the JAX package on the CPU, at a
tiny geometry (``synthetic_flame(n_verts=128)``, 6 motions after 3
previous ones); every input is drawn with numpy from a seed:

- ``load_flame`` on the fabricated ``generic_model.pkl`` of
  ``tests/test_flame_loading.py`` (plain and chumpy-style, with the
  landmark embedding): every buffer equal to the JAX ``load_flame``'s
  (the landmark indices int64, where JAX without x64 holds int32);
- ``FlameSkin``'s backward (the port of ``FusedFlame.skin_fn``'s custom
  VJP) against ``jax.vjp`` of ``skin_fn(interpret=True)``: d_betas and
  d_rt within 1e-5 of max |JAX| (f32, other summation orders);
- the gradients of ``flame_vertices`` with respect to shape, exp and pose
  against ``jax.grad`` through ``flame_vertices_fused`` in interpret mode,
  with and without ``ignore_global_rot``: within 1e-5 of max |JAX|;
- ``compute_loss`` with a ``FlameModel`` and with a ``FusedFlame``:
  starting and continuation windows, ``end_idx``, ``no_constrain_prev``,
  l1 and l2, ``target`` sample and noise, with and without the
  denormalisation statistics: every term to rtol 1e-5 (atol 1e-7), and the
  gradient of the weighted sum with respect to the denoiser's output to
  1e-5 of max |JAX| + 1e-9;
- the coefficient helpers (``get_coef_dict``, ``get_motion_coef``,
  ``coef_dict_to_vertices``) equal to JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_flame_loading import FakeCh, fake_assets  # noqa: F401  (the fabricated FLAME assets)

V = 128


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def flames():
    """(JAX FlameModel, JAX FusedFlame in interpret mode, port FlameModel,
    port FusedFlame), the same synthetic buffers."""
    from msmd_tpu.models.flame import synthetic_flame as jsynth
    from msmd_tpu.ops.pallas.lbs_kernel import FusedFlame as JFused
    from msmd_tpu_torch.models.flame import synthetic_flame
    from msmd_tpu_torch.ops.kernels.lbs import FusedFlame

    jm = jsynth(n_verts=V)
    tm = synthetic_flame(n_verts=V, device="cpu")
    return jm, JFused(jm, interpret=True, batch_tile=8, vertex_tile=128), tm, FusedFlame(tm)


@pytest.mark.parametrize("chumpy", [False, True])
def test_load_flame_matches_jax(fake_assets, chumpy):  # noqa: F811
    import pickle

    from msmd_tpu.models.flame import FLAMEConfig as JCfg, load_flame as jload
    from msmd_tpu_torch.models.flame import FLAMEConfig, load_flame

    path = fake_assets / "generic_model.pkl"
    if chumpy:
        with open(path, "rb") as f:
            data = pickle.load(f)
        data["v_template"], data["weights"] = FakeCh(data["v_template"]), FakeCh(np.asarray(data["weights"]))
        path = fake_assets / "generic_model_ch_torch.pkl"
        with open(path, "wb") as f:
            pickle.dump(data, f)
    kw = dict(flame_model_path=str(path), flame_lmk_embedding_path=str(fake_assets / "landmark_embedding.npy"))
    want, got = jload(JCfg(**kw)), load_flame(FLAMEConfig(**kw), device="cpu")
    names = ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights", "lmk_faces_idx",
             "lmk_bary_coords", "dynamic_lmk_faces_idx", "dynamic_lmk_bary_coords", "full_lmk_faces_idx",
             "full_lmk_bary_coords")
    for name in names:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(a.shape) == b.shape, name  # indices: int64 here, int32 in JAX without x64
        assert a.numpy().dtype == b.dtype or (a.dtype == torch.int64 and b.dtype == np.int32), name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    np.testing.assert_array_equal(got.parents, want.parents)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.shapedirs.shape == (64, 3, 150)


def test_flame_skin_backward_matches_jax_vjp(flames):
    from msmd_tpu_torch.ops.kernels.lbs import FlameSkin, skin_inputs

    jm, jfused, tm, fused = flames
    N = 11
    betas_ext, rt = skin_inputs(fused, *(torch.from_numpy(_rand((N, n), 20 + n, s))
                                         for n, s in ((100, 0.3), (50, 0.3), (6, 0.4))))
    g = _rand((N, V, 3), 30)
    skin = jfused.skin_fn(batch_tile=8, vertex_tile=128, interpret=True)
    _, vjp = jax.vjp(skin, jnp.asarray(betas_ext.numpy()), jnp.asarray(rt.numpy()))
    g_planes = np.pad(g.transpose(2, 0, 1), ((0, 0), (0, 0), (0, jfused.vp - V)))
    want = vjp(jnp.asarray(g_planes))
    leaves = [betas_ext.clone().requires_grad_(True), rt.clone().requires_grad_(True)]
    got = torch.autograd.grad(FlameSkin.apply(fused, *leaves), leaves, torch.from_numpy(g))
    for name, a, w in zip(("d_betas", "d_rt"), got, want):
        assert tuple(a.shape) == w.shape, name
        assert _rel(a.numpy(), w) <= 1e-5, (name, _rel(a.numpy(), w))


@pytest.mark.parametrize("ignore_global_rot", [False, True])
def test_flame_vertices_grads_match_jax(flames, ignore_global_rot):
    from msmd_tpu.ops.pallas.lbs_kernel import flame_vertices_fused
    from msmd_tpu_torch.ops.kernels.lbs import flame_vertices

    jm, jfused, tm, fused = flames
    N = 9
    inputs = [_rand((N, n), 40 + n, s) for n, s in ((100, 0.3), (50, 0.3), (6, 0.4))]
    G = _rand((N, V, 3), 50)

    def jloss(*a):
        return jnp.sum(flame_vertices_fused(jfused, *a, ignore_global_rot=ignore_global_rot) * G)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in inputs))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    verts = flame_vertices(fused, *leaves, ignore_global_rot=ignore_global_rot)
    assert verts.grad_fn is not None
    got = torch.autograd.grad((verts * torch.from_numpy(G)).sum(), leaves)
    for name, a, w in zip(("shape", "exp", "pose"), got, want):
        assert _rel(a.numpy(), w) <= 1e-5, (name, _rel(a.numpy(), w))
    if ignore_global_rot:
        assert not got[2][:, :3].any()


def _stats():
    rs = np.random.RandomState(60)
    out = {}
    for k, n in (("shape", 100), ("exp", 50), ("pose", 6)):
        out[f"{k}_mean"] = (rs.randn(n) * 0.05).astype(np.float32)
        out[f"{k}_std"] = (0.2 + 0.3 * rs.rand(n)).astype(np.float32)
    return out


LOSS_CASES = [
    # (flame kind, starting, end_idx, no_constrain_prev, criterion, target, stats)
    ("model", True, False, False, "l2", "sample", False),
    ("model", False, False, False, "l2", "sample", True),
    ("model", False, True, True, "l1", "sample", False),
    ("fused", True, True, False, "l1", "sample", True),
    ("fused", False, False, False, "l2", "sample", True),
    ("fused", False, True, False, "l2", "sample", False),
    ("fused", False, False, True, "l2", "sample", True),
    ("fused", False, True, False, "l2", "noise", False),
]


@pytest.mark.parametrize("kind,starting,use_end,ncp,crit,target_kind,stats", LOSS_CASES)
def test_compute_loss_matches_jax(flames, kind, starting, use_end, ncp, crit, target_kind, stats):
    from msmd_tpu.config import MSMDConfig as JCfg
    from msmd_tpu.losses import compute_loss as jloss, load_loss_weights
    from msmd_tpu_torch.config import MSMDConfig
    from msmd_tpu_torch.losses import compute_loss

    jm, jfused, tm, fused = flames
    kw = dict(n_motions=6, n_prev_motions=3, rot_repr="aa", use_vertex_space=True, dataset_type="HDTF_TFHP",
              no_constrain_prev=ncp, criterion=crit, target=target_kind)
    jcfg, cfg = JCfg(**kw), MSMDConfig(**kw)
    B, L, Lp, D = 3, 6, 3, 67
    gt, prev = _rand((B, L, D), 70, 0.5), _rand((B, Lp, D), 71, 0.5)
    target, noise = _rand((B, Lp + L, D), 72, 0.5), _rand((B, L, D), 73)
    shape = _rand((B, 100), 74, 0.3)
    end_idx = np.array([2, 6, 4]) if use_end else None
    st = _stats() if stats else None
    weights = {k: v for k, v in load_loss_weights(jcfg).items() if k != "kl_div"}
    jflame = jfused if kind == "fused" else jm

    def jtotal(t):
        out = jloss(jcfg, starting, jnp.asarray(shape), jnp.asarray(gt), jnp.asarray(noise), t, jnp.asarray(prev),
                    None if st is None else {k: jnp.asarray(v) for k, v in st.items()}, jflame,
                    None if end_idx is None else jnp.asarray(end_idx))
        return sum(out[k] * w for k, w in weights.items()), out

    (_, want), jgrad = jax.value_and_grad(jtotal, has_aux=True)(jnp.asarray(target))
    tt = torch.from_numpy(target).requires_grad_(True)
    got = compute_loss(cfg, starting, torch.from_numpy(shape), torch.from_numpy(gt), torch.from_numpy(noise), tt,
                       torch.from_numpy(prev), st, fused if kind == "fused" else tm,
                       None if end_idx is None else torch.from_numpy(end_idx))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    if target_kind == "sample":
        assert float(got["vert"].detach()) > 0
    (grad,) = torch.autograd.grad(sum(got[k] * w for k, w in weights.items()), tt)
    jg = np.asarray(jgrad)
    assert np.abs(grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max() + 1e-9


def test_coefficient_helpers_match_jax(flames):
    from msmd_tpu import losses as jl
    from msmd_tpu_torch import losses as tl

    jm, jfused, tm, fused = flames
    motion, shape = _rand((2, 5, 67), 80, 0.5), _rand((2, 100), 81, 0.3)
    st = _stats()
    jd = jl.get_coef_dict(jnp.asarray(motion), jnp.asarray(shape), {k: jnp.asarray(v) for k, v in st.items()})
    td = tl.get_coef_dict(torch.from_numpy(motion), torch.from_numpy(shape), st)
    assert set(jd) == set(td) == {"exp", "pose", "shape"}
    for k in jd:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert not td["pose"][..., :3].any()
    full = {"exp": _rand((2, 5, 50), 82), "pose": _rand((2, 5, 6), 83)}
    for wg in (False, True):
        np.testing.assert_allclose(
            tl.get_motion_coef({k: torch.from_numpy(v) for k, v in full.items()}, "aa", wg, st).numpy(),
            np.asarray(jl.get_motion_coef({k: jnp.asarray(v) for k, v in full.items()}, "aa", wg, st)),
            rtol=1e-6, atol=1e-6)
    for flame_j, flame_t in ((jm, tm), (jfused, fused)):
        want = jl.coef_dict_to_vertices(jd, flame_j, ignore_global_rot=True)
        got = tl.coef_dict_to_vertices(td, flame_t, ignore_global_rot=True)
        assert tuple(got.shape) == want.shape == (2, 5, V, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
