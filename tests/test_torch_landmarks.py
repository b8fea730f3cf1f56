"""The port's FLAME landmarks and texture (``msmd_tpu_torch/ops/lbs.py``,
``msmd_tpu_torch/models/flame.py``) against the JAX package's on the CPU:

- ``synthetic_flame``'s landmark buffers equal JAX's for a seed (and the
  vertex buffers stay equal: they are drawn first);
- ``vertices2landmarks`` with per-batch and shared indices, atol 1e-6;
- the dynamic contour's integer indices equal, over head yaws across
  -60..60 degrees (both sides of the +-39 degree caps);
- ``flame_forward`` with ``pose2rot`` True and False, ``ignore_global_rot``
  and eye poses, both landmark outputs, and ``select_3d68``: atol 1e-5
  (f32 sums in other orders); on ``load_flame``'s buffers too;
- ``load_flame_tex`` (BFM and FLAME layouts, both loaded equal to JAX's) and
  ``flame_tex_forward`` at sizes 512, 256 and 64, atol 1e-5 on values in
  [0, 1]: the resample is ``F.interpolate(antialias=True)`` against
  ``jax.image.resize``'s triangle filter. One texture file a layout for the
  module (786,432 x 199 f32, 626 MB), written and loaded once.
"""

import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msmd_tpu.models import flame as jf
from msmd_tpu.ops.lbs import vertices2landmarks as jv2l
from msmd_tpu_torch.models import flame as tf
from msmd_tpu_torch.ops.lbs import vertices2landmarks

V = 300
LMK = ("lmk_faces_idx", "lmk_bary_coords", "dynamic_lmk_faces_idx", "dynamic_lmk_bary_coords",
       "full_lmk_faces_idx", "full_lmk_bary_coords")


@pytest.fixture(scope="module")
def models():
    return jf.synthetic_flame(n_verts=V), tf.synthetic_flame(n_verts=V, device="cpu")


def _coefs(B, seed, pose_scale=0.4):
    rs = np.random.RandomState(seed)
    return [(rs.randn(B, n) * s).astype(np.float32) for n, s in ((100, 0.3), (50, 0.3), (6, pose_scale))]


def test_synthetic_flame_landmark_buffers_equal(models):
    j, t = models
    for name in LMK + ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_array_equal(t.neck_kin_chain, j.neck_kin_chain)


@pytest.mark.parametrize("shared", [True, False])
def test_vertices2landmarks_matches_jax(shared):
    rs = np.random.RandomState(0)
    B, F, L = 3, 40, 7
    verts = rs.randn(B, V, 3).astype(np.float32)
    faces = rs.randint(0, V, (F, 3)).astype(np.int64)
    idx = rs.randint(0, F, (L,) if shared else (B, L))
    bary = rs.rand(*((L, 3) if shared else (B, L, 3))).astype(np.float32)
    want = np.asarray(jv2l(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(idx), jnp.asarray(bary)))
    got = vertices2landmarks(torch.as_tensor(verts), faces, torch.as_tensor(idx), torch.as_tensor(bary))
    assert got.shape == (B, L, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_dynamic_contour_indices_equal(models):
    j, t = models
    B = 41
    pose = np.zeros((B, 6), np.float32)
    pose[:, 1] = np.deg2rad(np.linspace(-60, 60, B)).astype(np.float32)  # yaw across both caps
    pose[:, 0] = np.random.RandomState(1).randn(B).astype(np.float32) * 0.2
    full_j = jnp.concatenate([jnp.asarray(pose[:, :3]), jnp.zeros((B, 3)), jnp.asarray(pose[:, 3:]),
                              jnp.zeros((B, 6))], axis=1)
    want_idx, want_bary = jf._find_dynamic_lmk_idx_and_bcoords(j, full_j)
    got_idx, got_bary = tf._find_dynamic_lmk_idx_and_bcoords(t, tf.full_pose(torch.as_tensor(pose)))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_bary.numpy(), np.asarray(want_bary))
    # the rows span the capped (78), negative-mapped and positive entries of the table
    rows = {tuple(r) for r in got_idx.numpy()}
    assert len(rows) > 20


def _aa_to_mat_flat(aa):
    from msmd_tpu.ops.rotations import batch_rodrigues

    B = aa.shape[0]
    return np.array(batch_rodrigues(jnp.asarray(aa.reshape(-1, 3)))).reshape(B, -1)


@pytest.mark.parametrize("pose2rot", [True, False])
@pytest.mark.parametrize("ignore_global_rot", [False, True])
@pytest.mark.parametrize("eyes", [False, True])
def test_flame_forward_landmarks_match_jax(models, pose2rot, ignore_global_rot, eyes):
    j, t = models
    B = 5
    shape, exp, pose = _coefs(B, seed=2 + 2 * pose2rot + ignore_global_rot)
    eye = (np.random.RandomState(7).randn(B, 6) * 0.2).astype(np.float32) if eyes else None
    if not pose2rot:
        pose, eye = _aa_to_mat_flat(pose), None if eye is None else _aa_to_mat_flat(eye)
    kw = dict(pose2rot=pose2rot, ignore_global_rot=ignore_global_rot, return_lm2d=True, return_lm3d=True)
    jv, jl2, jl3 = jf.flame_forward(j, *map(jnp.asarray, (shape, exp, pose)),
                                    eye_pose_params=None if eye is None else jnp.asarray(eye), **kw)
    tv, tl2, tl3 = tf.flame_forward(t, *map(torch.as_tensor, (shape, exp, pose)),
                                    eye_pose_params=None if eye is None else torch.as_tensor(eye), **kw)
    assert tl2.shape == (B, 68, 3) and tl3.shape == (B, 68, 3)
    for got, want in ((tv, jv), (tl2, jl2), (tl3, jl3)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tf.select_3d68(t, tv).numpy(), np.asarray(jf.select_3d68(j, jv)), atol=1e-5)


def test_flame_forward_defaults_and_no_landmarks(models):
    j, t = models
    shape, exp, _ = _coefs(2, seed=9)
    for pose2rot in (True, False):
        tv, tl2, tl3 = tf.flame_forward(t, torch.as_tensor(shape), torch.as_tensor(exp), pose2rot=pose2rot)
        jv = jf.flame_forward(j, jnp.asarray(shape), jnp.asarray(exp), pose2rot=pose2rot)[0]
        assert tl2 is None and tl3 is None
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_load_flame_landmarks_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    Vf, J = 64, 5
    model = {
        "v_template": rng.randn(Vf, 3) * 0.1, "shapedirs": rng.randn(Vf, 3, 400) * 0.01,
        "posedirs": rng.randn(Vf, 3, (J - 1) * 9) * 0.001,
        "kintree_table": np.array([[4294967295, 0, 1, 1, 1], [0, 1, 2, 3, 4]], dtype=np.uint32),
        "weights": (lambda w: w / w.sum(1, keepdims=True))(rng.rand(Vf, J)),
        "f": rng.randint(0, Vf, (100, 3)).astype(np.uint32), "J_regressor": rng.rand(J, Vf) / Vf,
    }
    with open(tmp_path / "generic_model.pkl", "wb") as f:
        pickle.dump(model, f)
    lmk = {
        "static_lmk_faces_idx": rng.randint(0, 100, 51), "static_lmk_bary_coords": rng.rand(51, 3),
        "dynamic_lmk_faces_idx": rng.randint(0, 100, (79, 17)), "dynamic_lmk_bary_coords": rng.rand(79, 17, 3),
        "full_lmk_faces_idx": rng.randint(0, 100, (1, 68)), "full_lmk_bary_coords": rng.rand(1, 68, 3),
    }
    np.save(tmp_path / "landmark_embedding.npy", lmk, allow_pickle=True)
    paths = dict(flame_model_path=str(tmp_path / "generic_model.pkl"),
                 flame_lmk_embedding_path=str(tmp_path / "landmark_embedding.npy"))
    j, t = jf.load_flame(jf.FLAMEConfig(**paths)), tf.load_flame(tf.FLAMEConfig(**paths), device="cpu")
    shape, exp, pose = _coefs(3, seed=4, pose_scale=0.6)
    kw = dict(return_lm2d=True, return_lm3d=True)
    jout = jf.flame_forward(j, *map(jnp.asarray, (shape, exp, pose)), **kw)
    tout = tf.flame_forward(t, *map(torch.as_tensor, (shape, exp, pose)), **kw)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# texture
# ---------------------------------------------------------------------------

N_TEX_PIXELS = 512 * 512 * 3


@pytest.fixture(scope="module", params=["BFM", "FLAME"])
def tex(request, tmp_path_factory):
    """One texture space of the layout, written once: (kind, JAX's (mean,
    basis), the port's (mean, basis))."""
    kind = request.param
    path = tmp_path_factory.mktemp("tex") / f"tex_{kind}.npz"
    rng = np.random.default_rng(0)
    mean = rng.random(N_TEX_PIXELS, dtype=np.float32)
    basis = rng.standard_normal((N_TEX_PIXELS, 199), dtype=np.float32)
    if kind == "BFM":
        np.savez(path, MU=mean * np.float32(255.0), PC=basis)
    else:
        np.savez(path, mean=mean, tex_dir=basis / np.float32(255.0))
    del mean, basis
    j = jf.load_flame_tex(jf.FLAMEConfig(n_tex=50, tex_type=kind, tex_path=str(path)))
    t = tf.load_flame_tex(tf.FLAMEConfig(n_tex=50, tex_type=kind, tex_path=str(path)), device="cpu")
    path.unlink()
    return kind, j, t


def test_load_flame_tex_equals_jax(tex):
    _, (jmean, jbasis), (tmean, tbasis) = tex
    assert tmean.shape == (1, N_TEX_PIXELS) and tbasis.shape == (N_TEX_PIXELS, 50)
    assert tmean.dtype == tbasis.dtype == torch.float32
    np.testing.assert_array_equal(tmean.numpy(), np.asarray(jmean))
    np.testing.assert_array_equal(tbasis.numpy(), np.asarray(jbasis))


@pytest.mark.parametrize("size", [512, 256, 64])
def test_flame_tex_forward_matches_jax(tex, size):
    _, (jmean, jbasis), (tmean, tbasis) = tex
    code = (np.random.RandomState(size).randn(2, 50) * 0.5).astype(np.float32)
    want = np.asarray(jf.flame_tex_forward(jmean, jbasis, jnp.asarray(code), size=size))
    got = tf.flame_tex_forward(tmean, tbasis, torch.as_tensor(code), size=size)
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_load_flame_tex_refuses_unknown_type(tmp_path):
    np.savez(tmp_path / "tex.npz", MU=np.zeros(3, np.float32), PC=np.zeros((1, 199), np.float32))
    cfg = tf.FLAMEConfig(tex_type="nope", tex_path=str(tmp_path / "tex.npz"))
    with pytest.raises(ValueError, match="not supported"):
        tf.load_flame_tex(cfg, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        jf.load_flame_tex(jf.FLAMEConfig(tex_type="nope", tex_path=str(tmp_path / "tex.npz")))
