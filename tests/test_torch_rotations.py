"""The port's rotations (``msmd_tpu_torch/ops/rotations.py``) against
``msmd_tpu/ops/rotations.py`` on the CPU: every public function on the
same numpy-seeded f32 inputs, to atol 1e-5 on angles and matrices
(different summation orders and transcendentals in f32; the values are
O(1)); the small-angle branches and the finite gradients at 0; the random
draws, which take a ``torch.Generator`` and so draw other numbers than
JAX's key, held by their properties (unit norm, orthonormal, det +1)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import msmd_tpu.ops.rotations as J
import msmd_tpu_torch.ops.rotations as T

ATOL = 1e-5


def _aa(n=32, scale=1.5, seed=0):
    return (np.random.RandomState(seed).randn(n, 3) * scale).astype(np.float32)


def _quats(n=32, seed=1):
    q = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _mats(n=32, seed=2):
    return np.asarray(J.axis_angle_to_matrix(jnp.asarray(_aa(n, seed=seed))))


def _both(name, *args, **kw):
    jout = getattr(J, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
    tout = getattr(T, name)(*(torch.as_tensor(np.array(a)) if isinstance(a, np.ndarray) else a for a in args),
                            **kw)
    return np.asarray(jout), tout.numpy()


UNARY = {
    "quaternion_to_matrix": _quats,
    "matrix_to_quaternion": _mats,
    "standardize_quaternion": lambda: _quats() * np.sign(np.random.RandomState(3).randn(32, 1)).astype(np.float32),
    "quaternion_invert": _quats,
    "axis_angle_to_quaternion": _aa,
    "quaternion_to_axis_angle": lambda: J.standardize_quaternion(jnp.asarray(_quats())).__array__(),
    "axis_angle_to_matrix": _aa,
    "matrix_to_axis_angle": _mats,
    "batch_rodrigues": _aa,
    "rotation_6d_to_matrix": lambda: np.random.RandomState(4).randn(32, 6).astype(np.float32),
    "matrix_to_rotation_6d": _mats,
    "axis_angle_to_rotation_6d": _aa,
    "rotation_6d_to_axis_angle": lambda: np.asarray(J.axis_angle_to_rotation_6d(jnp.asarray(_aa(seed=5)))),
    "rot_mat_to_euler": _mats,
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_functions_match_jax(name):
    got_j, got_t = _both(name, np.asarray(UNARY[name](), np.float32))
    assert got_t.dtype == np.float32
    np.testing.assert_allclose(got_t, got_j, atol=ATOL)


@pytest.mark.parametrize("name", ["quaternion_raw_multiply", "quaternion_multiply"])
def test_quaternion_products_match_jax(name):
    got_j, got_t = _both(name, _quats(seed=6), _quats(seed=7))
    np.testing.assert_allclose(got_t, got_j, atol=ATOL)


def test_quaternion_apply_matches_jax_and_refuses_2d_points():
    pts = np.random.RandomState(8).randn(32, 3).astype(np.float32)
    got_j, got_t = _both("quaternion_apply", _quats(), pts)
    np.testing.assert_allclose(got_t, got_j, atol=ATOL)
    with pytest.raises(ValueError, match="not in 3D"):
        T.quaternion_apply(torch.as_tensor(_quats()), torch.zeros(32, 2))


@pytest.mark.parametrize("convention", ["XYZ", "YXZ", "ZYX", "XZX", "YZY", "ZXZ"])
def test_euler_conversions_match_jax(convention):
    ang = (np.random.RandomState(9).rand(32, 3) * 2 - 1).astype(np.float32) * np.float32(1.2)
    got_j, got_t = _both("euler_angles_to_matrix", ang, convention)
    np.testing.assert_allclose(got_t, got_j, atol=ATOL)
    got_j, got_t = _both("matrix_to_euler_angles", _mats(), convention)
    np.testing.assert_allclose(got_t, got_j, atol=ATOL)


def test_euler_conversions_refuse_bad_conventions():
    with pytest.raises(ValueError, match="3 letters"):
        T.euler_angles_to_matrix(torch.zeros(2, 3), "XY")
    with pytest.raises(ValueError, match="Invalid input"):
        T.euler_angles_to_matrix(torch.zeros(2, 4), "XYZ")
    with pytest.raises(ValueError, match="X, Y or Z"):
        T.euler_angles_to_matrix(torch.zeros(2, 3), "XYW")
    with pytest.raises(ValueError, match="3 letters"):
        T.matrix_to_euler_angles(torch.eye(3)[None], "XYZX")


def test_private_regularisers_match_jax():
    x = np.array([-1.0, 0.0, 1e-30, 2.0, 9.0], np.float32)
    np.testing.assert_array_equal(T._sqrt_positive_part(torch.as_tensor(x)).numpy(),
                                  np.asarray(J._sqrt_positive_part(jnp.asarray(x))))
    a, b = np.array([1.0, -2.0, 3.0, 0.5], np.float32), np.array([-1.0, 1.0, 0.0, -0.0], np.float32)
    np.testing.assert_array_equal(T._copysign(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                                  np.asarray(J._copysign(jnp.asarray(a), jnp.asarray(b))))
    v = np.array([[0.0, 0.0, 0.0], [1e-7, 0.0, 0.0], [3.0, 4.0, 0.0]], np.float32)
    np.testing.assert_allclose(T._safe_norm(torch.as_tensor(v)).numpy(), np.asarray(J._safe_norm(jnp.asarray(v))),
                               atol=1e-7)


def test_small_angles_and_gradients_at_zero():
    aa = np.array([[1e-9, 0, 0], [0, 0, 0], [1e-4, 1e-4, -1e-4], [1e-7, -2e-7, 0]], np.float32)
    for name in ("axis_angle_to_quaternion", "axis_angle_to_matrix"):
        got_j, got_t = _both(name, aa)
        np.testing.assert_allclose(got_t, got_j, atol=1e-7)
    np.testing.assert_allclose(T.axis_angle_to_matrix(torch.as_tensor(aa))[1].numpy(), np.eye(3), atol=1e-6)
    x = torch.zeros(3, requires_grad=True)
    T.axis_angle_to_quaternion(x).sum().backward()
    g_j = jax.grad(lambda a: J.axis_angle_to_quaternion(a).sum())(jnp.zeros(3))
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), atol=1e-7)
    m = torch.eye(3, requires_grad=True)
    T.matrix_to_axis_angle(m[None]).sum().backward()
    assert torch.isfinite(m.grad).all()


def test_random_draws_are_rotations():
    g = torch.Generator().manual_seed(0)
    q = T.random_quaternions(g, 64)
    assert q.shape == (64, 4) and q.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), np.ones(64), atol=1e-6)
    m = T.random_rotations(g, 16, torch.float64)
    assert m.shape == (16, 3, 3) and m.dtype == torch.float64
    np.testing.assert_allclose((m @ m.transpose(-1, -2)).numpy(), np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-12)
    np.testing.assert_allclose(torch.linalg.det(m).numpy(), np.ones(16), atol=1e-12)
    r = T.random_rotation(g)
    assert r.shape == (3, 3)
    np.testing.assert_allclose(torch.linalg.det(r).item(), 1.0, atol=1e-5)
    # a seed draws the same rotations again; the default generator when None
    again = T.random_quaternions(torch.Generator().manual_seed(0), 64)
    assert torch.equal(q, again)
    assert T.random_quaternions(None, 3).shape == (3, 4)


def test_round_trips():
    q = T.standardize_quaternion(torch.as_tensor(_quats()))
    np.testing.assert_allclose(T.matrix_to_quaternion(T.quaternion_to_matrix(q)).numpy(), q.numpy(), atol=1e-5)
    aa = torch.as_tensor(_aa())
    m = T.axis_angle_to_matrix(aa)
    np.testing.assert_allclose(T.axis_angle_to_matrix(T.matrix_to_axis_angle(m)).numpy(), m.numpy(), atol=1e-5)
    np.testing.assert_allclose(T.rotation_6d_to_matrix(T.matrix_to_rotation_6d(m)).numpy(), m.numpy(), atol=1e-5)
