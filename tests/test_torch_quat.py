"""The port's quaternion and rotation operations against the JAX package's.

``posendf_torch/quat.py`` against ``posendf_tpu/quat.py`` on the same
numpy-seeded inputs: random rotations, the zero rotation, rotations below
the small-angle branch's threshold and rotations near pi. Both sides are
fp32 closed forms on the CPU; measured apart by at most 7.2e-7 (values;
the gradients below came out equal), so the bar is 2e-6. Gradients at the zero rotation,
where the solvers start, must be finite and equal to ``jax.grad``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from posendf_tpu import quat as jq  # noqa: E402

from posendf_torch import quat as tq  # noqa: E402

TOL = 2e-6


def _aa(n=64, seed=0):
    """Axis-angle rows: random angles in [0, pi), four zero rotations, four
    within 1e-1..1e-4 of pi and two below the Taylor threshold (1e-7)."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    aa = axis * rng.uniform(0.0, np.pi, size=(n, 1))
    aa[:4] = 0.0
    aa[4:8] = axis[4:8] * (np.pi - 10.0 ** -np.arange(1, 5))[:, None]
    aa[8:10] = axis[8:10] * 1e-7
    return aa.astype(np.float32)


def _quats(n=64, seed=0):
    """Unit quaternions of ``_aa``, every other one negated (w < 0 too)."""
    q = np.array(jq.axis_angle_to_quaternion(jnp.asarray(_aa(n, seed))))
    q[1::2] *= -1.0
    return q


def _rand_quats(shape, seed):
    q = np.random.default_rng(seed).normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _mats():
    return np.asarray(jq.axis_angle_to_matrix(jnp.asarray(_aa())))


CASES = {
    "axis_angle_to_quaternion": lambda: ((_aa(),), {}),
    "quaternion_to_axis_angle": lambda: ((_quats(),), {}),
    "quaternion_to_matrix": lambda: ((_quats(),), {}),
    "axis_angle_to_matrix": lambda: ((_aa(),), {}),
    "matrix_to_quaternion": lambda: ((_mats(),), {}),
    "matrix_to_rotation_6d": lambda: ((_mats(),), {}),
    "rotation_6d_to_matrix": lambda: ((np.random.default_rng(1).normal(
        size=(64, 6)).astype(np.float32),), {}),
    "quat_flip": lambda: ((_quats(),), {}),
    "quat_normalize": lambda: ((2.0 * _quats(),), {}),
    "joint_axis_normalize": lambda: ((_rand_quats((8, 21), 2),), {}),
    "quat_conjugate": lambda: ((_quats(),), {}),
    "quat_multiply": lambda: ((_quats(), _quats(seed=3)), {}),
    "quat_geodesic_distance": lambda: ((_rand_quats((16, 21), 4), _rand_quats((16, 21), 5)), {}),
    "weighted_quat_geodesic_distance": lambda: ((_rand_quats((16, 21), 4),
                                                 _rand_quats((16, 21), 5)), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax(name):
    args, kw = CASES[name]()
    want = getattr(jq, name)(*(jnp.asarray(a) for a in args), **kw)
    got = getattr(tq, name)(*(_t(a) for a in args), **kw)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("t", [0.3, [0.0, 0.25, 0.5, 1.0]])
def test_quat_slerp_matches_jax(t):
    """Random pairs, a pair on opposite hemispheres (q1 flipped) and exactly
    parallel pairs (the linear branch)."""
    q0 = _rand_quats((8, 21), 6)
    q1 = _rand_quats((8, 21), 7)
    q1[1] = -q1[1]
    q1[2] = q0[2]
    q1[3] = -q0[3]
    want = jq.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t, jnp.float32))
    got = tq.quat_slerp(_t(q0), _t(q1), t)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_round_trips():
    """aa -> q -> aa, R -> q -> R and R -> 6D -> R return their input."""
    aa = _t(_aa())
    _close(tq.quaternion_to_axis_angle(tq.axis_angle_to_quaternion(aa)), aa.numpy(), 2e-5)
    m = tq.axis_angle_to_matrix(aa)
    _close(tq.quaternion_to_matrix(tq.matrix_to_quaternion(m)), m.numpy(), 2e-5)
    _close(tq.rotation_6d_to_matrix(tq.matrix_to_rotation_6d(m)), m.numpy(), 2e-5)
    q = _t(_quats())
    _close(tq.quat_multiply(q, tq.quat_conjugate(q)),
           np.broadcast_to(np.asarray([1.0, 0, 0, 0], np.float32), q.shape), 2e-6)


GRAD_CASES = {
    # (function, input at the zero rotation or a parallel pair)
    "axis_angle_to_quaternion": lambda m: (m.axis_angle_to_quaternion, np.zeros((3, 3))),
    "axis_angle_to_matrix": lambda m: (m.axis_angle_to_matrix, np.zeros((3, 3))),
    "quaternion_to_axis_angle": lambda m: (
        m.quaternion_to_axis_angle, np.tile([1.0, 0.0, 0.0, 0.0], (3, 1))),
    "quat_slerp_parallel": lambda m: (
        lambda q: m.quat_slerp(q, q * 1.0, 0.4), np.tile([0.5, 0.5, 0.5, 0.5], (3, 1))),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_gradient_at_the_zero_rotation_matches_jax(name):
    """The double-where branches: finite gradients where the formula is
    singular, equal to JAX's. The loss weights every output entry."""
    jfn, x = GRAD_CASES[name](jq)
    tfn, _ = GRAD_CASES[name](tq)
    x = np.asarray(x, np.float32)
    wshape = np.asarray(jfn(jnp.asarray(x))).shape
    w = np.random.default_rng(8).normal(size=wshape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad((tfn(xt) * _t(w)).sum(), xt)
    assert bool(torch.isfinite(g).all())
    _close(g, want)
