"""Port vs JAX: SE(3) maps, the centered-frame conjugations and the 6x6
Cholesky solve (fast_gicp_tpu_torch.se3 / ops.linalg3 against
fast_gicp_tpu.se3 / ops.linalg3).

Tolerance 1e-6 absolute: both sides evaluate the same float32 formulas;
only the libm of sin/cos/arccos and the summation order of the small
matrix products differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu import se3 as jse3
from fast_gicp_tpu.ops import linalg3 as jlinalg3
from fast_gicp_tpu_torch import se3
from fast_gicp_tpu_torch.ops import linalg3

TOL = 1e-6


def _twists():
    rng = np.random.default_rng(7)
    return np.concatenate([
        rng.normal(size=(16, 6)) * 0.5,  # the exact branch
        rng.normal(size=(4, 6)) * 1e-6,  # theta^2 < 1e-10: the Taylor branch
        np.zeros((1, 6)),
    ]).astype(np.float32)


@pytest.mark.parametrize("fn", ["se3_exp", "so3_exp"])
def test_exp_matches_jax(fn):
    xi = _twists()
    arg = xi if fn == "se3_exp" else xi[:, :3]
    want = np.asarray(getattr(jse3, fn)(jnp.asarray(arg)))
    got = getattr(se3, fn)(torch.as_tensor(arg)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_log_matches_jax():
    xi = _twists()
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    # a rotation near pi exercises the symmetric-part axis branch
    T_pi = np.asarray(jse3.se3_exp(jnp.asarray(
        np.float32([[3.1, 0.2, -0.1, 0.5, 0.0, 1.0]]))))
    T = np.concatenate([T, T_pi])
    want = np.asarray(jse3.se3_log(jnp.asarray(T)))
    got = se3.se3_log(torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(
        se3.rotation_angle(torch.as_tensor(T[:, :3, :3])).numpy(),
        np.asarray(jse3.rotation_angle(jnp.asarray(T[:, :3, :3]))),
        atol=TOL, rtol=0,
    )


def test_centered_frame_maps_match_jax():
    rng = np.random.default_rng(3)
    x = np.array(jse3.se3_exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * 0.3)))
    c = (rng.normal(size=3) * 20).astype(np.float32)
    for name in ("conjugate_to_centered", "conjugate_from_centered"):
        want = np.asarray(getattr(jse3, name)(jnp.asarray(x), jnp.asarray(c)))
        got = getattr(se3, name)(torch.as_tensor(x), torch.as_tensor(c)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=TOL)
    np.testing.assert_allclose(
        se3.adjoint_translation(torch.as_tensor(c)).numpy(),
        np.asarray(jse3.adjoint_translation(jnp.asarray(c))), atol=TOL, rtol=0)
    P = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        se3.transform_points(torch.as_tensor(x), torch.as_tensor(P)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(x), jnp.asarray(P))),
        atol=TOL, rtol=0)


def test_cholesky_solve_matches_jax():
    rng = np.random.default_rng(11)
    A = rng.normal(size=(8, 6, 6)).astype(np.float32)
    H = A @ np.swapaxes(A, 1, 2) + 2.0 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    want = np.asarray(jlinalg3.cholesky_solve(jnp.asarray(H), jnp.asarray(b)))
    got = linalg3.cholesky_solve(torch.as_tensor(H), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=1e-5)
