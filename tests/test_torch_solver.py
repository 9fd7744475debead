"""Port vs JAX: the LM trial step's plain version (fast_gicp_tpu_torch.ops.
cuda_solver) against the Pallas kernel body `lm_trial_pallas` in interpret
mode, and the eager `lsq_solve` against the JAX package's while-loop solve
on a synthetic objective."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu import se3 as jse3
from fast_gicp_tpu import solver as jsolver
from fast_gicp_tpu.ops import pallas_solver
from fast_gicp_tpu.ops import soa as jsoa
from fast_gicp_tpu_torch import se3, solver
from fast_gicp_tpu_torch.ops import cuda_solver, soa


@pytest.mark.parametrize("scale, lam", [(1.0, 0.37), (1e-8, 0.0), (50.0, 3.0)])
def test_lm_trial_plain_matches_pallas(scale, lam):
    """The three (scale, lambda) cases of test_solver.py, the middle one in
    se3_exp's Taylor branch.  d: rtol 1e-5, atol 1e-7; delta and xi:
    rtol 1e-5, atol 1e-6 (the Pallas test's own tolerances: same f32
    formulas, different libm); denom rtol 1e-4."""
    rng = np.random.default_rng(1234 + int(lam * 100))
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = A @ A.T + 2.0 * np.eye(6, dtype=np.float32)
    b = (rng.normal(size=6) * scale).astype(np.float32)
    x = np.array(jse3.se3_exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * 0.3)))
    xi_j, delta_j, d_j, denom_j = pallas_solver.lm_trial_pallas(
        jnp.asarray(H), jnp.asarray(b), jnp.float32(lam), jnp.asarray(x),
        interpret=True)
    xi, delta, d, denom = cuda_solver.lm_trial(
        torch.as_tensor(H), torch.as_tensor(b),
        torch.tensor([lam], dtype=torch.float32), torch.as_tensor(x))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xi.numpy(), np.asarray(xi_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(denom), float(denom_j), rtol=1e-4, atol=1e-10)


def _problem(seed=3, n=512):
    """Weighted point-to-point Mahalanobis objective with a known pose:
    q = T_gt p + 1 mm noise, random SPD M per point, 10% masked."""
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(n, 3)) * 4.0).astype(np.float32)
    T_gt = np.array(jse3.se3_exp(jnp.asarray(
        np.float32([0.05, -0.08, 0.12, 0.3, -0.2, 0.15]))))
    q = p @ T_gt[:3, :3].T + T_gt[:3, 3] + rng.normal(size=(n, 3)) * 1e-3
    A = rng.normal(size=(n, 3, 3))
    M = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3)
    M6 = M.reshape(n, 9)[:, [0, 1, 2, 4, 5, 8]].T
    w = (rng.uniform(size=n) > 0.1).astype(np.float32)
    f32 = lambda a: np.array(a, np.float32)  # noqa: E731
    return f32(p.T), f32(q.T), f32(M6), w, T_gt


def _torch_objective(P, Q, M, w):
    P, Q, M, w = (torch.as_tensor(a) for a in (P, Q, M, w))

    def linearize(x):
        err, H, b = soa.linearize_cols(soa.transform_cols(x, P), Q, M, w)
        return err, H, b, (M, w)

    def error(x, aux):
        return soa.error_cols(soa.transform_cols(x, P), Q, aux[0], aux[1])

    return linearize, error


def _jax_objective(P, Q, M, w):
    P, Q, M, w = (jnp.asarray(a) for a in (P, Q, M, w))
    valid = w > 0

    def linearize(x):
        err, H, b = jsoa.linearize_cols(jsoa.transform_cols(x, P), Q, M, w, valid)
        return err, H, b, (M, w)

    def error(x, aux):
        return jsoa.error_cols(jsoa.transform_cols(x, P), Q, aux[0], aux[1], valid)

    return linearize, error


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_lsq_solve_recovers_pose_and_matches_jax(optimizer):
    """Both solves recover the pose to 1e-3; the port's pose matches the
    JAX package's to 1e-5 with the same iteration count, convergence flag
    and (rtol 1e-4) Hessian -- the LM schedule runs in f32 on both."""
    P, Q, M, w, T_gt = _problem()
    cfg = solver.LsqConfig(optimizer=optimizer)
    jcfg = jsolver.LsqConfig(optimizer=optimizer)
    res = solver.lsq_solve(*_torch_objective(P, Q, M, w), torch.eye(4), cfg)
    jres = jsolver.lsq_solve(*_jax_objective(P, Q, M, w), jnp.eye(4), jcfg)
    T = res.transformation.numpy()
    np.testing.assert_allclose(T, T_gt, atol=1e-3)
    np.testing.assert_allclose(T, np.asarray(jres.transformation), atol=1e-5)
    assert int(res.iterations) == int(jres.iterations)
    assert bool(res.converged) and bool(jres.converged)
    np.testing.assert_allclose(res.hessian.numpy(), np.asarray(jres.hessian),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(res.error), float(jres.error), rtol=1e-3,
                               atol=1e-6)


def test_lsq_solve_host_syncs_and_aux():
    """One host read per LM trial; `with_aux` returns the last
    linearization's frozen state."""
    P, Q, M, w, _T = _problem()
    lin, err = _torch_objective(P, Q, M, w)
    solver.lsq_solve.host_syncs = 0
    res, aux = solver.lsq_solve(lin, err, torch.eye(4), with_aux=True)
    assert solver.lsq_solve.host_syncs >= int(res.iterations)
    assert isinstance(aux, tuple) and aux[0].shape == (6, P.shape[1])
    # zero iterations allowed: aux keeps the shape, zero-filled
    res0, aux0 = solver.lsq_solve(lin, err, torch.eye(4),
                                  solver.LsqConfig(max_iterations=0),
                                  with_aux=True)
    assert int(res0.iterations) == 0 and float(aux0[0].abs().sum()) == 0.0


def test_lsq_solve_rejects_nan_trials():
    """NaN-safe accept: an objective that is NaN at every trial pose never
    moves the pose.  Each rejection grows lambda until the rejected step is
    small enough to pass the convergence test, which ends the solve as
    converged in its first iteration, in both packages."""
    P, Q, M, w, _T = _problem()
    lin, err = _torch_objective(P, Q, M, w)
    x0 = torch.eye(4)
    res = solver.lsq_solve(lin, lambda x, aux: err(x, aux) * float("nan"), x0)
    assert torch.equal(res.transformation, x0)
    jlin, jerr = _jax_objective(P, Q, M, w)
    jres = jsolver.lsq_solve(jlin, lambda x, aux: jerr(x, aux) * jnp.nan, jnp.eye(4))
    np.testing.assert_array_equal(np.asarray(jres.transformation), np.eye(4))
    assert int(res.iterations) == int(jres.iterations) == 1
    assert bool(res.converged) == bool(jres.converged)


def test_is_converged_matches_jax():
    for xi in ([1e-4, 0, 0, 1e-4, 0, 0], [3e-3, 0, 0, 0, 0, 0], [0, 0, 0, 0, 6e-4, 0]):
        xi = np.float32(xi)
        delta = np.array(jse3.se3_exp(jnp.asarray(xi)))
        assert bool(solver.is_converged(se3.se3_exp(torch.as_tensor(xi)), 2e-3, 5e-4)) \
            == bool(jsolver.is_converged(jnp.asarray(delta), 2e-3, 5e-4))
