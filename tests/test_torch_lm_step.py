"""The LM trial as one step (fast_gicp_tpu_torch.ops.cuda_solver.lm_step)
on the CPU, where it takes its plain version `lm_step_plain`:

* bit-equal to the eager trial sequence `solver.lsq_solve` ran before the
  step was one call (kept below as `_eager_trial`), on the schedule's cases
  (lambda init, accept, accept at the 1/3 clamp, reject, conv_reject, a
  NaN error), for the GICP and the NDT cost;
* against the JAX package's inner LM body (`fast_gicp_tpu/solver.py`
  lm_step / inner_body) driven by `lm_trial_pallas(interpret=True)` and the
  Pallas error kernels in interpret mode on the same numpy inputs: flags
  equal, x, lambda and nu within 1e-6;
* `lsq_solve` keeping the eager loop's iterations, pose, Hessian and host
  syncs on seeded GICP and NDT objectives;
* `TrialCost.plain`, the one plain form of both weights, equal to
  `error_plain` and `ndt_error_plain`.

Inputs: a registration-like objective with a known pose (targets = the
source under a ground-truth pose plus 1 cm noise), linearized 0.15 rad
and 0.4 m away from it; y0 is set from the trial's own error and denominator
to put rho where each case needs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu import se3 as jse3
from fast_gicp_tpu import solver as jsolver
from fast_gicp_tpu.ops import pallas_linearize, pallas_solver
from fast_gicp_tpu_torch import solver
from fast_gicp_tpu_torch.ops import cuda_linearize, cuda_ndt, cuda_solver

L = 2048  # lanes: a multiple of the Pallas error kernels' 2,048-lane tile
NDT_OFFSETS = 4
RESOLUTION = 1.0
CONFIG = solver.LsqConfig()


def _pose(xi):
    return np.array(jse3.se3_exp(jnp.asarray(np.float32(xi))))


def _spd(rng, n, scale, floor):
    A = rng.normal(size=(n, 3, 3))
    C = A @ np.swapaxes(A, 1, 2) * scale + floor * np.eye(3)
    return C.reshape(n, 9)[:, [0, 1, 2, 4, 5, 8]]


def _gicp(seed=5):
    """(linearize(x), TrialCost, P) of a GICP objective over L points with
    finalized target rows; 10% of the correspondences invalid."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(L, 3)) * 4.0
    T = _pose([0.05, -0.08, 0.12, 0.3, -0.2, 0.15])
    q = p @ T[:3, :3].T + T[:3, 3] + rng.normal(size=(L, 3)) * 0.01
    cov_b = _spd(rng, L, 0.01, 0.01)
    cov9 = cov_b[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]]
    rows = np.concatenate([q, cov9, np.ones((L, 1)), np.zeros((L, 3))], axis=1)
    valid = (rng.uniform(size=L) > 0.1).astype(np.float32)
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"))  # noqa: E731
    P, CA, rows, valid = f32(p.T), f32(_spd(rng, L, 0.01, 0.01).T), f32(rows), f32(valid)

    def linearize(x):
        return cuda_linearize.linearize(P, CA, x, rows, valid)

    return linearize, cuda_solver.TrialCost(P), P


def _ndt(seed=6):
    """(linearize(x), TrialCost, P) of an NDT P2D objective over
    NDT_OFFSETS x N lanes (offset-major, the source tiled), a finalized pack
    [mu, M, valid]: offset k's voxel mean 0.3 k m off the true match."""
    rng = np.random.default_rng(seed)
    n = L // NDT_OFFSETS
    p = rng.normal(size=(n, 3)) * 4.0
    T = _pose([0.05, -0.08, 0.12, 0.3, -0.2, 0.15])
    q = p @ T[:3, :3].T + T[:3, 3]
    mu = np.concatenate([q + 0.3 * k + rng.normal(size=(n, 3)) * 0.01
                         for k in range(NDT_OFFSETS)])
    valid = (rng.uniform(size=L) > 0.1).astype(np.float32)
    pack = np.concatenate([mu, _spd(rng, L, 1.0, 0.5), valid[:, None], np.zeros((L, 6))],
                          axis=1)
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32, order="C"))  # noqa: E731
    P, pack = f32(np.tile(p.T, (1, NDT_OFFSETS))), f32(pack)

    def linearize(x):
        return cuda_ndt.ndt_linearize(P, None, x, pack, RESOLUTION, "p2d")

    return linearize, cuda_solver.TrialCost(P, offsets=NDT_OFFSETS, resolution=RESOLUTION), P


OBJECTIVES = {"gicp": _gicp, "ndt": _ndt}
X_LIN = [0.0] * 6  # the linearization pose: the identity, 0.15 rad and 0.4 m off

# case -> (first trial, lambda (x max|diag H|; "conv": large enough that the
# step passes the convergence test), rho the case puts the trial at, NaN aux)
CASES = {
    "lambda_init": (True, None, 1.0, False),
    "accept_clamp": (False, 1e-6, 1.0, False),
    "accept": (False, 1e-6, 0.3, False),
    "reject": (False, 1e-6, -0.5, False),
    "conv_reject": (False, "conv", -10.0, False),
    "nan_error": (False, 1e-6, 0.5, True),
}


def _eager_trial(H, b, lam, nu, x, y0, aux, error_fn, first, config):
    """The LM trial as `lsq_solve` ran it as eager ops (the standalone trial
    step, the error, the schedule), with the lambda init of its outer
    iteration: (x, lam, nu, done, conv)."""
    if first:
        lam = torch.where(
            lam < 0.0,
            config.lm_init_lambda_factor * torch.max(torch.abs(torch.diagonal(H))),
            lam,
        ).reshape(1)
        nu = torch.full((), 2.0)
    xi, delta, d, denom = cuda_solver.lm_trial(H, b, lam, x)
    yi = error_fn(xi, aux)
    rho = (y0 - yi) / denom
    reject = ~(rho >= 0.0)
    delta_conv = solver.is_converged(delta, config.rotation_epsilon,
                                     config.transformation_epsilon)
    conv_reject = reject & delta_conv
    accept = ~reject
    lam = torch.where(
        accept,
        lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
        torch.where(conv_reject, lam, nu * lam),
    )
    nu = torch.where(reject & ~conv_reject, 2.0 * nu, nu)
    x = torch.where(accept, xi, x)
    done, conv = torch.stack([accept | conv_reject, delta_conv]).tolist()
    return x, lam, nu, done, conv


def _case(objective, case):
    """(state before the step, H, b, y0, aux, cost, first) for `case`."""
    linearize, cost, _P = OBJECTIVES[objective]()
    first, lam_scale, rho, nan = CASES[case]
    x = torch.as_tensor(_pose(X_LIN))
    _err, H, b, aux = linearize(x)
    if nan:
        aux = aux.clone()
        aux[0, 7] = float("nan")
    if lam_scale is None:
        lam = -1.0
    elif lam_scale == "conv":  # |d| ~ 1e-5, under the 5e-4 m / 2e-3 tests
        lam = 1e5 * float(b.abs().max())
    else:
        lam = lam_scale * float(torch.diagonal(H).abs().max())
    state = cuda_solver.lm_state(x)
    state[cuda_solver.STATE_LAM] = lam
    state[cuda_solver.STATE_NU] = 4.0  # a solve two rejections in
    # y0 from the trial's own error and denominator: rho where the case needs it
    lam_used = torch.tensor([lam if lam > 0 else
                             CONFIG.lm_init_lambda_factor * float(torch.diagonal(H).abs().max())],
                            dtype=torch.float32)
    xi, _delta, _d, denom = cuda_solver.lm_trial(H, b, lam_used, x)
    yi = cost(xi, aux)
    y0 = yi + rho * denom if not nan else _err
    return state, H, b, y0.reshape(()), aux, cost, first


def _bits(t):
    return t.detach().reshape(-1).view(torch.int32)


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
@pytest.mark.parametrize("case", list(CASES))
def test_lm_step_plain_bit_equal_to_eager_trial(objective, case):
    """`lm_step` on CPU tensors (its plain version) leaves x, lambda, nu and
    the flags bit-equal to the eager trial, and the case is what it says."""
    state, H, b, y0, aux, cost, first = _case(objective, case)
    lam0 = state[cuda_solver.STATE_LAM:cuda_solver.STATE_LAM + 1].clone()
    nu0 = state[cuda_solver.STATE_NU].clone()
    x0 = state[cuda_solver.STATE_X].view(4, 4).clone()
    x, lam, nu, done, conv = _eager_trial(H, b, lam0, nu0, x0, y0, aux, cost, first, CONFIG)
    cuda_solver.lm_step.launches = 0
    cuda_solver.lm_step(state, H, b, y0, aux, cost, first, CONFIG)
    assert cuda_solver.lm_step.launches == 0
    assert torch.equal(_bits(state[cuda_solver.STATE_X]), _bits(x))
    assert torch.equal(_bits(state[cuda_solver.STATE_LAM]), _bits(lam))
    assert torch.equal(_bits(state[cuda_solver.STATE_NU]), _bits(nu))
    assert [state[cuda_solver.STATE_DONE].item(), state[cuda_solver.STATE_CONV].item()] \
        == [float(done), float(conv)]
    accepted = not torch.equal(x, x0)
    lam_used = float(state[cuda_solver.STATE_LAM_USED])
    clamped = float(lam) == float(np.float32(lam_used) * np.float32(1.0 / 3.0))
    expect = {"lambda_init": accepted and clamped,
              "accept_clamp": accepted and clamped,
              "accept": accepted and not clamped and float(lam) > lam_used,
              "reject": not done and not accepted and float(nu) == 8.0,
              "conv_reject": done and conv and not accepted and float(lam) == lam_used,
              "nan_error": not done and not accepted
              and np.isnan(float(state[cuda_solver.STATE_YI]))}
    assert expect[case], (case, done, conv, accepted, float(lam), lam_used)
    if case == "lambda_init":
        assert lam_used == pytest.approx(1e-9 * float(torch.diagonal(H).abs().max()), rel=1e-6)


def _jax_cost(objective, P, aux):
    aux16 = jnp.concatenate([jnp.asarray(aux.numpy()), jnp.zeros((6, L), jnp.float32)])
    p8 = jnp.concatenate([jnp.asarray(P.numpy()), jnp.zeros((5, L), jnp.float32)])
    if objective == "gicp":
        return lambda x: pallas_linearize.error_pallas(p8, aux16, x, interpret=True)
    return lambda x: pallas_linearize.ndt_error_pallas(p8, aux16, x, RESOLUTION,
                                                       interpret=True)


def _jax_trial(H, b, lam, nu, x, y0, cost, first, config):
    """The JAX package's lm_step lambda init and inner_body
    (fast_gicp_tpu/solver.py), its trial step the Pallas kernel."""
    if first:
        lam = jnp.where(lam < 0.0,
                        config.lm_init_lambda_factor * jnp.max(jnp.abs(jnp.diag(H))), lam)
        nu = jnp.asarray(2.0, jnp.float32)
    xi, delta, _d, denom = pallas_solver.lm_trial_pallas(H, b, lam, x, interpret=True)
    yi = cost(xi)
    rho = (y0 - yi) / denom
    reject = ~(rho >= 0.0)
    delta_conv = jsolver.is_converged(delta, config.rotation_epsilon,
                                      config.transformation_epsilon)
    conv_reject = reject & delta_conv
    accept = ~reject
    new_lam = jnp.where(accept, lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                        jnp.where(conv_reject, lam, nu * lam))
    new_nu = jnp.where(reject & ~conv_reject, 2.0 * nu, nu)
    new_x = jnp.where(accept, xi, x)
    return new_x, new_lam, new_nu, bool(accept | conv_reject), bool(delta_conv)


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
@pytest.mark.parametrize("case", list(CASES))
def test_lm_step_plain_matches_jax_inner_body(objective, case):
    """Flags equal; x, lambda and nu within 1e-6 relative (x: atol 1e-7 on
    its near-zero entries)."""
    state, H, b, y0, aux, cost, first = _case(objective, case)
    _lin, _cost, P = OBJECTIVES[objective]()
    lam0 = float(state[cuda_solver.STATE_LAM])
    nu0 = float(state[cuda_solver.STATE_NU])
    x0 = state[cuda_solver.STATE_X].view(4, 4).numpy().copy()
    jcfg = jsolver.LsqConfig()
    x, lam, nu, done, conv = _jax_trial(
        jnp.asarray(H.numpy()), jnp.asarray(b.numpy()), jnp.float32(lam0), jnp.float32(nu0),
        jnp.asarray(x0), jnp.float32(float(y0)), _jax_cost(objective, P, aux), first, jcfg)
    cuda_solver.lm_step(state, H, b, y0, aux, cost, first, CONFIG)
    assert [bool(state[cuda_solver.STATE_DONE]), bool(state[cuda_solver.STATE_CONV])] \
        == [done, conv]
    np.testing.assert_allclose(state[cuda_solver.STATE_X].view(4, 4).numpy(), np.asarray(x),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(state[cuda_solver.STATE_LAM]), float(lam), rtol=1e-6)
    np.testing.assert_allclose(float(state[cuda_solver.STATE_NU]), float(nu), rtol=1e-6)


def _eager_lsq_solve(linearize_fn, error_fn, x0, config):
    """`lsq_solve`'s LM loop as it ran before the trial was one step: the
    eager trial above, one stacked flag read a trial.  (pose, H, y,
    converged, iterations, host reads)."""
    dtype = x0.dtype
    x = x0.to(dtype).contiguous()
    lam = torch.full((), -1.0)
    H_out = torch.eye(6)
    y = torch.full((), 0.0)
    converged, reads, i = False, 0, 0
    while i < config.max_iterations:
        y0, H, b, _aux = linearize_fn(x)
        nu = torch.full((), 2.0)
        done, conv = False, False
        for j in range(config.lm_max_iterations):
            x, lam, nu, done, conv = _eager_trial(H, b, lam, nu, x, y0, _aux, error_fn,
                                                  j == 0, config)
            reads += 1
            if done:
                break
        converged = conv and done
        if done:
            H_out = H
        y = y0
        i += 1
        if not done or conv:
            break
    return x, H_out, y, converged, i, reads


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
def test_lsq_solve_keeps_eager_iterations_pose_and_host_syncs(objective):
    """The solve with one step a trial takes the eager loop's iterations and
    host syncs, and lands on its pose and Hessian bit for bit."""
    linearize, cost, _P = OBJECTIVES[objective]()
    x0 = torch.as_tensor(_pose(X_LIN))
    x_e, H_e, y_e, conv_e, iters_e, reads_e = _eager_lsq_solve(linearize, cost, x0, CONFIG)
    solver.lsq_solve.host_syncs = 0
    res = solver.lsq_solve(linearize, cost, x0, CONFIG)
    assert int(res.iterations) == iters_e and iters_e > 1
    assert solver.lsq_solve.host_syncs == reads_e
    assert bool(res.converged) == conv_e
    assert torch.equal(res.transformation, x_e)
    assert torch.equal(res.hessian, H_e) and torch.equal(res.error, y_e)
    assert torch.equal(x0, torch.as_tensor(_pose(X_LIN)))  # x0 is not written


@pytest.mark.parametrize("form", ["gicp", "ndt_tiled", "ndt_untiled", "ndt_one_offset"])
def test_trial_cost_plain_equals_error_plains(form):
    """`TrialCost.plain` (one form for both weights) equals `error_plain` and
    `ndt_error_plain` bit for bit, and the cost's call (the wrappers' plain
    versions on the CPU) does too."""
    objective = "gicp" if form == "gicp" else "ndt"
    linearize, cost, P = OBJECTIVES[objective]()
    _err, _H, _b, aux = linearize(torch.as_tensor(_pose(X_LIN)))
    x2 = torch.as_tensor(_pose([0.02, -0.01, 0.03, 0.05, 0.1, -0.02]))
    if form == "gicp":
        want = cuda_linearize.error_plain(P, x2, aux)
    else:
        want = cuda_ndt.ndt_error_plain(P, aux, x2, cuda_ndt._c_sq(RESOLUTION))
        N = L // NDT_OFFSETS
        cost = {"ndt_tiled": cost,
                "ndt_untiled": cost._replace(p=P[:, :N].contiguous()),
                "ndt_one_offset": cost._replace(offsets=1)}[form]
    assert torch.equal(cost.plain(x2, aux), want)
    assert torch.equal(cost(x2, aux), want)
