"""The device form of `solver.lsq_solve` (its loops conditional WHILE nodes
under CUDA graph capture; on the CPU the host loop over the same condition
tensors that `cuda_solver.loop_cond_plain` writes) against the eager solve,
bit for bit, and against the JAX package's `lsq_solve` within
tests/test_torch_solver.py's tolerances (pose 1e-5, Hessian rtol 1e-4, the
same iterations and flags).

Cases: every first trial accepted; rejected trials (the objective's error
plus a penalty k |x - x_lin|^2 on the step from the linearization pose,
which the normal equations do not model, so long steps are rejected until
lambda has grown); `lm_max_iterations` exhausted (a NaN objective with a tight
convergence test: the solve fails); a rejected step that meets the
convergence test (the NaN objective with the default epsilons); Gauss-Newton;
a two-phase VGICP solve (`vgicp_align`, refresh 2) on the small synthetic
pair; and `graphs.DeviceGraph`'s CPU form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu import solver as jsolver
from fast_gicp_tpu_torch import graphs, solver
from fast_gicp_tpu_torch.ops import cuda_solver

from test_torch_solver import _jax_objective, _problem, _torch_objective

FIELDS = ("transformation", "hessian", "error", "converged", "iterations")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _both(lin, err, x0, cfg, with_aux=False):
    """(eager result, device-form result, trials the device form ran)."""
    counts = cuda_solver.loop_counts("cpu")
    eager = solver.lsq_solve(lin, err, x0, cfg, with_aux=with_aux)
    counts.zero_()
    with graphs.device_loop():
        dev = solver.lsq_solve(lin, err, x0, cfg, with_aux=with_aux)
    return eager, dev, counts.clone()


def _bit_equal(a, b):
    for f in FIELDS:
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype and ta.shape == tb.shape, f
        assert torch.equal(ta, tb), (f, ta, tb)


def _cases():
    nan = float("nan")
    return {
        "first_trial_accepted": (solver.LsqConfig(), None),
        # a step penalty the normal equations do not model: rejections
        "rejected_trials": (solver.LsqConfig(), 1e4),
        # NaN at every trial pose and a convergence test no step meets
        "lm_exhausted": (solver.LsqConfig(lm_max_iterations=3, rotation_epsilon=1e-12,
                                          transformation_epsilon=1e-12), nan),
        # NaN at every trial pose: rejected until the step converges
        "rejected_but_converged": (solver.LsqConfig(), nan),
        "gauss_newton": (solver.LsqConfig(optimizer="gn"), None),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_device_form_is_the_eager_solve_and_matches_jax(case):
    cfg, twist = _cases()[case]
    P, Q, M, w, _T = _problem()
    lin, err = _torch_objective(P, Q, M, w)
    jlin, jerr = _jax_objective(P, Q, M, w)
    x0 = torch.eye(4)
    base, jbase, blin, jblin = err, jerr, lin, jlin
    if twist is not None and np.isnan(twist):
        err = lambda x, aux: base(x, aux) * float("nan")  # noqa: E731
        jerr = lambda x, aux: jbase(x, aux) * jnp.nan  # noqa: E731
    elif twist is not None:
        k = twist
        from fast_gicp_tpu_torch import se3
        x0 = se3.se3_exp(torch.tensor([0.0, 0.0, 0.5, 2.0, -1.0, 0.5]))

        def lin(x):
            e, H, b, aux = blin(x)
            return e, H, b, aux + (x.clone(),)

        def jlin(x):
            e, H, b, aux = jblin(x)
            return e, H, b, aux + (x,)

        err = lambda x, aux: base(x, aux[:2]) + k * torch.sum((x - aux[2]) ** 2)  # noqa: E731
        jerr = lambda x, aux: jbase(x, aux[:2]) + k * jnp.sum((x - aux[2]) ** 2)  # noqa: E731
    eager, dev, counts = _both(lin, err, x0, cfg)
    _bit_equal(eager, dev)
    jcfg = jsolver.LsqConfig(**cfg._asdict())
    jres = jsolver.lsq_solve(jlin, jerr, jnp.asarray(x0.numpy()), jcfg)
    np.testing.assert_allclose(dev.transformation.numpy(), np.asarray(jres.transformation),
                               atol=1e-5)
    assert int(dev.iterations) == int(jres.iterations)
    assert bool(dev.converged) == bool(jres.converged)
    np.testing.assert_allclose(dev.hessian.numpy(), np.asarray(jres.hessian), rtol=1e-4,
                               atol=1e-3)
    # the tally: one solve, an outer iteration a linearization, >= one trial each
    assert int(counts[3]) == 1 and int(counts[2]) == int(dev.iterations)
    if cfg.optimizer == "lm":
        assert int(counts[1]) >= int(counts[2])
    if case == "rejected_trials":
        assert int(counts[1]) > int(counts[2])  # some trial was rejected
    if case == "lm_exhausted":
        assert not bool(dev.converged) and int(dev.iterations) == 1
        assert int(counts[1]) == cfg.lm_max_iterations
    if case == "rejected_but_converged":
        assert bool(dev.converged) and torch.equal(dev.transformation, x0)


def test_device_form_with_aux_returns_the_last_linearization():
    P, Q, M, w, _T = _problem()
    lin, err = _torch_objective(P, Q, M, w)
    (eager, eaux), (dev, daux), _ = _both(lin, err, torch.eye(4), solver.LsqConfig(),
                                          with_aux=True)
    _bit_equal(eager, dev)
    assert all(torch.equal(a, b) for a, b in zip(eaux, daux))


def test_device_form_refuses_what_it_cannot_do():
    """debug_print reads the trials' floats to the host; the device form
    runs at least one iteration and one trial; a conditional handle exists
    only under CUDA capture."""
    P, Q, M, w, _T = _problem()
    lin, err = _torch_objective(P, Q, M, w)
    with graphs.device_loop():
        for cfg in (solver.LsqConfig(debug_print=True), solver.LsqConfig(max_iterations=0),
                    solver.LsqConfig(lm_max_iterations=0)):
            with pytest.raises(ValueError):
                solver.lsq_solve(lin, err, torch.eye(4), cfg)
    state = cuda_solver.lm_state(torch.eye(4))
    with pytest.raises(ValueError, match="handle"):
        cuda_solver.loop_cond(state, cuda_solver.loop_out(torch.device("cpu")),
                              cuda_solver.LOOP_OUTER_ENTER, solver.LsqConfig(), handle=7)
    assert not graphs.device_form(torch.device("cpu"))
    with graphs.device_loop():
        assert graphs.device_form(torch.device("cpu"))


def test_two_phase_vgicp_device_form_is_eager():
    """`vgicp_align` at refresh 2 (two sequential solves, each its own pair of
    loops) in the device form: the eager pose, iterations and Hessian bit
    for bit on the CPU test pair's RBF covariances."""
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig, vgicp_align
    from fast_gicp_tpu_torch.ops.covariance import rbf_covariances
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims
    from fast_gicp_tpu_torch.utils import downsample, synthetic
    from fast_gicp_tpu_torch.utils.padding import pad_points

    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=150_000)
    scans, _gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    t, s = (downsample.voxel_downsample(scans[i], 0.5) for i in (30, 31))
    sp, sm = pad_points(s)
    tp, tm = pad_points(t)
    scov = rbf_covariances(sp, sm, device="cpu")
    tcov = rbf_covariances(tp, tm, device="cpu")
    cfg = VGICPConfig(grid_dims=auto_grid_dims(t, 1.0), refresh_iterations=2)
    counts = cuda_solver.loop_counts("cpu")
    eager = vgicp_align(sp, sm, scov, tp, tm, tcov, np.eye(4), cfg, device="cpu")
    counts.zero_()
    with graphs.device_loop():
        dev = vgicp_align(sp, sm, scov, tp, tm, tcov, np.eye(4), cfg, device="cpu")
    _bit_equal(eager, dev)
    assert int(counts[3]) == 2 and int(counts[2]) == int(dev.iterations) > 2


def test_device_graph_cpu_form_runs_the_device_form():
    """On the CPU a `DeviceGraph` has no graph: each replay runs the function
    in the device form's plain version."""
    P, Q, M, w, _T = _problem()
    lin, err = _torch_objective(P, Q, M, w)
    x0 = torch.eye(4)
    seen = []

    def trip():
        seen.append(graphs.device_form(x0.device))
        return solver.lsq_solve(lin, err, x0)

    g = graphs.DeviceGraph(trip, "cpu")
    assert g.graph is None and not seen
    _bit_equal(g.replay(), solver.lsq_solve(lin, err, x0))
    assert seen == [True]
