"""The port's SLAM back-end solvers (`fast_gicp_tpu_torch/models/pose_graph.py`,
`models/pose_graph_sparse.py`, the block-tridiagonal preconditioner of
`ops/cuda_pose_graph.py`) with device="cpu", held to the JAX package's
functions on the same numpy inputs (the JAX side on the CPU, as its own
tests run it).

The graphs are the JAX tests' own (`tests/test_pose_graph.py`): the
10-pose chain of `test_loop_closure_corrects_drift` with noisy odometry and
one loop edge at 1e4 I, a 6-pose chain with a marginalization prior, and
`SlidingWindowBA` at window 6.  JAX compiles one shape per solver and
config, so the cases share shapes and configs.  Tolerances:
  * the se3 helpers' jacfwd within 1e-5 of JAX's (measured <= 2.4e-7);
  * the block-Thomas solve within 1e-5 of max|x| on well-conditioned
    systems (measured <= 3.1e-7): chains whose poses each carry an SPD
    block, at every lambda, and bare chains anchored only at pose 0 at
    lambda >= 0.1.  A bare chain at lambda <= 1e-4 and K >= 17 is so ill
    conditioned that float32 parts both packages from the float64 solution
    (by up to 3.3e-2 at K = 64) and from each other by as much: over six
    seeds the port's float64 error was 0.1-78x JAX's, the same with an
    explicit C_k^-1 as with triangular solves, so those are not compared;
    against a float64 dense solve of the assembled system, the anchored
    chains within 1e-5 of max|x| too (measured <= 3.1e-7);
  * poses within 1e-4, the error within 1e-4 relative, `converged` equal.
    Iterations are equal where the convergence test (max |delta| < 1e-6)
    is decided clear of float32's noise: at convergence_delta = 1e-5.  At
    the default 1e-6 the third step of the 10-pose graph is noise (JAX's
    moves a pose by 1.4e-6, the port's by 9.5e-7, poses ~10 m from the
    origin where a float32 step is 9.5e-7), so the counts may part by one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from fast_gicp_tpu import se3 as jse3
from fast_gicp_tpu.models import pose_graph as JD
from fast_gicp_tpu.models import pose_graph_sparse as JS
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch import se3
from fast_gicp_tpu_torch.models import pose_graph as TD
from fast_gicp_tpu_torch.models import pose_graph_sparse as TS
from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

POSE_TOL = 1e-4
SW_CONFIG = dict(max_iterations=10)  # SlidingWindowBA's and the prior case's


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _chain(k, step=(0, 0, 0.15, 1.0, 0.1, 0)):
    """Ground-truth pose chain with a gentle turn (test_pose_graph._chain)."""
    T = np.eye(4)
    poses = []
    step_T = np.asarray(jse3.se3_exp(jnp.asarray(np.float32(step))), np.float64)
    for _ in range(k):
        poses.append(T.copy())
        T = T @ step_T
    return poses


def _noisy(rel, rng, scale):
    noise = rng.normal(scale=scale, size=(len(rel), 6)).astype(np.float32)
    return np.stack([r @ np.asarray(jse3.se3_exp(jnp.asarray(n)), np.float32)
                     for r, n in zip(rel, noise)])


@pytest.fixture(scope="module")
def drift_graph():
    """test_loop_closure_corrects_drift's graph: a 10-pose chain, odometry
    with 0.01 noise, its drifted integration and an exact loop edge 0 -> 9
    at 1e4 I.  (poses, edge_i, edge_j, edge_rel, info, gt)."""
    k = 10
    gt = _chain(k)
    i, j, rel = JD.edges_from_odometry(gt)
    rel_noisy = _noisy(rel, np.random.default_rng(3), 0.01)
    drifted = [np.eye(4)]
    for r in rel_noisy:
        drifted.append(drifted[-1] @ r.astype(np.float64))
    lc = (np.linalg.inv(gt[0]) @ gt[-1]).astype(np.float32)
    edge_i = np.concatenate([i, [0]]).astype(np.int32)
    edge_j = np.concatenate([j, [k - 1]]).astype(np.int32)
    info = np.broadcast_to(np.eye(6, dtype=np.float32), (k, 6, 6)).copy()
    info[-1] *= 1e4
    return (np.stack(drifted).astype(np.float32), edge_i, edge_j,
            np.concatenate([rel_noisy, lc[None]]), info, gt)


def _jax_args(poses, *arrays):
    return (jnp.asarray(poses),) + tuple(jnp.asarray(a) for a in arrays)


def _held(name, jres, tres, tol=POSE_TOL):
    """Poses within tol, the error within 1e-4 relative, converged equal;
    returns the iterations (JAX, port)."""
    j, t = convert.pose_graph_result_to_numpy(jres), convert.pose_graph_result_to_numpy(tres)
    np.testing.assert_allclose(t.poses, j.poses, atol=tol, err_msg=name)
    assert abs(t.error - j.error) <= 1e-4 * abs(j.error) + 1e-12, (name, t.error, j.error)
    assert t.converged == j.converged, name
    return j.iterations, t.iterations


# -- the se3 helpers under torch.func ----------------------------------------

def _se3_cases():
    rng = np.random.default_rng(0)
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    return {"identity": np.zeros(6), "small_angle": np.r_[ax * 3e-6, rng.normal(size=3)],
            "generic": rng.normal(size=6) * 0.5,
            "near_pi": np.r_[ax * (np.pi - 1e-3), rng.normal(size=3)]}


@pytest.mark.parametrize("case", sorted(_se3_cases()))
def test_se3_jacfwd_matches_jax(case):
    """se3_exp and se3_log go through torch.func.jacfwd (and vmap of it) and
    give JAX's Jacobians at the identity, at a small angle (theta^2 <
    1e-10), at a generic pose and near pi."""
    from torch.func import jacfwd

    xi = np.float32(_se3_cases()[case])
    assert case != "small_angle" or float(np.sum(xi[:3] ** 2)) < 1e-10
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    Tt = torch.tensor(T)
    zero = jnp.zeros(6, jnp.float32)
    ports = {
        "exp": lambda d: se3.se3_exp(torch.as_tensor(xi) + d),
        "log_right": lambda d: se3.se3_log(Tt @ se3.se3_exp(d)),
        "log_left": lambda d: se3.se3_log(se3.se3_exp(d) @ Tt),
    }
    wants = _jax_se3_jacobians(jnp.asarray(xi), jnp.asarray(T), zero)
    for name, ft in ports.items():
        got = jacfwd(ft)(torch.zeros(6))
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(wants[name]), atol=1e-5,
                                   err_msg=f"{case} {name}")
    # the sparse solver's per-edge form: vmap over edges of a 12-wide jacfwd
    Ts = np.stack([T, np.asarray(jse3.se3_exp(jnp.asarray(xi * 0.5)))])
    z = np.stack([np.eye(4, dtype=np.float32), T])
    want_r, want_J = _jax_edge_jacobians(jnp.asarray(Ts), jnp.asarray(Ts[::-1]), jnp.asarray(z))
    r, J = TS._edge_res_and_jac(torch.as_tensor(Ts), torch.as_tensor(Ts[::-1].copy()),
                                torch.as_tensor(z))
    np.testing.assert_allclose(J.numpy(), np.asarray(want_J), atol=1e-5,
                               err_msg=f"{case} per edge")
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), atol=1e-5)


@jax.jit
def _jax_se3_jacobians(xi, T, zero):
    return {
        "exp": jax.jacfwd(lambda d: jse3.se3_exp(xi + d))(zero),
        "log_right": jax.jacfwd(lambda d: jse3.se3_log(T @ jse3.se3_exp(d)))(zero),
        "log_left": jax.jacfwd(lambda d: jse3.se3_log(jse3.se3_exp(d) @ T))(zero),
    }


@jax.jit
def _jax_edge_jacobians(Ti, Tj, z):
    zero = jnp.zeros(12, jnp.float32)
    return jax.vmap(lambda a, b, c: (JS._edge_res(a, b, c, zero), jax.jacfwd(
        lambda d: JS._edge_res(a, b, c, d))(zero)))(Ti, Tj, z)


# -- the block-tridiagonal preconditioner ------------------------------------

def _tridiag_system(rng, K, lam, anchored):
    """D, U, r of a pose-graph chain: edges (k, k+1) with J = [-(I + 0.1 N),
    I + 0.1 N'], W diagonal in [0.5, 2], pose 0 pinned by 1e3 I; `anchored`
    adds an SPD block (B B^T / 6 + 0.5 I) to every pose, which keeps the
    system well conditioned at every lambda."""
    D = np.zeros((K, 6, 6))
    U = np.zeros((K, 6, 6))
    for k in range(K - 1):
        J = np.concatenate([-(np.eye(6) + 0.1 * rng.normal(size=(6, 6))),
                            np.eye(6) + 0.1 * rng.normal(size=(6, 6))], 1)
        H = J.T @ np.diag(rng.uniform(0.5, 2.0, 6)) @ J
        D[k] += H[:6, :6]
        D[k + 1] += H[6:, 6:]
        U[k] = H[:6, 6:]
    D[0] += 1e3 * np.eye(6)
    if anchored or K == 1:
        for k in range(K):
            B = rng.normal(size=(6, 6))
            D[k] += B @ B.T / 6 + 0.5 * np.eye(6)
    D += lam * np.eye(6)
    return (D.astype(np.float32), U.astype(np.float32),
            rng.normal(size=(K, 6)).astype(np.float32))


@pytest.mark.parametrize("K", [1, 2, 17, 64])
def test_tridiag_solve_matches_jax(K):
    """The plain factor + apply against JAX's `_tridiag_solve` at several
    lambda; the factor applied to a second right-hand side gives that
    right-hand side's solve."""
    rng = np.random.default_rng(K)
    jsolve = jax.jit(JS._tridiag_solve)
    for lam in (1e-7, 1e-4, 1e-1, 1e2, 1e4):
        D, U, r = _tridiag_system(rng, K, lam, anchored=True)
        want = np.asarray(jsolve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(r)))
        got = TS._tridiag_solve(torch.as_tensor(D), torch.as_tensor(U), torch.as_tensor(r))
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale, (K, lam)
        Cinv, G = cpg.block_tridiag_factor(torch.as_tensor(D), torch.as_tensor(U))
        r2 = rng.normal(size=(K, 6)).astype(np.float32)
        want2 = np.asarray(jsolve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(r2)))
        got2 = cpg.block_tridiag_apply(Cinv, G, torch.as_tensor(U), torch.as_tensor(r2))
        assert np.abs(got2.numpy() - want2).max() <= 1e-5 * np.abs(want2).max(), (K, lam)
        if lam >= 0.1:  # a bare chain, well conditioned at this damping
            D, U, r = _tridiag_system(rng, K, lam, anchored=False)
            want = np.asarray(jsolve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(r)))
            got = TS._tridiag_solve(torch.as_tensor(D), torch.as_tensor(U), torch.as_tensor(r))
            assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max(), (K, lam)


_JAX_TRIDIAG = jax.jit(JS._tridiag_solve)


@pytest.mark.parametrize("lam", [1e-7, 1e-4, 1e-1, 1e2, 1e4])
def test_tridiag_solve_matches_jax_at_graph_size(lam):
    """The plain factor + apply against JAX's `_tridiag_solve` at K = 512,
    the back-end graph's size, on an anchored chain (measured <= 2.2e-7 of
    max |x|)."""
    D, U, r = _tridiag_system(np.random.default_rng(512), 512, lam, anchored=True)
    want = np.asarray(_JAX_TRIDIAG(jnp.asarray(D), jnp.asarray(U), jnp.asarray(r)))
    U_t = torch.as_tensor(U)
    got = cpg.block_tridiag_apply(*cpg.block_tridiag_factor(torch.as_tensor(D), U_t), U_t,
                                  torch.as_tensor(r))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("K", [1, 2, 31, 32, 33])
def test_tridiag_solve_matches_float64_dense_solve(K):
    """The plain factor + apply against a float64 `numpy.linalg.solve` of
    the assembled (6K)^2 system, anchored chains at five lambdas: within
    1e-5 of max |x| (measured <= 3.1e-7 over six seeds), at chain lengths
    on each side of the kernels' edges."""
    rng = np.random.default_rng(100 + K)
    for lam in (1e-7, 1e-4, 1e-1, 1e2, 1e4):
        D, U, r = _tridiag_system(rng, K, lam, anchored=True)
        A = np.zeros((6 * K, 6 * K))
        for k in range(K):
            A[6 * k:6 * k + 6, 6 * k:6 * k + 6] = D[k]
            if k + 1 < K:
                A[6 * k:6 * k + 6, 6 * k + 6:6 * k + 12] = U[k]
                A[6 * k + 6:6 * k + 12, 6 * k:6 * k + 6] = U[k].T
        want = np.linalg.solve(A, r.astype(np.float64).reshape(-1)).reshape(K, 6)
        U_t = torch.as_tensor(U)
        got = cpg.block_tridiag_apply(*cpg.block_tridiag_factor(torch.as_tensor(D), U_t), U_t,
                                      torch.as_tensor(r))
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max(), lam


def test_solve6_matches_jax():
    rng = np.random.default_rng(1)
    B = rng.normal(size=(6, 6))
    A = (B @ B.T + np.eye(6)).astype(np.float32)
    rhs = rng.normal(size=(6, 4)).astype(np.float32)
    for b in (rhs[:, 0], rhs):
        want = np.asarray(JS._solve6(jnp.asarray(A), jnp.asarray(b)))
        got = TS._solve6(torch.as_tensor(A), torch.as_tensor(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- the dense and the sparse solve -----------------------------------------

@pytest.mark.parametrize("delta", [1e-6, 1e-5], ids=["default", "clear_of_noise"])
def test_optimize_pose_graph_matches_jax(drift_graph, delta):
    poses, ei, ej, rel, info, gt = drift_graph
    jres = JD.optimize_pose_graph(*_jax_args(poses, ei, ej, rel, info),
                                  JD.PoseGraphConfig(max_iterations=20, convergence_delta=delta))
    tres = TD.optimize_pose_graph(poses, ei, ej, rel, info,
                                  TD.PoseGraphConfig(max_iterations=20, convergence_delta=delta),
                                  device="cpu")
    it_j, it_t = _held("dense", jres, tres)
    assert (it_t == it_j) if delta == 1e-5 else abs(it_t - it_j) <= 1, (it_j, it_t)
    drift0 = np.linalg.norm(poses[-1, :3, 3] - gt[-1][:3, 3])
    drift1 = np.linalg.norm(tres.poses[-1, :3, 3].numpy() - gt[-1][:3, 3])
    assert drift1 < 0.2 * drift0, (drift0, drift1)


@pytest.mark.parametrize("delta", [1e-6, 1e-5], ids=["default", "clear_of_noise"])
def test_optimize_pose_graph_sparse_matches_jax(drift_graph, delta):
    poses, ei, ej, rel, info, _gt = drift_graph
    cfg = dict(max_iterations=20, convergence_delta=delta)
    jres = JS.optimize_pose_graph_sparse(*_jax_args(poses, ei, ej, rel, info),
                                         config=JS.SparsePGConfig(**cfg))
    TS.reset_stats()
    tres = TS.optimize_pose_graph_sparse(poses, ei, ej, rel, info,
                                         config=TS.SparsePGConfig(**cfg), device="cpu",
                                         device_loop=False)
    it_j, it_t = _held("sparse", jres, tres)
    assert (it_t == it_j) if delta == 1e-5 else abs(it_t - it_j) <= 1, (it_j, it_t)
    f = TS.optimize_pose_graph_sparse
    assert f.pcgs == f.trials and f.host_syncs <= f.trials + it_t
    # the sparse solve reproduces the dense one (test_sparse_matches_dense)
    dense = TD.optimize_pose_graph(poses, ei, ej, rel, info,
                                   TD.PoseGraphConfig(max_iterations=20), device="cpu")
    np.testing.assert_allclose(tres.poses.numpy(), dense.poses.numpy(), atol=2e-3)


def test_nan_pose_reports_not_converged(drift_graph):
    """test_nan_input_reports_not_converged on the 10-pose graph's shape:
    every trial is rejected and neither package reports convergence."""
    poses, ei, ej, rel, info, _gt = drift_graph
    poses = poses.copy()
    poses[2, 0, 3] = np.nan
    cfg = dict(max_iterations=20)
    jres = JS.optimize_pose_graph_sparse(*_jax_args(poses, ei, ej, rel, info),
                                         config=JS.SparsePGConfig(**cfg))
    tres = TS.optimize_pose_graph_sparse(poses, ei, ej, rel, info,
                                         config=TS.SparsePGConfig(**cfg), device="cpu")
    assert not bool(jres.converged) and not bool(tres.converged)
    assert int(tres.iterations) == int(jres.iterations)


def _prior_case():
    """A 6-pose chain with pose 0 anchored 2 cm off by a 1e4 I prior
    (test_sharded_with_marginalization_prior's graph at K = 6)."""
    gt = _chain(6)
    i, j, rel = JD.edges_from_odometry(gt)
    prior_pose = np.asarray(gt[0] @ np.asarray(
        jse3.se3_exp(jnp.asarray(np.float32([0, 0, 0, 0.02, 0, 0]))), np.float64), np.float32)
    rel = _noisy(rel, np.random.default_rng(5), 0.01)
    info = np.broadcast_to(np.eye(6, dtype=np.float32), (5, 6, 6)).copy()
    return np.stack(gt).astype(np.float32), i, j, rel, info, prior_pose, \
        1e4 * np.eye(6, dtype=np.float32)


def test_sparse_with_prior_matches_jax():
    poses, i, j, rel, info, prior_pose, prior_info = _prior_case()
    jres = JS.optimize_pose_graph_sparse(
        *_jax_args(poses, i, j, rel, info), prior_info=jnp.asarray(prior_info),
        prior_pose=jnp.asarray(prior_pose), config=JS.SparsePGConfig(**SW_CONFIG))
    tres = TS.optimize_pose_graph_sparse(poses, i, j, rel, info, prior_info=prior_info,
                                         prior_pose=prior_pose,
                                         config=TS.SparsePGConfig(**SW_CONFIG), device="cpu")
    it_j, it_t = _held("prior", jres, tres)
    assert it_t == it_j
    # the prior pulled pose 0 off the origin (no gauge pin with a prior)
    assert np.linalg.norm(tres.poses[0, :3, 3].numpy()) > 5e-3


# -- SlidingWindowBA ---------------------------------------------------------

def _window_state(ba):
    return (ba.base, np.stack(ba.poses), ba.prior_pose, ba.prior_info,
            [(i, j) for (i, j, _r, _w) in ba.edges])


def _held_window(name, jba, tba, rtol=1e-4):
    jb, jp, jpp, jpi, je = _window_state(jba)
    tb, tp, tpp, tpi, te = _window_state(tba)
    assert (tb, te) == (jb, je), name
    np.testing.assert_allclose(tp, jp, atol=POSE_TOL, err_msg=f"{name}: poses")
    np.testing.assert_allclose(tpp, jpp, atol=POSE_TOL, err_msg=f"{name}: prior_pose")
    np.testing.assert_allclose(tpi, jpi, rtol=rtol, atol=rtol * np.abs(jpi).max(),
                               err_msg=f"{name}: prior_info")


def test_sliding_window_matches_jax():
    """Window 6, 9 keyframes (4 marginalizations), optimize, a loop edge at
    1e4 I, optimize; then the window carried into a fresh port window with
    `convert.sliding_window_from_numpy`, both fed one more keyframe (the
    marginalization drops the loop edge, warned) and optimized again."""
    gt = _chain(11, step=(0, 0, 0.05, 0.8, 0.0, 0))
    _i, _j, rel = JD.edges_from_odometry(gt)
    rel = _noisy(rel, np.random.default_rng(9), 0.005)
    jba = JS.SlidingWindowBA(window=6, config=JS.SparsePGConfig(**SW_CONFIG))
    tba = TS.SlidingWindowBA(window=6, config=TS.SparsePGConfig(**SW_CONFIG), device="cpu")
    for r in rel[:9]:
        jba.add_keyframe(r)
        tba.add_keyframe(r)
    assert tba.base == 4 and len(tba.poses) == 6
    _held_window("after 9 keyframes", jba, tba)
    jres, tres = jba.optimize(), tba.optimize()
    assert int(tres.iterations) == int(jres.iterations)
    _held_window("optimize", jba, tba)
    gi, gj = tba.base, tba.base + 5
    lc = (np.linalg.inv(gt[gi]) @ gt[gj]).astype(np.float32)
    for ba in (jba, tba):
        ba.add_loop_edge(gi, gj, lc, 1e4 * np.eye(6, dtype=np.float32))
        ba.optimize()
    _held_window("loop edge and optimize", jba, tba)
    carried = convert.sliding_window_from_numpy(jba, device="cpu")
    _held_window("carried", jba, carried, rtol=0.0)
    for ba in (jba, carried):
        with pytest.warns(UserWarning, match="dropping 1 loop edge"):
            ba.add_keyframe(rel[9])
        ba.optimize()
    _held_window("carried, one more keyframe and optimize", jba, carried)


def test_loop_edge_window_bounds():
    """add_loop_edge refuses endpoints outside [base, base + K), as JAX's."""
    gt = _chain(12, step=(0, 0, 0.05, 0.8, 0.0, 0))
    _i, _j, rel = JD.edges_from_odometry(gt)
    ba = TS.SlidingWindowBA(window=8, config=TS.SparsePGConfig(max_iterations=3),
                            device="cpu")
    for r in rel:
        ba.add_keyframe(r)
    end = ba.base + len(ba.poses)
    eye = np.eye(4, dtype=np.float32)
    with pytest.raises(ValueError, match="outside the window"):
        ba.add_loop_edge(ba.base - 1, end - 1, eye)  # marginalized out
    with pytest.raises(ValueError, match="outside the window"):
        ba.add_loop_edge(ba.base, end, eye)  # not yet added
    ba.add_loop_edge(ba.base, end - 1, eye)  # boundary-inclusive
    assert ba.optimize() is not None
    assert TS.SlidingWindowBA(device="cpu").optimize() is None


def test_config_from_jax_back_end():
    cases = [(JD.PoseGraphConfig(max_iterations=3, damping=1e-6), TD.PoseGraphConfig),
             (JS.SparsePGConfig(cg_iterations=7, gauge_weight=1e3), TS.SparsePGConfig)]
    from fast_gicp_tpu.models.loop_closure import LoopClosureConfig as JL
    from fast_gicp_tpu_torch.models.loop_closure import LoopClosureConfig as TL

    cases.append((JL(min_gap=4, radius=2.5), TL))
    for jcfg, kind in cases:
        got = convert.config_from_jax(jcfg)
        assert type(got) is kind and tuple(got) == tuple(jcfg)
    for kind in (JD.PoseGraphConfig, JS.SparsePGConfig, JL):
        assert tuple(convert.config_from_jax(kind())) == tuple(kind())
