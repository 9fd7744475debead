"""The port's edge-sharded sparse pose-graph solve
(`fast_gicp_tpu_torch.models.pose_graph_sparse.optimize_pose_graph_sparse_sharded`)
in a world of three gloo processes on the CPU, and the sparse solve at a
scale where its CG recomputes the residual.

The graphs are `tests/test_pose_graph.py`'s: the 10-pose drift graph with
one loop edge at 1e4 I (10 edges: padded to 12 on three ranks) and the
6-pose chain with a marginalization prior (5 edges: padded to 6 on two and
on three ranks), each on a mesh of 2 ranks (a subgroup of the world) and of
3.  Held to the port's single-device solve and to the JAX package's single
solve (which JAX's own `tests/test_pose_graph.py` holds to its sharded
solve): poses within 1e-4 (`tests/test_torch_pose_graph.py`'s bound), the error
within 1e-4 relative, `converged` and the iterations equal (the drift
graph at convergence_delta 1e-5, where that file finds the convergence test
clear of float32's noise), every rank's result bit-equal; the collectives are one all-reduce for each
edge sum: 4 a Gauss-Newton iteration (the error, b, the diagonal and the
chain blocks), 102 a trial (101 CG products, the 64th iteration's
recomputed residual among them, and the trial's error) and the final error.

F1 (at scale): on a 40-pose chain with the 1k graph's noise and closure
weights, every PCG after the first runs all 100 iterations, past the 64th
where the residual is recomputed.  The port and JAX part there by as much
as a one-ulp change of the input poses moves either package's own result,
and no more (measured: 1.8e-3 m at 6 iterations, against 1.2e-3-3.1e-3 m
for the perturbed runs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fast_gicp_tpu.models import pose_graph_sparse as JS
from fast_gicp_tpu_torch import se3
from fast_gicp_tpu_torch.models import pose_graph_sparse as TS
from fast_gicp_tpu_torch.models.pose_graph import edges_from_odometry

from tests.test_torch_pose_graph import SW_CONFIG, _jax_args, _prior_case, drift_graph  # noqa: F401
from tests.torch_dist import run_world

WORLD = 3
POSE_TOL = 1e-4
# convergence_delta 1e-5: the convergence test is decided clear of float32's
# noise (tests/test_torch_pose_graph.py), so the iterations compare exactly
DRIFT_CONFIG = dict(max_iterations=20, convergence_delta=1e-5)
CASES = [("drift", 2), ("drift", 3), ("prior", 2), ("prior", 3)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def graphs(drift_graph):  # noqa: F811
    """name -> (args, kwargs, SparsePGConfig fields)."""
    poses, ei, ej, rel, info, _gt = drift_graph
    pp, i, j, prel, pinfo, prior_pose, prior_info = _prior_case()
    return {"drift": ((poses, ei, ej, rel, info), {}, DRIFT_CONFIG),
            "prior": ((pp, i, j, prel, pinfo),
                      dict(prior_info=prior_info, prior_pose=prior_pose), SW_CONFIG)}


@pytest.fixture(scope="module")
def world(graphs):
    return run_world("tests.torch_dist:pose_graph_cases", WORLD, {"graphs": graphs})


@pytest.fixture(scope="module")
def references(graphs):
    """name -> {"port": the single port solve, "jax": JAX's single solve}, as
    (poses, error, iterations, converged)."""
    out = {}
    for name, (args, kwargs, cfg) in graphs.items():
        jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
        ref = {"port": TS.optimize_pose_graph_sparse(*args, **kwargs,
                                                     config=TS.SparsePGConfig(**cfg),
                                                     device="cpu"),
               "jax": JS.optimize_pose_graph_sparse(*_jax_args(*args), **jkw,
                                                    config=JS.SparsePGConfig(**cfg))}
        out[name] = {k: (np.asarray(r.poses), float(np.asarray(r.error)),
                         int(np.asarray(r.iterations)), bool(np.asarray(r.converged)))
                     for k, r in ref.items()}
    return out


@pytest.mark.parametrize("name,size", CASES, ids=[f"{n}@{s}" for n, s in CASES])
def test_sharded_solve_matches_single_and_jax(world, references, name, size):
    got = world[0][f"{name}@{size}"]
    for other in world[1:size]:
        np.testing.assert_array_equal(other[f"{name}@{size}"]["poses"], got["poses"])
        assert other[f"{name}@{size}"]["error"] == got["error"]
    for kind in ("port", "jax"):
        poses, error, iterations, converged = references[name][kind]
        np.testing.assert_allclose(got["poses"], poses, atol=POSE_TOL, err_msg=str(kind))
        assert abs(got["error"] - error) <= 1e-4 * abs(error) + 1e-12, (kind, got["error"], error)
        assert got["converged"] == converged, kind
        assert got["iterations"] == iterations, (kind, got["iterations"], iterations)


@pytest.mark.parametrize("name,size", CASES, ids=[f"{n}@{s}" for n, s in CASES])
def test_every_edge_sum_is_one_all_reduce(world, graphs, name, size):
    got = world[0][f"{name}@{size}"]
    stats = world[0][f"{name}@{size}:collectives"]
    trials = world[0][f"{name}@{size}:trials"]
    cg = TS.SparsePGConfig(**graphs[name][2]).cg_iterations
    assert stats["collectives"] == stats["all_reduce"]
    assert stats["collectives"] == 4 * got["iterations"] + (cg + 2) * trials + 1


def test_sharded_solve_corrects_drift(world, drift_graph):  # noqa: F811
    poses, *_rest, gt = drift_graph
    got = world[0][f"drift@{WORLD}"]["poses"]
    drift0 = np.linalg.norm(poses[-1, :3, 3] - gt[-1][:3, 3])
    assert np.linalg.norm(got[-1, :3, 3] - gt[-1][:3, 3]) < 0.2 * drift0


# -- F1: the sparse solve at a scale where CG recomputes its residual ----------

F1_K = 40
F1_ITERATIONS = 6
F1_SEEDS = (0, 1)


def _f1_graph():
    """A 40-pose chain curving 6 rad with the 1k graph's odometry noise
    (0.004) and 10 closures at 1e4 I (tests/test_pose_graph.py:120-164, the
    chain shortened)."""
    k = F1_K
    rng = np.random.default_rng(42)
    step = se3.se3_exp(torch.tensor([0, 0, 6.0 / k, 1.0, 0.0, 0])).double().numpy()
    T, gt = np.eye(4), []
    for _ in range(k):
        gt.append(T.copy())
        T = T @ step
    i, j, rel = edges_from_odometry(gt)
    noise = rng.normal(scale=0.004, size=(k - 1, 6)).astype(np.float32)
    rel = np.einsum("eij,ejk->eik", rel, se3.se3_exp(torch.as_tensor(noise)).numpy())
    drifted = [np.eye(4)]
    for r in rel:
        drifted.append(drifted[-1] @ r.astype(np.float64))
    lc_i = (np.arange(10) * (k // 40)).astype(np.int32)
    lc_j = (k - 1 - lc_i).astype(np.int32)
    lc = np.stack([(np.linalg.inv(gt[a]) @ gt[b]).astype(np.float32) for a, b in zip(lc_i, lc_j)])
    info = np.broadcast_to(np.eye(6, dtype=np.float32), (k - 1 + 10, 6, 6)).copy()
    info[k - 1:] *= 1e4
    return (np.stack(drifted).astype(np.float32), np.concatenate([i, lc_i]).astype(np.int32),
            np.concatenate([j, lc_j]).astype(np.int32),
            np.concatenate([rel, lc]).astype(np.float32), info)


def _one_ulp(graph, seed):
    """The graph with every pose translation moved one float32 ulp up or
    down."""
    poses = graph[0].copy()
    t = poses[:, :3, 3]
    up = np.random.default_rng(seed).random(t.shape) < 0.5
    poses[:, :3, 3] = np.nextafter(t, np.where(up, np.float32(np.inf), np.float32(-np.inf)))
    return (poses,) + graph[1:]


def _both(graph):
    cfg = dict(max_iterations=F1_ITERATIONS)
    t = TS.optimize_pose_graph_sparse(*graph, config=TS.SparsePGConfig(**cfg), device="cpu",
                                      device_loop=False)
    j = JS.optimize_pose_graph_sparse(*_jax_args(*graph), config=JS.SparsePGConfig(**cfg))
    return t, j


def test_f1_sparse_solve_at_scale_matches_jax_within_float32_noise():
    graph = _f1_graph()
    TS.reset_stats()
    t, j = _both(graph)
    f = TS.optimize_pose_graph_sparse
    # a PCG ran past iteration 64: more CG iterations than 64 a PCG in all
    assert int(f.cg_iterations_run) > 64 * f.pcgs, (int(f.cg_iterations_run), f.pcgs)
    # every Gauss-Newton iteration accepted its first trial; JAX ran as many
    # iterations without stopping, so it accepted a step in each too
    assert int(t.iterations) == int(j.iterations) == F1_ITERATIONS == f.trials
    assert bool(t.converged) == bool(j.converged)
    tp, jp = t.poses.numpy(), np.asarray(j.poses)
    gap = np.abs(tp - jp).max()
    noise, err_noise = 0.0, 0.0
    for seed in F1_SEEDS:
        ts, js = _both(_one_ulp(graph, seed))
        noise = max(noise, np.abs(ts.poses.numpy() - tp).max(), np.abs(np.asarray(js.poses) - jp).max())
        err_noise = max(err_noise, abs(float(ts.error) - float(t.error)),
                        abs(float(js.error) - float(j.error)))
    assert 0.0 < noise and gap <= 2.0 * noise, (gap, noise)
    assert abs(float(t.error) - float(j.error)) <= 2.0 * err_noise, (
        float(t.error), float(j.error), err_noise)
