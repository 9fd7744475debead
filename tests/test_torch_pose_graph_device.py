"""The pose-graph solves' device form (`device_loop=True`: on the card one
CUDA graph a signature, its loops conditional WHILE nodes and the CG's
refresh an IF node; here on the CPU its plain version, the host loop over
the conditions `cuda_pose_graph.pg_cond_plain` writes) against the eager
form (`device_loop=False`) bit for bit -- poses, error, iterations and
converged, and the trials, PCGs and CG iterations the eager form counts on
the host against the device form's tally -- and against the JAX package's
`optimize_pose_graph_sparse` and `optimize_pose_graph` at
tests/test_torch_pose_graph.py's tolerances (poses 1e-4, the error 1e-4
relative, converged equal, iterations equal at convergence_delta 1e-5).

Cases: the 10-pose drift graph of tests/test_torch_pose_graph.py (also with
a PCG run past the 64th iteration, where the residual is recomputed, and
with no trial allowed), its 6-pose chain with a marginalization prior, the
drift graph with a NaN pose (every trial rejected), both solves where they
apply; `SlidingWindowBA` at window 6; and `pg_cond`'s plain version against
a numpy statement of JAX's three loop conditions and the refresh test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fast_gicp_tpu.models import pose_graph as JD
from fast_gicp_tpu.models import pose_graph_sparse as JS
from fast_gicp_tpu_torch import graphs
from fast_gicp_tpu_torch.models import pose_graph as TD
from fast_gicp_tpu_torch.models import pose_graph_sparse as TS
from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

from test_torch_pose_graph import (  # noqa: F401  (drift_graph: a fixture)
    SW_CONFIG, _chain, _held, _jax_args, _noisy, _prior_case, _window_state, drift_graph,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _bits(t):
    """A tensor's bits (float32 as int32, so NaNs compare too)."""
    t = torch.as_tensor(t).contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bit_equal(name, a, b):
    for f in a._fields:
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype and ta.shape == tb.shape, (name, f)
        assert torch.equal(_bits(ta), _bits(tb)), (name, f, ta, tb)


def _sparse_both(args, kwargs, cfg):
    """(eager result, device-form result, the eager form's host counts, the
    device form's tally), each of (trials, PCGs, CG iterations run)."""
    TS.reset_stats()
    eager = TS.optimize_pose_graph_sparse(*args, **kwargs, config=TS.SparsePGConfig(**cfg),
                                          device="cpu", device_loop=False)
    f = TS.optimize_pose_graph_sparse
    host = (f.trials, f.pcgs, int(f.cg_iterations_run))
    counts = cpg.pg_counts("cpu")
    counts.zero_()
    dev = TS.optimize_pose_graph_sparse(*args, **kwargs, config=TS.SparsePGConfig(**cfg),
                                        device="cpu")
    tally = dict(zip(cpg.PG_COUNTS, counts.tolist()))
    assert (f.trials, f.pcgs) == host[:2], "the device form counted on the host"
    return eager, dev, host, tally


def _sparse_cases(drift):
    poses, ei, ej, rel, info, _gt = drift
    nan = poses.copy()
    nan[2, 0, 3] = np.nan
    pp, i, j, prel, pinfo, prior_pose, prior_info = _prior_case()
    prior = dict(prior_info=prior_info, prior_pose=prior_pose)
    return {
        "drift": ((poses, ei, ej, rel, info), {}, dict(max_iterations=20)),
        # a zero tolerance: the one PCG runs its 70 iterations, the 64th
        # with the residual recomputed
        "drift_refresh": ((poses, ei, ej, rel, info), {},
                          dict(max_iterations=1, lm_max_trials=1, cg_iterations=70,
                               cg_tolerance=0.0)),
        "drift_no_trial": ((poses, ei, ej, rel, info), {}, dict(lm_max_trials=0)),
        "prior": ((pp, i, j, prel, pinfo), prior, SW_CONFIG),
        "nan_pose": ((nan, ei, ej, rel, info), {}, dict(max_iterations=20)),
    }


@pytest.mark.parametrize("case", ["drift", "drift_refresh", "drift_no_trial", "prior",
                                  "nan_pose"])
def test_sparse_device_form_is_the_eager_form(drift_graph, case):
    args, kwargs, cfg = _sparse_cases(drift_graph)[case]
    eager, dev, (trials, pcgs, cg_run), tally = _sparse_both(args, kwargs, cfg)
    _bit_equal(case, eager, dev)
    assert (tally["trials"], tally["pcgs"], tally["cg_iterations"]) == (trials, pcgs, cg_run)
    assert tally["solves"] == 1 and tally["iterations"] == int(dev.iterations)
    # one preconditioner application a PCG and one a CG iteration, one
    # factor a PCG
    assert tally["applies"] == pcgs + cg_run and tally["factors"] == pcgs
    # a condition a loop entry and a trip, and the refresh test a CG iteration
    assert tally["pg_cond"] == 1 + tally["iterations"] * 2 + trials + pcgs + 2 * cg_run
    if case == "drift_refresh":
        assert pcgs == 1 and cg_run == 70
    if case == "nan_pose":
        assert not bool(dev.converged) and trials == SW_CONFIG["max_iterations"] - 2
    if case == "drift_no_trial":
        assert trials == 0 and int(dev.iterations) == 1 and bool(dev.converged)


@pytest.mark.parametrize("case", ["drift", "nan_pose", "no_iteration"])
def test_dense_device_form_is_the_eager_form(drift_graph, case):
    poses, ei, ej, rel, info, _gt = drift_graph
    if case == "nan_pose":
        poses = poses.copy()
        poses[2, 0, 3] = np.nan
    cfg = TD.PoseGraphConfig(max_iterations=0 if case == "no_iteration" else 20)
    eager = TD.optimize_pose_graph(poses, ei, ej, rel, info, cfg, device="cpu",
                                   device_loop=False)
    counts = cpg.pg_counts("cpu")
    counts.zero_()
    dev = TD.optimize_pose_graph(poses, ei, ej, rel, info, cfg, device="cpu")
    _bit_equal(case, eager, dev)
    tally = dict(zip(cpg.PG_COUNTS, counts.tolist()))
    assert tally["solves"] == 1 and tally["iterations"] == int(dev.iterations)
    assert tally["pg_cond"] == 1 + tally["iterations"] and tally["trials"] == 0


def test_device_forms_match_jax(drift_graph):
    """Both device forms on the drift graph against JAX at
    convergence_delta 1e-5 (iterations decided clear of float32's noise);
    the prior case's eager form is held to JAX in
    tests/test_torch_pose_graph.py, and the device form to it above."""
    poses, ei, ej, rel, info, _gt = drift_graph
    cfg = dict(max_iterations=20, convergence_delta=1e-5)
    jres = JS.optimize_pose_graph_sparse(*_jax_args(poses, ei, ej, rel, info),
                                         config=JS.SparsePGConfig(**cfg))
    tres = TS.optimize_pose_graph_sparse(poses, ei, ej, rel, info,
                                         config=TS.SparsePGConfig(**cfg), device="cpu")
    it_j, it_t = _held("sparse", jres, tres)
    assert it_t == it_j
    jres = JD.optimize_pose_graph(*_jax_args(poses, ei, ej, rel, info),
                                  JD.PoseGraphConfig(**cfg))
    tres = TD.optimize_pose_graph(poses, ei, ej, rel, info, TD.PoseGraphConfig(**cfg),
                                  device="cpu")
    it_j, it_t = _held("dense", jres, tres)
    assert it_t == it_j


def test_sliding_window_device_form_is_the_eager_form():
    """tests/test_torch_pose_graph.py's window 6 over 9 keyframes, a solve,
    a loop edge at 1e4 I and a solve, one more keyframe (the loop edge
    marginalized away) and a solve: every solve's result and the window's
    state bit for bit in both forms."""
    gt = _chain(11, step=(0, 0, 0.05, 0.8, 0.0, 0))
    _i, _j, rel = JD.edges_from_odometry(gt)
    rel = _noisy(rel, np.random.default_rng(9), 0.005)
    bas = [TS.SlidingWindowBA(window=6, config=TS.SparsePGConfig(**SW_CONFIG), device="cpu",
                              device_loop=loop) for loop in (False, True)]
    lc = (np.linalg.inv(gt[4]) @ gt[9]).astype(np.float32)
    results = []
    for ba in bas:
        out = []
        for r in rel[:9]:
            ba.add_keyframe(r)
        out.append(ba.optimize())
        ba.add_loop_edge(4, 9, lc, 1e4 * np.eye(6, dtype=np.float32))
        out.append(ba.optimize())
        with pytest.warns(UserWarning, match="dropping 1 loop edge"):
            ba.add_keyframe(rel[9])
        out.append(ba.optimize())
        results.append(out)
    for n, (a, b) in enumerate(zip(*results)):
        _bit_equal(f"solve {n}", a, b)
    (ba_, pa, ppa, pia, ea), (bb, pb, ppb, pib, eb) = (_window_state(ba) for ba in bas)
    assert (ba_, ea) == (bb, eb)
    for x, y in ((pa, pb), (ppa, ppb), (pia, pib)):
        assert np.array_equal(x.view(np.int32), y.view(np.int32))


def _jax_condition(mode, cap, n, stop, rr, thresh):
    """numpy statement of the JAX loops' conditions (pose_graph_sparse.py
    :255-260, :288-290, :317-319; pose_graph.py :111-113) on the counter
    after the step, and of the refresh test (i + 1) % 64 == 0 (:271-275):
    (the counter after, the condition, the tally slot added to)."""
    if mode == cpg.PG_REFRESH:
        return n, bool((n + 1) % cap == 0), None
    enter = mode in (cpg.PG_GN_ENTER, cpg.PG_TRIAL_ENTER, cpg.PG_CG_ENTER)
    after = 0 if enter else n + 1
    if mode in cpg.PG_CG_MODES:
        cond = (after < cap) & bool(np.float32(rr) > np.float32(thresh))
    else:
        cond = (after < cap) & (not stop)
    slot = {cpg.PG_GN_ENTER: "solves", cpg.PG_GN_STEP: "iterations",
            cpg.PG_TRIAL_STEP: "trials", cpg.PG_CG_ENTER: "pcgs",
            cpg.PG_CG_STEP: "cg_iterations"}.get(mode)
    return after, bool(cond), slot


def test_pg_cond_plain_matches_jax_conditions():
    """Every mode, at trip counters on both sides of each cap (0, 1, 8,
    100) and of the refresh period, both stop flags, and res.res on both
    sides of, at and NaN against the threshold."""
    rng = np.random.default_rng(20)
    counts = cpg.pg_counts("cpu")
    cases = 0
    for mode in range(cpg.PG_REFRESH + 1):
        caps = (cpg.CG_REFRESH, 1, 3) if mode == cpg.PG_REFRESH else (0, 1, 8, 100)
        for cap in caps:
            for n in sorted({0, max(cap - 2, 0), max(cap - 1, 0), cap, cap + 1, 62, 63, 64,
                             127}):
                for stop in (False, True):
                    th = np.float32(rng.uniform(1e-12, 1.0))
                    for rr in (np.nextafter(th, np.float32(0)), th,
                               np.nextafter(th, np.float32(np.inf)), np.float32(np.nan),
                               np.float32(0.0), np.float32(np.inf)):
                        counter = torch.tensor(n, dtype=torch.int32)
                        flag = torch.tensor([7], dtype=torch.int32)
                        before = counts.clone()
                        cpg.pg_cond(mode, cap, counter, flag, stop=torch.tensor(stop),
                                    rr=torch.tensor(rr), thresh=torch.tensor(th))
                        after, cond, slot = _jax_condition(mode, cap, n, stop, rr, th)
                        assert int(counter) == after and int(flag[0]) == int(cond), (
                            mode, cap, n, stop, rr, th)
                        want = torch.zeros_like(counts)
                        want[0] = 1
                        if slot is not None:
                            want[cpg.PG_COUNTS.index(slot)] += 1
                        assert torch.equal(counts - before, want), (mode, slot)
                        cases += 1
    assert cases > 1000


def test_pg_cond_refuses_bad_arguments():
    counter, flag = torch.zeros((), dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="period"):
        cpg.pg_cond(cpg.PG_REFRESH, 0, counter, flag)
    with pytest.raises(ValueError, match="stop"):
        cpg.pg_cond(cpg.PG_GN_STEP, 3, counter, flag)
    with pytest.raises(ValueError, match="rr"):
        cpg.pg_cond(cpg.PG_CG_STEP, 3, counter, flag, stop=torch.tensor(False))
    with pytest.raises(ValueError, match="handle"):
        cpg.pg_cond(cpg.PG_GN_STEP, 3, counter, flag, stop=torch.tensor(False), handle=5)
    with pytest.raises(ValueError, match="mode"):
        cpg.pg_cond(9, 3, counter, flag)


def test_block_tridiag_wrappers_tally_their_runs_and_plain_versions_do_not():
    """On the CPU each wrapper call adds one to its kernel's slot of the
    device tally (on the card the kernel adds it as it runs); the plain
    versions, which the card's checks also call, add nothing."""
    rng = np.random.default_rng(3)
    B = rng.normal(size=(4, 6, 6)).astype(np.float32)
    D = torch.as_tensor(B @ B.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32))
    U = torch.as_tensor(0.1 * rng.normal(size=(4, 6, 6)).astype(np.float32))
    r = torch.as_tensor(rng.normal(size=(4, 6)).astype(np.float32))
    counts = cpg.pg_counts("cpu")
    before = counts.clone()
    Cinv, G = cpg.block_tridiag_factor(D, U)
    x = cpg.block_tridiag_apply(Cinv, G, U, r)
    cpg.block_tridiag_apply(Cinv, G, U, x)
    want = torch.zeros_like(counts)
    want[cpg.PG_COUNTS.index("factors")] = 1
    want[cpg.PG_COUNTS.index("applies")] = 2
    assert torch.equal(counts - before, want)
    before = counts.clone()
    Cp, Gp = cpg.block_tridiag_factor_plain(D, U)
    assert torch.equal(cpg.block_tridiag_apply_plain(Cp, Gp, U, r), x)
    assert torch.equal(counts, before)


def test_if_then_and_replay_cached_on_the_cpu():
    """`graphs.if_then` runs its body once when the flag is set and not at
    all otherwise; `replay_cached` on the CPU calls the function on the
    inputs themselves (the device form's plain version)."""
    ran = []
    for value in (0, 1):
        cond = graphs.Condition(torch.tensor([value], dtype=torch.int32))
        graphs.if_then(cond, lambda: ran.append(value))
    assert ran == [1]
    x = torch.arange(3.0)
    assert graphs.replay_cached(("t",), dict(x=x), lambda x: x, "cpu") is x
