"""Loop-closure detection of the port (`fast_gicp_tpu_torch/models/loop_closure.py`)
with device="cpu", held to the JAX package's `models/loop_closure.py` on the
same inputs (the JAX side on the CPU, as its own tests run it).

  * `find_loop_candidates` equal to JAX's on seeded revisiting trajectories
    and on edge cases: ties in distance, a pose exactly `min_gap` frames
    back, a distance exactly at `radius`, candidates beyond
    `max_candidates`, trajectories shorter than the gap;
  * `detect_loop_closures` on the JAX soak test's scene
    (`tools/odometry_bench._loop_scans(rng(11), 24)`, drift growing to ~1 m)
    with max_candidates=1: the same (i, j); the relative pose within 2e-3 m
    and 1e-3 rad of JAX's (measured 5.9e-6 m, 4.3e-8 rad); the information
    within 2% of its largest entry (the Hessian is taken at the last
    linearization point, 1-1.4% apart in other slices; measured 3.9e-5);
    the fitness within 1e-3 relative (measured 3.2e-5).
"""

import sys

import numpy as np
import pytest
import torch

from fast_gicp_tpu.models import loop_closure as JL
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch.models import loop_closure as TL


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pose(x, y, yaw=0.0):
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [x, y, 0.0]
    return T


def _circuit(rng, n, radius, laps, jitter):
    th = np.linspace(0.0, 2 * np.pi * laps, n)
    return [_pose(radius * np.cos(a) + jitter * rng.normal(), radius * np.sin(a)
                  + jitter * rng.normal(), a) for a in th]


def _edge_trajectories():
    """Named (poses, config) cases at the rules' boundaries."""
    cfg = JL.LoopClosureConfig
    line = [_pose(float(i), 0.0) for i in range(12)]
    back = line + [_pose(0.0, 0.0)]  # returns to the start: ties with pose 0 only
    ties = [_pose(0.0, 1.0), _pose(0.0, -1.0)] + [_pose(10.0 + i, 0.0) for i in range(9)] \
        + [_pose(0.0, 0.0)]  # poses 0 and 1 equally far from the last
    at_gap = [_pose(0.0, 0.0)] + [_pose(5.0 + i, 5.0) for i in range(10)] + [_pose(0.5, 0.0)]
    at_radius = [_pose(0.0, 0.0)] + [_pose(9.0 + i, 9.0) for i in range(11)] \
        + [_pose(3.0, 0.0), _pose(2.5, 0.0)]
    return {
        "returns_to_start": (back, cfg()),
        "tie_first_index": (ties, cfg()),
        "pose_exactly_min_gap_back": (at_gap, cfg(min_gap=11)),
        "one_past_min_gap": (at_gap, cfg(min_gap=10)),
        "distance_at_radius": (at_radius, cfg(radius=3.0)),
        "shorter_than_gap": (line[:10], cfg()),
        "max_candidates_cut": (_circuit(np.random.default_rng(2), 60, 10.0, 2.0, 0.0),
                               cfg(max_candidates=3)),
        "equal_distances_sorted": (_circuit(np.random.default_rng(3), 40, 5.0, 2.0, 0.0),
                                   cfg(min_gap=5, radius=50.0)),
    }


@pytest.mark.parametrize("name", sorted(_edge_trajectories()))
def test_find_loop_candidates_edge_cases_match_jax(name):
    poses, jcfg = _edge_trajectories()[name]
    want = JL.find_loop_candidates(poses, jcfg)
    got = TL.find_loop_candidates(poses, convert.config_from_jax(jcfg))
    assert got == want, (name, got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_find_loop_candidates_seeded_match_jax(seed):
    rng = np.random.default_rng(seed)
    poses = _circuit(rng, 80, 20.0, 1.5 + 0.25 * seed, 0.5)
    for jcfg in (JL.LoopClosureConfig(), JL.LoopClosureConfig(min_gap=5, radius=6.0,
                                                               max_candidates=20)):
        want = JL.find_loop_candidates(poses, jcfg)
        assert want, "the circuit revisits its start"
        assert TL.find_loop_candidates(poses, convert.config_from_jax(jcfg)) == want


def _angle(R):
    """Rotation angle from the antisymmetric part and the trace (atan2): the
    trace's arccos loses angles under ~3e-4 rad to rounding."""
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return np.arctan2(s, 0.5 * (np.trace(R) - 1.0))


@pytest.fixture(scope="module")
def soak_scene():
    """The JAX soak test's scene: 24 loop scans of seed 11, the drift
    growing by (0.04, -0.03, 0) m a frame."""
    sys.path.insert(0, "tools")
    from odometry_bench import _loop_scans

    scans, gt = _loop_scans(np.random.default_rng(11), n_frames=24)
    drifted = [p.copy() for p in gt]
    for i, p in enumerate(drifted):
        p[:3, 3] += np.float64([0.04, -0.03, 0.0]) * i
    return scans, gt, drifted


def test_detect_loop_closures_matches_jax(soak_scene):
    scans, gt, drifted = soak_scene
    jcfg = JL.LoopClosureConfig(max_candidates=1)
    want = JL.detect_loop_closures(scans, drifted, jcfg)
    got = TL.detect_loop_closures(scans, drifted, convert.config_from_jax(jcfg), device="cpu")
    assert want and len(got) == len(want)
    for a, b in zip(want, got):
        assert (b.i, b.j) == (a.i, a.j)
        d = np.linalg.inv(a.relative.astype(np.float64)) @ b.relative.astype(np.float64)
        assert np.linalg.norm(d[:3, 3]) < 2e-3
        assert _angle(d[:3, :3]) < 1e-3
        assert np.abs(b.information - a.information).max() <= 0.02 * np.abs(a.information).max()
        assert abs(b.fitness - a.fitness) <= 1e-3 * abs(a.fitness)
        # the soak test's bound on the measured relative pose
        gt_rel = np.linalg.inv(gt[b.i]) @ gt[b.j]
        assert np.linalg.norm((np.linalg.inv(gt_rel) @ b.relative)[:3, 3]) < 0.1
        assert b.relative.dtype == np.float32 and b.information.shape == (6, 6)
