"""The one-program odometry forms on the CPU: `run_odometry_scan` and
`ScanToMapOdometry` (`process_chunk`, `process`) with `device_loop=True`
(the default; on CUDA a frame is one replay of a captured graph, here the
same frame body in the device form's plain version) against their eager
forms, bit for bit, on the existing tests' scenes: tests/test_torch_odometry.py's
trajectory (seed 3, 0.2 m, the 64 x 64 x 32 grid) and
tests/test_torch_scan_to_map.py's (seed 5, 7 frames), with their bounds (ATE
under 0.05 m; the chunked run within 1e-5 of `process`, the JAX test's).
Those files hold the default form -- this one -- to the JAX package frame
by frame (`test_run_odometry_scan_matches_jax`,
`test_odometry_matches_jax_frame_by_frame`, `test_process_chunk_matches_process`)."""

import numpy as np
import pytest
import torch

from fast_gicp_tpu_torch.models import scan_to_map as T
from fast_gicp_tpu_torch.models.vgicp import VGICPConfig
from fast_gicp_tpu_torch.utils import kitti
from fast_gicp_tpu_torch.utils.downsample import voxel_downsample

from tests.test_odometry import _trajectory_scans


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_run_odometry_scan_graph_form_is_eager():
    scans, gt = _trajectory_scans(np.random.default_rng(3))
    kw = dict(resolution=1.0, neighbor_search_method="direct7", grid_dims=(64, 64, 32))
    graph = kitti.run_odometry_scan(scans, 0.2, config=VGICPConfig(**kw), device="cpu")
    eager = kitti.run_odometry_scan(scans, 0.2, config=VGICPConfig(**kw), device="cpu",
                                    device_loop=False)
    assert len(graph) == len(eager) == len(gt)
    for a, b in zip(graph, eager):
        np.testing.assert_array_equal(a, b)
    assert kitti.ate_rmse(gt, graph) < 0.05


def test_scan_to_map_graph_form_is_eager():
    scans, gt = _trajectory_scans(np.random.default_rng(5), n_frames=7)
    scans = [voxel_downsample(s, 0.2) for s in scans]
    cfg = dict(resolution=1.0, capacity=1 << 14)
    eager = T.ScanToMapOdometry(T.ScanToMapConfig(**cfg), device="cpu", device_loop=False)
    graph = T.ScanToMapOdometry(T.ScanToMapConfig(**cfg), device="cpu")
    chunked = T.ScanToMapOdometry(T.ScanToMapConfig(**cfg), device="cpu")
    for s in scans:
        eager.process(s)
        graph.process(s)
    chunked.process_chunk(scans[:4])  # the 2 warm-up frames, then graph frames
    chunked.process_chunk(scans[4:])
    assert graph._frame_graph is not None and eager._frame_graph is None
    for a, b in zip(graph.poses, eager.poses):
        np.testing.assert_array_equal(a, b)
    for f in ("sums", "coords", "lut", "num_voxels"):
        assert torch.equal(getattr(graph.state, f), getattr(eager.state, f)), f
    assert torch.equal(graph._last_delta, eager._last_delta)
    for a, b in zip(chunked.poses, graph.poses):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert kitti.ate_rmse(gt, chunked.poses) < 0.05


def test_frame_graph_recaptures_on_growth_and_follows_eager_frames():
    """A map that grows (capacity doubles) gets a new frame graph; frames
    fed after an eager frame (the graph's buffers reloaded from the
    odometry's state) stay bit-equal to the eager odometry."""
    scans, _gt = _trajectory_scans(np.random.default_rng(5), n_frames=7)
    scans = [voxel_downsample(s, 0.2) for s in scans]
    cfg = T.ScanToMapConfig(resolution=1.0, capacity=1 << 8, grow_check_every=1)
    eager = T.ScanToMapOdometry(cfg, device="cpu", device_loop=False)
    graph = T.ScanToMapOdometry(cfg, device="cpu")
    keys = []
    for i, s in enumerate(scans):
        eager.process(s)
        graph.device_loop = i != 4  # frame 4 eager on the graph odometry too
        graph.process(s)
        if graph._frame_graph is not None:
            keys.append(graph._frame_graph.key)
    assert len(set(keys)) > 1  # recaptured after growth
    for a, b in zip(graph.poses, eager.poses):
        np.testing.assert_array_equal(a, b)
    for f in ("sums", "coords", "lut", "num_voxels"):
        assert torch.equal(getattr(graph.state, f), getattr(eager.state, f)), f
