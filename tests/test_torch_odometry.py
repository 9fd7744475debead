"""The scan-to-scan odometry functions (`fast_gicp_tpu_torch/utils/kitti.py`),
`voxelmap.device_downsample` and `auto_grid_dims_multi`, and the KITTI app's
twin (`python -m fast_gicp_tpu_torch.apps.kitti`), with device="cpu",
held to the JAX package's on the same inputs (the JAX side on the CPU).

The scenes are the JAX tests' own (`tests/test_odometry._trajectory_scans`:
seed 3, 5 frames, 0.2 m downsample, DIRECT7, the (64, 64, 32) grid).
Tolerances, frame by frame against JAX: 1e-3 m with RBF covariances
(`run_odometry_stream`, `run_odometry_scan`, `run_odometry_batched`, and
`run_odometry` with FastVGICP on RBF covariances; read: 1e-5 to 9e-5);
5e-3 m for `run_odometry` with FastVGICP's default kNN covariances (read:
2.1e-3; JAX's CPU kNN searches 256-point tiles where the port's fused
contract searches 128-point ones, ROADMAP section 3).  Every trajectory
meets the JAX tests' ATE bound, 0.05 m.  The int16 frames of
`run_odometry_scan` and `device_downsample`'s mask and counts are equal
to JAX's exactly.
"""

import runpy

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fast_gicp_tpu.models.vgicp import FastVGICP as JaxFastVGICP
from fast_gicp_tpu.models.vgicp import VGICPConfig as JaxVGICPConfig
from fast_gicp_tpu.ops import voxelmap as jvoxelmap
from fast_gicp_tpu.solver import LsqConfig as JaxLsqConfig
from fast_gicp_tpu.utils import kitti as jkitti
from fast_gicp_tpu_torch.models.vgicp import FastVGICP, VGICPConfig
from fast_gicp_tpu_torch.ops import voxelmap
from fast_gicp_tpu_torch.solver import LsqConfig
from fast_gicp_tpu_torch.utils import kitti

from tests.test_odometry import _trajectory_scans, _world

TOL = 1e-3  # m, RBF covariances
KNN_TOL = 5e-3  # m, FastVGICP's kNN covariances (JAX's CPU kNN tiles differ)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def traj():
    return _trajectory_scans(np.random.default_rng(3))


def _configs(**kw):
    kw = dict(resolution=1.0, neighbor_search_method="direct7", **kw)
    return JaxVGICPConfig(**kw), VGICPConfig(**kw)


GRID = dict(grid_dims=(64, 64, 32))


def _held(got, want, gt, tol):
    assert len(got) == len(want) == len(gt)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=tol, err_msg=f"frame {i}")
    assert kitti.ate_rmse(gt, got) < 0.05


@pytest.mark.parametrize("cov", ["knn", "rbf"])
def test_run_odometry_matches_jax(traj, cov):
    """The reference's swap loop over FastVGICP (DIRECT7, the auto dense
    grid) with its default kNN covariances or RBF ones."""
    scans, gt = traj
    jreg = JaxFastVGICP(resolution=1.0, neighbor_search_method="direct7")
    treg = FastVGICP(resolution=1.0, neighbor_search_method="direct7", device="cpu")
    if cov == "rbf":
        jreg.set_nearest_neighbor_method("rbf")
        treg.set_nearest_neighbor_method("rbf")
    frames = []
    want = jkitti.run_odometry(scans, jreg, 0.2)
    got = kitti.run_odometry(scans, treg, 0.2, progress=lambda i, p, fps: frames.append(i))
    _held(got, want, gt, KNN_TOL if cov == "knn" else TOL)
    assert frames == list(range(1, len(scans)))


@pytest.mark.parametrize("device_downsample", [False, True], ids=["host", "device"])
def test_run_odometry_stream_matches_jax(traj, device_downsample):
    scans, gt = traj
    jc, tc = _configs(**GRID)
    want = jkitti.run_odometry_stream(scans, 0.2, config=jc,
                                      on_device_downsample=device_downsample)
    got = kitti.run_odometry_stream(scans, 0.2, config=tc,
                                    on_device_downsample=device_downsample, device="cpu")
    _held(got, want, gt, TOL)


def test_run_odometry_stream_cold_start_and_knn(traj):
    """warm_start=False (every align from identity) and kNN covariances
    still track the drive."""
    scans, gt = traj
    _jc, tc = _configs(**GRID)
    for kw in (dict(warm_start=False), dict(covariance="knn")):
        assert kitti.ate_rmse(gt, kitti.run_odometry_stream(scans, 0.2, config=tc,
                                                            device="cpu", **kw)) < 0.05


def test_run_odometry_stream_rejects_huge_scene():
    rng = np.random.default_rng(0)
    scans = [rng.uniform(-500, 500, (100, 3)).astype(np.float32) for _ in range(3)]
    with pytest.raises(ValueError, match="dense grid"):
        kitti.run_odometry_stream(scans, 0.01, on_device_downsample=True, device="cpu")


@pytest.mark.parametrize("upload", ["int16", "float32"])
def test_run_odometry_scan_matches_jax(traj, upload):
    scans, gt = traj
    jc, tc = _configs(**GRID)
    want = jkitti.run_odometry_scan(scans, 0.2, config=jc, upload_dtype=upload)
    got = kitti.run_odometry_scan(scans, 0.2, config=tc, upload_dtype=upload, device="cpu")
    _held(got, want, gt, TOL)


def test_run_odometry_scan_auto_grid_matches_jax(traj):
    """grid_dims None: the dense grid over the union of the frames
    (`auto_grid_dims_multi`), as the JAX function sizes it."""
    scans, gt = traj
    jc, tc = _configs()
    _held(kitti.run_odometry_scan(scans, 0.2, config=tc, device="cpu"),
          jkitti.run_odometry_scan(scans, 0.2, config=jc), gt, TOL)


@pytest.mark.parametrize("upload", ["int16", "float32"])
def test_ragged_upload_equals_jax(traj, monkeypatch, upload):
    """The ragged upload of `run_odometry_scan` (the frames' real points in
    one concatenation, int16 at JAX's scale absmax / 32000 or float32, the
    starts, counts and bucket) equals what the JAX function hands its scan
    program, exactly; the port's quantizer is numpy's rint (ties to even)
    or the native pass, as the JAX package's."""
    from fast_gicp_tpu.utils.downsample import voxel_downsample

    scans, _gt = traj
    got = {}

    def capture(flat, starts, counts, config, warm_start, scale, bucket):
        got.update(flat=np.asarray(flat), starts=np.asarray(starts),
                   counts=np.asarray(counts), bucket=bucket,
                   scale=None if scale is None else np.asarray(scale))
        return jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (len(starts) - 1, 4, 4))

    monkeypatch.setattr(jkitti, "_odometry_scan_deltas_ragged", capture)
    jkitti.run_odometry_scan(scans, 0.2, config=_configs(**GRID)[0], upload_dtype=upload)
    flat, starts, counts, scale, bucket = kitti.quantize_frames(
        [voxel_downsample(s, 0.2) for s in scans], upload)
    assert flat.dtype == got["flat"].dtype == (np.int16 if upload == "int16" else np.float32)
    np.testing.assert_array_equal(flat, got["flat"])
    np.testing.assert_array_equal(starts, got["starts"])
    np.testing.assert_array_equal(counts, got["counts"])
    assert bucket == got["bucket"]
    if upload == "int16":
        assert np.float32(scale) == got["scale"]
    else:
        assert scale is None and got["scale"] is None


def test_run_odometry_batched_matches_jax(traj):
    scans, gt = traj
    jc, tc = (c._replace(lsq=lsq) for c, lsq in zip(_configs(), (JaxLsqConfig(), LsqConfig())))
    want = jkitti.run_odometry_batched(scans, 0.2, batch_size=3, config=jc)
    got = kitti.run_odometry_batched(scans, 0.2, batch_size=3, config=tc, device="cpu")
    _held(got, want, gt, TOL)


def test_run_odometry_batched_straggler_rescue():
    """The JAX test's starved cap (2 iterations, 1.2 m and 4.5 deg a frame
    from identity, tests/test_odometry.py:80): unrescued the trajectory
    drifts, rescued it meets the ground truth at the usual bound."""
    from fast_gicp_tpu import se3 as jse3

    rng = np.random.default_rng(7)
    world = _world(rng)
    scans, gt = [], []
    T = np.eye(4)
    step = np.asarray(jse3.se3_exp(jnp.asarray(np.float32([0, 0, 0.08, 1.2, 0.1, 0]))))
    for _ in range(5):
        gt.append(T.copy())
        local = (world - T[:3, 3]) @ T[:3, :3]
        sel = rng.random(len(local)) < 0.7
        scans.append((local[sel] + 0.01 * rng.standard_normal((sel.sum(), 3)))
                     .astype(np.float32))
        T = T @ step
    cfg = _configs()[1]._replace(lsq=LsqConfig(max_iterations=2))
    capped = kitti.run_odometry_batched(scans, 0.2, batch_size=3, config=cfg, rescue=False,
                                        device="cpu")
    assert kitti.ate_rmse(gt, capped) > 0.05
    rescued = kitti.run_odometry_batched(scans, 0.2, batch_size=3, config=cfg, rescue=True,
                                         device="cpu")
    assert len(rescued) == len(gt) and kitti.ate_rmse(gt, rescued) < 0.05


def test_device_downsample_matches_jax(traj):
    """`device_downsample` on a raw scan: the valid mask, the live and
    out-of-grid counts equal JAX's exactly, the centroids within 1e-5 m;
    a grid too small drops points and counts them."""
    scans, _gt = traj
    from fast_gicp_tpu_torch.utils.padding import pad_points

    p, m = pad_points(scans[0])
    dims = voxelmap.auto_grid_dims_multi(scans, 0.2)
    assert dims == jvoxelmap.auto_grid_dims_multi(scans, 0.2)
    for grid, cap in ((dims, 4096), ((48, 48, 16), 64)):
        want = jvoxelmap.device_downsample(jnp.asarray(p), jnp.asarray(m), 0.2, cap, grid)
        got = voxelmap.device_downsample(torch.as_tensor(p), torch.as_tensor(m), 0.2, cap, grid)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[2]) == int(want[2]) and int(got[3]) == int(want[3])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    assert int(got[3]) > 0 and int(got[2]) > cap  # the small grid drops and overflows


def test_auto_grid_dims_multi_matches_jax(traj):
    scans, _gt = traj
    for res in (0.2, 1.0, 0.001):
        assert voxelmap.auto_grid_dims_multi(scans, res) == jvoxelmap.auto_grid_dims_multi(
            scans, res)
    assert voxelmap.auto_grid_dims_multi([np.zeros((0, 3))], 1.0) is None


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """Three synthetic frames in KITTI velodyne .bin layout (x, y, z, i), as
    tests/test_apps.py writes them."""
    d = tmp_path_factory.mktemp("velodyne")
    scans, gt = _trajectory_scans(np.random.default_rng(21), n_frames=3)
    for i, s in enumerate(scans):
        rec = np.concatenate([s, np.zeros((len(s), 1), np.float32)], axis=1)
        rec.astype(np.float32).tofile(d / f"{i:06d}.bin")
    return d, gt


@pytest.mark.parametrize("mode", ["serial", "stream", "scan", "map"])
def test_kitti_app_modes(kitti_dir, tmp_path, mode):
    """The app's twin end to end on the CPU: each mode writes three 3x4
    poses within the JAX app test's ATE bound."""
    d, gt = kitti_dir
    out = tmp_path / f"traj_{mode}.txt"
    app = runpy.run_path("fast_gicp_tpu_torch/apps/kitti.py")
    assert app["main"]([str(d), "--mode", mode, "--downsample", "0.3", "--out", str(out),
                        "--device", "cpu"]) == 0
    rows = np.loadtxt(out).reshape(-1, 3, 4)
    assert len(rows) == 3
    poses = kitti.load_poses_kitti(str(out))
    assert kitti.ate_rmse(gt, poses) < 0.05
