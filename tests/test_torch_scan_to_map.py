"""Scan-to-map odometry (`fast_gicp_tpu_torch/models/scan_to_map.py`) with
device="cpu", held to the JAX package's `models/scan_to_map.py` on the same
inputs (the JAX side on the CPU, as its own tests run it).

The scenes are the JAX tests' own: `tests/test_odometry._trajectory_scans`
(seed 5, 7 frames, 0.2 m downsample, `capacity=1 << 14`) and uniform random
points.  Tolerances:
  * the map's integer fields (coords, lut, num_voxels) exactly equal: each
    is an integer scatter with one winner (a lut slot, a voxel id);
  * the map's sums within 1e-5 of each row's largest |entry| (scatter-adds
    in another order);
  * `align_to_map` poses on one map and one set of covariances within 1e-4
    for each objective;
  * the odometry frame by frame within 1e-3 m (RBF covariances; measured
    1.2e-6), ATE under 0.05 m (the JAX test's bound); maps fused at poses
    that far apart: integers and counts equal, voxel means within 1e-3 m;
  * `process_chunk` against `process` within 1e-5 (the JAX test's bound).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fast_gicp_tpu.models import scan_to_map as J
from fast_gicp_tpu.ops.covariance import rbf_covariance_cols as jax_rbf_cols
from fast_gicp_tpu.utils.downsample import voxel_downsample
from fast_gicp_tpu.utils.padding import pad_points
from fast_gicp_tpu_torch.models import scan_to_map as T
from fast_gicp_tpu_torch.utils.kitti import ate_rmse

from tests.test_odometry import _trajectory_scans

POSE_TOL = 1e-3  # m, frame by frame against JAX (RBF covariances)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene():
    scans, gt = _trajectory_scans(np.random.default_rng(5), n_frames=7)
    return [voxel_downsample(s, 0.2) for s in scans], gt


def _jcfg(**kw):
    return J.ScanToMapConfig(resolution=1.0, capacity=1 << 14, **kw)


def _tcfg(**kw):
    return T.ScanToMapConfig(resolution=1.0, capacity=1 << 14, **kw)


_FIELDS = ("sums", "coords", "lut", "num_voxels", "resolution")


def _host(js):
    """A JAX MapState as numpy arrays (the JAX calls donate their input
    state, so a fixture keeps host copies)."""
    return J.MapState(*(np.array(getattr(js, f)) for f in _FIELDS))


def _to_jax(hs) -> J.MapState:
    return J.MapState(*(jnp.asarray(getattr(hs, f)) for f in _FIELDS))


def _to_torch(js) -> T.MapState:
    return T.MapState(*(torch.as_tensor(np.array(getattr(js, f))) for f in _FIELDS[:4]),
                      resolution=float(np.asarray(js.resolution)))


def _assert_same_map(js, ts, name=""):
    for f in ("coords", "lut", "num_voxels"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f"{name}: {f}")
    want = np.asarray(js.sums)
    scale = np.maximum(np.abs(want).max(axis=1), 1e-30)
    rel = np.abs(ts.sums.numpy() - want).max(axis=1) / scale
    assert rel.max() <= 1e-5, (name, rel.max())
    assert ts.resolution == float(np.asarray(js.resolution))


def _assert_same_fused_map(js, ts, name=""):
    """Maps that fused the same scans at poses up to POSE_TOL apart: the
    integer fields and the counts equal, each voxel's mean within POSE_TOL m
    and its mean covariance within 2e-2 of its largest entry (read: 1.2e-2;
    the per-point RBF covariances differ by the JAX CPU path's d^2 form,
    |q|^2 - 2 q.t + |t|^2, which the plane projection magnifies, ROADMAP
    section 3)."""
    for f in ("coords", "lut", "num_voxels"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f"{name}: {f}")
    want, got = np.asarray(js.sums), ts.sums.numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0], err_msg=f"{name}: counts")
    n = np.maximum(want[:, :1], 1.0)
    np.testing.assert_allclose(got[:, 1:4] / n, want[:, 1:4] / n, atol=POSE_TOL, rtol=0,
                               err_msg=f"{name}: means")
    cov_w, cov_g = want[:, 4:] / n, got[:, 4:] / n
    scale = np.maximum(np.abs(cov_w).max(axis=1), 1e-30)
    assert (np.abs(cov_g - cov_w).max(axis=1) / scale).max() <= 2e-2, name


@pytest.fixture(scope="module")
def jax_odometry(scene):
    """JAX's per-frame trajectory, its final map and its map after frame 3."""
    scans, _gt = scene
    odo = J.ScanToMapOdometry(_jcfg())
    after3 = None
    for i, s in enumerate(scans):
        odo.process(s)
        if i == 3:
            after3 = _host(odo.state)
    return odo.poses, _host(odo.state), after3


@pytest.fixture(scope="module")
def torch_odometry(scene):
    scans, _gt = scene
    odo = T.ScanToMapOdometry(_tcfg(), device="cpu")
    for s in scans:
        odo.process(s)
    return odo


def _random_frames(seed, n, frames, spread=40.0):
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(size=(n, 3)) * spread - spread / 2).astype(np.float32)
    covs = np.einsum("nij,nkj->nik", *(2 * [rng.normal(size=(n, 3, 3)).astype(np.float32)]))
    mask = rng.random(n) < 0.9
    return [(pts + 3.0 * f, covs, mask) for f in range(frames)]


@pytest.mark.parametrize("case", [
    dict(capacity=1024, new_cap=512, table_factor=8),   # capacity fills, overflow dropped
    dict(capacity=64, new_cap=16384, table_factor=2),   # a loaded lut: probe windows fill
    dict(capacity=8192, new_cap=128, table_factor=8),   # per-frame cap: the rest retried
], ids=["capacity", "table_load", "new_cap"])
def test_update_map_matches_jax(case):
    """`update_map` frame after frame: the lut, coords and voxel count
    equal JAX's exactly, the sums within 1e-5 of each row's scale; every
    committed row reachable through the lut (claim-first insertion)."""
    js = J.empty_map(case["capacity"], 1.0, table_factor=case["table_factor"])
    ts = T.empty_map(case["capacity"], 1.0, table_factor=case["table_factor"], device="cpu")
    _assert_same_map(js, ts, "empty")
    for f, (pts, covs, mask) in enumerate(_random_frames(0, 3000, 4)):
        js = J.update_map(js, jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(mask),
                          new_cap=case["new_cap"])
        before = ts
        ts = T.update_map(ts, pts, covs, mask, new_cap=case["new_cap"], device="cpu")
        _assert_same_map(js, ts, f"frame {f}")
        nv = int(ts.num_voxels)
        lut = ts.lut.numpy()
        np.testing.assert_array_equal(np.sort(lut[lut[:, 0] != T._EMPTY, 0]), np.arange(nv))
        assert before.sums is not ts.sums  # the input state is left as it was
    assert int(ts.num_voxels) > 0


def test_update_map_cov9_rows_and_voxel_view_match_jax(rng):
    """(N, 9) covariance rows go in as (N, 3, 3) do; `map_as_voxelmap`'s
    view (means, covs, clamped count in packed[:, 12], table) equals JAX's."""
    pts, covs, mask = _random_frames(1, 1500, 1, spread=1.5)[0]
    js = J.update_map(J.empty_map(2048, 0.5), jnp.asarray(pts), jnp.asarray(covs),
                      jnp.asarray(mask))
    ts = T.update_map(T.empty_map(2048, 0.5, device="cpu"), pts, covs.reshape(-1, 9), mask,
                      device="cpu")
    _assert_same_map(js, ts)
    jv, tv = J.map_as_voxelmap(js), T.map_as_voxelmap(ts)
    np.testing.assert_array_equal(tv.table.numpy(), np.asarray(jv.table))
    np.testing.assert_array_equal(tv.counts.numpy(), np.asarray(jv.counts))
    np.testing.assert_allclose(tv.packed.numpy(), np.asarray(jv.packed), rtol=1e-5, atol=1e-6)
    assert float(tv.packed[:, 12].max()) == 25.0  # the weight count clamps


@pytest.mark.parametrize("op", ["grow", "compact", "re_anchor", "merge", "merge_moved",
                                "from_voxels"])
def test_map_operations_match_jax(jax_odometry, op):
    """grow_map, compact_map, re_anchor_map, merge_maps (plain and with a
    transform) and map_from_voxels on JAX's odometry map: the integer
    fields exactly equal, the sums within 1e-5 of each row's scale."""
    _poses, hs, hs3 = jax_odometry
    ts, ts3 = _to_torch(hs), _to_torch(hs3)
    js, js3 = _to_jax(hs), _to_jax(hs3)
    if op == "grow":
        want, got = J.grow_map(js, 1 << 15), T.grow_map(ts, 1 << 15)
        assert T.grow_map(ts, 1 << 10) is ts
    elif op == "compact":
        want = J.compact_map(js, jnp.asarray([1.0, 0.5, 0.0]), jnp.float32(12.0))
        js = _to_jax(hs)
        got = T.compact_map(ts, torch.tensor([1.0, 0.5, 0.0]), 12.0)
        assert 0 < int(got.num_voxels) < int(ts.num_voxels)
    elif op == "re_anchor":
        want = J.re_anchor_map(js, jnp.asarray([3, -2, 1], jnp.int32))
        got = T.re_anchor_map(ts, np.asarray([3, -2, 1], np.int32))
    elif op == "from_voxels":
        n = int(hs.num_voxels)
        want = J.map_from_voxels(hs.sums[:n], hs.coords[:n], 1.0)
        got = T.map_from_voxels(ts.sums[:n], ts.coords[:n].numpy(), 1.0, device="cpu")
    else:
        T_b = None
        if op == "merge_moved":
            c, s = np.cos(0.3), np.sin(0.3)
            T_b = np.asarray([[c, -s, 0, 2.0], [s, c, 0, -1.0], [0, 0, 1, 0.5], [0, 0, 0, 1]])
        want = J.merge_maps(js, js3, transform_b=T_b)
        got = T.merge_maps(ts, ts3, transform_b=T_b, device="cpu")
    _assert_same_map(want, got, op)


def test_align_to_map_matches_jax(scene, jax_odometry):
    """`align_to_map` on JAX's map after frame 3, frame 4 from the frame-3
    pose, JAX's RBF covariances on both sides: each objective's pose within
    1e-4 of JAX's, the same iterations."""
    scans, gt = scene
    poses, _hs, hs3 = jax_odometry
    ts3 = _to_torch(hs3)
    p, m = pad_points(scans[4])
    c = np.asarray(jax_rbf_cols(jnp.asarray(p), jnp.asarray(m)))
    guess = np.asarray(poses[3], np.float32)
    for objective in ("vgicp", "ndt_d2d", "ndt_p2d"):
        want = J.align_to_map(_to_jax(hs3), jnp.asarray(p), jnp.asarray(m), jnp.asarray(c),
                              jnp.asarray(guess), _jcfg(objective=objective))
        got = T.align_to_map(ts3, p, m, c, guess, _tcfg(objective=objective), device="cpu")
        np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                                   atol=1e-4, err_msg=objective)
        assert int(got.iterations) == int(want.iterations), objective
        assert bool(got.converged) and bool(want.converged)
        t_err = np.linalg.norm(got.transformation.numpy()[:3, 3] - gt[4][:3, 3])
        assert t_err < 0.05, (objective, t_err)


def test_odometry_matches_jax_frame_by_frame(scene, jax_odometry, torch_odometry):
    """`ScanToMapOdometry.process` (RBF covariances) frame by frame within
    1e-3 m of JAX's, its map's integers equal JAX's, ATE under 0.05 m."""
    scans, gt = scene
    want, js, _ = jax_odometry
    got = torch_odometry.poses
    assert len(got) == len(scans)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=POSE_TOL, err_msg=f"frame {i}")
    _assert_same_fused_map(js, torch_odometry.state, "odometry map")
    assert ate_rmse(gt, got) < 0.05


def test_process_chunk_matches_process(scene, torch_odometry):
    """`process_chunk` (frames in turn, no host read between them; warm-up
    frames per frame) reproduces `process` within 1e-5."""
    scans, gt = scene
    chunked = T.ScanToMapOdometry(_tcfg(), device="cpu")
    chunked.process_chunk(scans[:4])  # includes the 2 warm-up frames
    chunked.process_chunk(scans[4:])
    assert len(chunked.poses) == len(scans)
    for a, b in zip(torch_odometry.poses, chunked.poses):
        np.testing.assert_allclose(b, a, atol=1e-5)
    assert ate_rmse(gt, chunked.poses) < 0.05


def test_knn_covariance_odometry_tracks(scene):
    """covariance="knn" (k 20, plane) tracks the drive (ATE under 0.05 m).
    Not held to JAX frame by frame: JAX's CPU kNN searches 256-point tiles,
    the port's fused contract 128-point ones (ROADMAP section 3)."""
    scans, gt = scene
    odo = T.ScanToMapOdometry(_tcfg(), covariance="knn", device="cpu")
    odo.process_chunk(scans)
    assert ate_rmse(gt, odo.poses) < 0.05


def _gate_cases():
    eye = np.eye(4, dtype=np.float32)
    near, far, nan = eye.copy(), eye.copy(), eye.copy()
    near[:3, 3] = [0.1, 0.0, 0.0]
    far[:3, 3] = [10.0, 0.0, 0.0]
    nan[0, 3] = np.nan
    turned = eye.copy()
    turned[:2, :2] = [[np.cos(0.4), -np.sin(0.4)], [np.sin(0.4), np.cos(0.4)]]
    live, H, dead = 100.0, np.eye(6, dtype=np.float32), np.zeros((6, 6), np.float32)
    return {
        "near": (near, True, live, H), "far": (far, True, live, H),
        "turned": (turned, True, live, H), "unconverged": (near, False, live, H),
        "dead": (near, True, 0.0, dead), "zero_residual": (near, True, 0.0, H),
        "nan_error": (near, True, np.nan, H), "nan_pose": (nan, True, live, H),
    }


@pytest.mark.parametrize("name", list(_gate_cases()))
def test_gate_pose_matches_jax(name):
    """`_gate_pose` on every case of the JAX test (tests/test_scan_to_map.py:
    240), NaN included, with and without the re-lock streak: the pose and
    flags equal JAX's."""
    pose, conv, err, H = _gate_cases()[name]
    eye = np.eye(4, dtype=np.float32)
    for streak in (None, 0, 5):
        kw_j = {} if streak is None else dict(streak=jnp.int32(streak), relock_after=5)
        kw_t = {} if streak is None else dict(streak=torch.tensor(streak, dtype=torch.int32),
                                              relock_after=5)
        want = J._gate_pose(jnp.asarray(pose), jnp.asarray(eye), jnp.asarray(conv),
                            jnp.float32(err), jnp.asarray(H), 0.5, 0.2, **kw_j)
        got = T._gate_pose(torch.as_tensor(pose), torch.as_tensor(eye), torch.tensor(conv),
                           torch.tensor(err, dtype=torch.float32), torch.as_tensor(H), 0.5, 0.2,
                           **kw_t)
        assert len(got) == len(want)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        if streak != 5:  # the re-lock accepts a live align even with a NaN pose
            assert np.isfinite(got[0].numpy()).all()
        for g, w in zip(got[1:], want[1:]):
            assert g.item() == np.asarray(w).item(), (name, streak)
    rejected = T._gate_pose(torch.as_tensor(pose), torch.as_tensor(eye), torch.tensor(conv),
                            torch.tensor(err, dtype=torch.float32), torch.as_tensor(H), 0.5,
                            0.2)[1].item()
    assert rejected == (name not in ("near", "zero_residual"))


def test_save_load_across_packages(tmp_path, scene, jax_odometry, torch_odometry):
    """A map saved by either package loads in the other with the same keys,
    dtypes and values; the port resumes a mapping run from its own
    checkpoint (map, last pose, velocity) as the uninterrupted run goes on."""
    scans, _gt = scene
    _poses, hs, _ = jax_odometry
    js = _to_jax(hs)
    j_path, t_path = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    J.save_map(j_path, js)
    torch_odometry.save(t_path)
    z_j, z_t = np.load(j_path), np.load(t_path)
    assert sorted(z_j.files) == sorted(z_t.files)
    for k in z_j.files:
        assert z_j[k].dtype == z_t[k].dtype and z_j[k].shape == z_t[k].shape, k
    _assert_same_map(js, T.load_map(j_path, device="cpu"), "jax -> torch")
    back = J.load_map(t_path)
    for f in ("coords", "lut", "num_voxels", "sums"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      getattr(torch_odometry.state, f).numpy())

    first = T.ScanToMapOdometry(_tcfg(), device="cpu")
    for s in scans[:5]:
        first.process(s)
    ckpt = str(tmp_path / "resume.npz")
    first.save(ckpt)
    resumed = T.ScanToMapOdometry(_tcfg(), initial_map=T.load_map(ckpt, device="cpu"),
                                  initial_pose=first.poses[-1],
                                  initial_velocity=first.velocity, device="cpu")
    np.testing.assert_allclose(resumed.process(scans[5]), first.process(scans[5]), atol=1e-5)


def test_localization_matches_jax(scene, jax_odometry):
    """Localization on a frozen map (fuse_scans=False, NDT D2D, every frame
    aligned, the map untouched), from JAX's final map: poses frame by frame
    within 1e-3 m of JAX's on the same map, and within 0.05 m of the mapping
    pass."""
    scans, _gt = scene
    mapping, hs, _ = jax_odometry
    ts = _to_torch(hs)
    want = J.ScanToMapOdometry(_jcfg(fuse_scans=False, objective="ndt_d2d"),
                               initial_map=_to_jax(hs))
    got = T.ScanToMapOdometry(_tcfg(fuse_scans=False, objective="ndt_d2d"), initial_map=ts,
                              device="cpu")
    for s in scans[:5]:
        want.process(s)
        got.process(s)
    for a, b, c in zip(got.poses, want.poses, mapping):
        np.testing.assert_allclose(a, b, atol=POSE_TOL)
        assert np.linalg.norm(a[:3, 3] - c[:3, 3]) < 0.05
    _assert_same_map(hs, got.state, "frozen map")


def test_growth_eviction_and_re_anchor_match_jax(scene):
    """The odometry's growth and eviction policy on a small map (capacity 256, a fill check every
    frame, eviction every 2 frames at 15 m) over 6 frames of the scene: it grows and
    evicts as JAX's does (equal capacity and voxel integers after every
    frame, poses within 1e-3 m); `re_anchor` shifts map and poses by the same
    whole cells."""
    scans = scene[0][:6]  # the growth to 2,048 and an eviction fall in 6 frames
    kw = dict(resolution=1.0, capacity=256, max_capacity=4096, grow_check_every=1,
              eviction_radius=15.0, evict_every=2)
    want = J.ScanToMapOdometry(J.ScanToMapConfig(**kw))
    got = T.ScanToMapOdometry(T.ScanToMapConfig(**kw), device="cpu")
    evicted = False
    for s in scans:
        want.process(s)
        before = int(got.state.num_voxels)
        got.process(s)
        evicted |= int(got.state.num_voxels) < before
        assert got.state.sums.shape[0] == want.state.sums.shape[0]
        assert int(got.state.num_voxels) == int(want.state.num_voxels)
    assert got.state.sums.shape[0] > 256 and evicted
    for a, b in zip(got.poses, want.poses):
        np.testing.assert_allclose(a, b, atol=POSE_TOL)
    _assert_same_fused_map(want.state, got.state, "grown and evicted")
    np.testing.assert_array_equal(got.re_anchor(), want.re_anchor())
    _assert_same_fused_map(want.state, got.state, "re-anchored")
    for a, b in zip(got.poses, want.poses):
        np.testing.assert_allclose(a, b, atol=POSE_TOL)
