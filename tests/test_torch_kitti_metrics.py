"""The trajectory metrics and the int16 quantizer of the port
(`fast_gicp_tpu_torch/utils/kitti.py`, `fast_gicp_tpu_torch/native.py`),
held to the JAX package's own copies (`fast_gicp_tpu/utils/kitti.py`,
`fast_gicp_tpu/native.py`): the same numpy code, so the metrics agree within
1e-9 and the quantized values, the absmax and the KITTI pose files exactly.
"""

import numpy as np
import pytest

from fast_gicp_tpu import native as jnative
from fast_gicp_tpu.utils import kitti as jkitti
from fast_gicp_tpu_torch import native
from fast_gicp_tpu_torch.utils import kitti


def _trajectories(n=40, seed=0):
    """A ground-truth drive (a curve with yaw) and a drifting estimate."""
    rng = np.random.default_rng(seed)
    gt, est = [], []
    for i in range(n):
        th = 0.02 * i
        T = np.eye(4)
        T[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        T[:3, 3] = [10 * np.sin(th), 10 * (1 - np.cos(th)), 0.01 * i]
        gt.append(T)
        E = T.copy()
        d = 0.01 * rng.normal(size=3) + 0.002 * i
        c, s = np.cos(1e-3 * i), np.sin(1e-3 * i)
        E[:3, :3] = T[:3, :3] @ np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        E[:3, 3] = T[:3, 3] + d
        est.append(E)
    return gt, est


@pytest.mark.parametrize("n", [40, 5, 2])
def test_trajectory_metrics_match_jax(n):
    gt, est = _trajectories(n)
    assert kitti.ate_rmse(gt, est) == pytest.approx(jkitti.ate_rmse(gt, est), abs=1e-9)
    assert kitti.ate_rmse_aligned(gt, est) == pytest.approx(jkitti.ate_rmse_aligned(gt, est),
                                                            abs=1e-9)
    for delta in (1, 3):
        np.testing.assert_allclose(kitti.rpe(gt, est, delta), jkitti.rpe(gt, est, delta),
                                   atol=1e-9, rtol=0)
    R, t = kitti.align_trajectories(gt, est)
    R_j, t_j = jkitti.align_trajectories(gt, est)
    np.testing.assert_allclose(R, R_j, atol=1e-9)
    np.testing.assert_allclose(t, t_j, atol=1e-9)
    got, want = kitti.trajectory_report(gt, est), jkitti.trajectory_report(gt, est)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


def test_rpe_of_a_single_pose_is_nan():
    gt, est = _trajectories(1)
    assert all(np.isnan(v) for v in kitti.rpe(gt, est))


def test_pose_files_and_scan_paths_match_jax(tmp_path):
    gt, est = _trajectories(6)
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    kitti.save_poses_kitti(str(a), est)
    jkitti.save_poses_kitti(str(b), est)
    assert a.read_text() == b.read_text()
    for got, want in zip(kitti.load_poses_kitti(str(a)), jkitti.load_poses_kitti(str(b))):
        np.testing.assert_array_equal(got, want)
    for i in (2, 0, 1):
        (tmp_path / f"{i:06d}.bin").write_bytes(b"")
    assert kitti.kitti_scan_paths(str(tmp_path)) == jkitti.kitti_scan_paths(str(tmp_path))
    assert kitti.kitti_scan_paths(str(tmp_path), 2) == jkitti.kitti_scan_paths(str(tmp_path), 2)


def test_absmax_and_quantize_i16_match_jax():
    """absmax and rint(x * inv) as int16 (ties to even: 0.5 -> 0, 1.5 -> 2,
    -2.5 -> -2) equal the JAX package's, whichever of the native pass or
    numpy runs (`quantize_available`); NaN propagates through absmax."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1000, 3)) * 30).astype(np.float32)
    ties = np.asarray([[0.5, 1.5, -2.5], [2.5, -0.5, 3.5]], np.float32)
    assert native.quantize_available() == jnative.quantize_available()
    for a in (x, ties, np.zeros((0, 3), np.float32)):
        assert native.absmax(a) == jnative.absmax(a)
    assert np.isnan(native.absmax(np.asarray([1.0, np.nan], np.float32)))
    for src, inv in ((x, 32000.0 / native.absmax(x)), (ties, 1.0)):
        got, want = np.empty(src.shape, np.int16), np.empty(src.shape, np.int16)
        native.quantize_i16(src, inv, got)
        jnative.quantize_i16(src, inv, want)
        np.testing.assert_array_equal(got, want)
    out = np.empty(ties.shape, np.int16)
    native.quantize_i16(ties, 1.0, out)
    np.testing.assert_array_equal(out, [[0, 2, -2], [2, 0, 4]])
    with pytest.raises(ValueError, match="int16"):
        native.quantize_i16(ties, 1.0, np.empty(ties.shape, np.int32))
    with pytest.raises(ValueError, match="contiguous"):
        native.quantize_i16(ties, 1.0, np.empty((3, 2), np.int16).T)
