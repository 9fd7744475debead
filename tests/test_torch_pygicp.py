"""Port vs JAX: `pygicp.align_points` for each of its four methods with
device="cpu" against the JAX package's `pygicp.align_points` on the CPU,
from the raw scans of the synthetic drive through align_points' own
downsample (the PCL ApproximateVoxelGrid emulation, the same numpy code in
both packages).

GICP, VGICP and VGICP_CUDA take frames 30/31 of the seed-0 400k-point
world at 0.3 m, NDT_CUDA frames 30/31 of the full-size world at 0.1 m (the
0.3 m pair is too sparse for NDT's > 6 points gate, tests/test_torch_ndt.py).
The JAX result is first held to the reference's accuracy (t < 0.05 m,
r < 1 deg), then serves as the oracle: the port's pose within 1e-3.  The
classes' covariances are kNN: JAX's CPU path searches other candidate
tiles than its TPU path and the port (~3% of the covariances differ,
poses 3-7 mm apart here), so the JAX classes run their TPU path's kNN
covariances, the fused Pallas kernel in interpret mode, as
tests/test_torch_classes.py runs them.  Even then the moments' finalize
about each query tile's first point cancels up to ~1e4-fold, so ~5.5% of
the plane covariances differ by more than 1e-4
(tests/test_torch_vgicp_stall.py); VGICP_CUDA (k = 20, DIRECT1, 1 m voxels
on this sparse pair) turns that into poses 1.12e-3 apart and is held
within 2e-3.
"""

import jax
import numpy as np
import pytest
import torch

from fast_gicp_tpu import pygicp as jpygicp
from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu.ops import soa as jsoa
from fast_gicp_tpu_torch import pygicp
from fast_gicp_tpu_torch.models import base, gicp, ndt, vgicp
from fast_gicp_tpu_torch.utils import downsample, synthetic

# method -> (world points or None for the full-size world, downsample resolution)
SCENES = {"GICP": (400_000, 0.3), "VGICP": (400_000, 0.3), "VGICP_CUDA": (400_000, 0.3),
          "NDT_CUDA": (None, 0.1)}
POSE_TOL = {"VGICP_CUDA": 2e-3}  # else 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch ops: the suite runs six
    test processes on the host's cores, and torch's default of one thread
    a core in each slows every process."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _scans(n_world):
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, **({} if n_world is None else {"n": n_world}))
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    return scans[30], scans[31], np.linalg.inv(gt[30]) @ gt[31]


@pytest.fixture(scope="module")
def scenes():
    return {n: _scans(n) for n in {w for w, _r in SCENES.values()}}


def _pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return np.linalg.norm(d[:3, 3]), np.degrees(np.arccos(cos))


@pytest.fixture(scope="module")
def jax_tpu_knn():
    """JAX's kNN covariances through its TPU path's fused kernel (interpret
    mode) for this module; the jit caches are cleared on both sides."""
    def fused_cols(points, mask, k=20, method="plane", chunk_size=1024, approx=True):
        mom, _kth, _excl = jcov._knn_moment_cols_fused(points, mask, k, interpret=True)
        cov6 = jcov._finalize_mom_cols(mom)
        return jsoa.plane_covs_cols(cov6) if method == "plane" else cov6

    mp = pytest.MonkeyPatch()
    jax.clear_caches()
    mp.setattr(jcov, "knn_covariance_cols", fused_cols)
    yield
    mp.undo()
    jax.clear_caches()


@pytest.mark.parametrize("method", list(SCENES))
def test_align_points_matches_jax(scenes, method, jax_tpu_knn):
    n_world, res = SCENES[method]
    target, source, gt = scenes[n_world]
    want = jpygicp.align_points(target, source, method=method, downsample_resolution=res)
    got = pygicp.align_points(target, source, method=method, downsample_resolution=res,
                              device="cpu")
    t_err, r_err = _pose_errors(want, gt)
    assert t_err < 0.05 and r_err < 1.0, (t_err, r_err)
    assert got.shape == (4, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(want), atol=POSE_TOL.get(method, 1e-3))


def test_make_reg_and_surface():
    """The method strings build the classes the JAX package builds, with its
    settings; a bad method raises; the module exports the pygicp names."""
    kinds = {"GICP": gicp.FastGICP, "VGICP": vgicp.FastVGICP, "VGICP_CUDA": vgicp.FastVGICPCuda,
             "NDT_CUDA": ndt.NDTCuda}
    for method, cls in kinds.items():
        reg = pygicp._make_reg(method, 12, 2.0, 0.5, "DIRECT7", 2.5, device="cpu")
        jreg = jpygicp._make_reg(method, 12, 2.0, 0.5, "DIRECT7", 2.5)
        assert isinstance(reg, cls) and type(jreg).__name__ == cls.__name__
        for f in ("k_correspondences", "resolution", "neighbor_search_method",
                  "neighbor_search_radius", "max_correspondence_distance"):
            assert getattr(reg, f, None) == getattr(jreg, f, None), (method, f)
    with pytest.raises(ValueError, match="method must be one of"):
        pygicp._make_reg("ICP", 12, 2.0, 0.5, "DIRECT1", 1.5, device="cpu")
    assert pygicp.LsqRegistration is base.Registration
    assert pygicp.downsample is downsample.approximate_voxel_downsample
    assert pygicp.voxel_downsample is downsample.voxel_downsample
    assert set(jpygicp.__all__) <= set(pygicp.__all__)
    pts = np.random.default_rng(1).normal(size=(500, 3)).astype(np.float32)
    np.testing.assert_array_equal(pygicp.downsample(pts, 0.5), jpygicp.downsample(pts, 0.5))
