"""Port vs JAX: the GICP slice.  kNN covariances, the GICP objective,
`gicp_align`, `gicp_register_fresh` and `fitness_score` of
fast_gicp_tpu_torch (device="cpu") against fast_gicp_tpu's, on a small
voxel-sorted cloud and on the small synthetic LiDAR pair.

The port runs the fused kNN contract of the JAX package's TPU path on every
device: 256-query tiles search their 16 nearest 128-point target tiles.
The JAX package's CPU path searches 16 tiles of 256 points instead, so the
two candidate sets differ; the comparisons below say where that shows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu import se3 as jse3
from fast_gicp_tpu.models import gicp as jgicp
from fast_gicp_tpu.models import metrics as jmetrics
from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu.ops import pallas_kernels
from fast_gicp_tpu.ops import soa as jsoa
from fast_gicp_tpu_torch import convert, se3
from fast_gicp_tpu_torch.models import gicp, metrics
from fast_gicp_tpu_torch.ops import covariance
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic


@pytest.fixture(scope="module")
def pair():
    """Frames 30 (target) and 31 (source) of the synthetic drive (seed 0,
    a 400k-point world, 0.3 m downsample: about 5.5k points each, padded
    to 6,144), and the ground-truth target<-source pose."""
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=400_000)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    sp, sm = padding.pad_points(downsample.voxel_downsample(scans[31], 0.3))
    tp, tm = padding.pad_points(downsample.voxel_downsample(scans[30], 0.3))
    return dict(sp=sp, sm=sm, tp=tp, tm=tm, gt=np.linalg.inv(gt[30]) @ gt[31])


@pytest.fixture(scope="module")
def jax_covs(pair):
    """The JAX package's CPU kNN covariances (6, N) of both clouds."""
    return [np.asarray(jcov.knn_covariance_cols(jnp.asarray(pair[p]),
                                                jnp.asarray(pair[m])))
            for p, m in (("sp", "sm"), ("tp", "tm"))]


def _pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return np.linalg.norm(d[:3, 3]), np.degrees(np.arccos(cos))


def _voxel_sorted_cloud(n=2048, extent=10.0, res=0.5):
    rng = np.random.default_rng(2)
    pts = (rng.random((n, 3)) * extent).astype(np.float32)
    keys = np.floor(pts / res).astype(np.int64)
    pts = pts[np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))]
    mask = np.ones(n, bool)
    mask[-60:] = False
    return pts, mask


def _jax_fused_cols(points, mask, method):
    """The JAX package's TPU-path kNN covariances: the fused Pallas kernel
    (interpret mode), its finalize and the regularization."""
    mom, _kth, _excl = jcov._knn_moment_cols_fused(
        jnp.asarray(points), jnp.asarray(mask), 20, interpret=True)
    cov6 = jcov._finalize_mom_cols(mom)
    return np.asarray(jsoa.plane_covs_cols(cov6) if method == "plane" else cov6)


@pytest.mark.parametrize("method", ["plane", "none"])
def test_knn_covariance_cols_matches_fused_pallas(method):
    """Against the fused Pallas kernel (interpret) after finalize, on the
    valid points of a 2,048-point voxel-sorted cloud (10 m extent): the
    same neighbour sets, moments summed in two orders.  "none": every
    point within 1e-4.  "plane": at least 98% of the points within 1e-4
    (98.8% measured) and all within 1e-3 -- the smallest eigenvector of a
    near-isotropic neighbourhood turns with the last digits of its
    moments."""
    pts, mask = _voxel_sorted_cloud()
    want = _jax_fused_cols(pts, mask, method)
    got = covariance.knn_covariance_cols(torch.as_tensor(pts), torch.as_tensor(mask),
                                         method=method)
    assert got.shape == (6, 2048)
    diff = np.abs(got.numpy() - want).max(0)[mask]
    if method == "none":
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert np.mean(diff <= 1e-4) >= 0.98 and diff.max() <= 1e-3, np.sort(diff)[-5:]


def test_knn_covariances_small_pair_vs_jax_cpu(pair, jax_covs):
    """Against the JAX package's CPU kNN covariances on the small pair, on
    the points whose fused search is certified exact (k-th distance <= the
    nearest excluded tile's bbox gap): at least 98% of them within 1e-3,
    and at least 95% of the valid points certified.  The rest had true
    neighbours outside their 2,048 candidates, which the JAX CPU path's
    4,096 candidates reach: over all valid points 96.5% (source) and 98.1%
    (target) agree within 1e-3 (tests/torch_gicp_parity.py)."""
    for (p, m), want in zip((("sp", "sm"), ("tp", "tm")), jax_covs):
        pts, mask = torch.as_tensor(pair[p]), torch.as_tensor(pair[m])
        got = covariance.knn_covariances(pts, mask, device="cpu")
        assert got.shape == (pts.shape[0], 3, 3) and torch.isfinite(got).all()
        cols = covariance.knn_covariance_cols(pts, mask).numpy()
        np.testing.assert_array_equal(
            got.reshape(-1, 9)[:, [0, 1, 2, 4, 5, 8]].T.numpy(), cols)
        _mom, kth, excluded = covariance._knn_moment_cols_fused(pts, mask, 20)
        cert = (kth.reshape(-1, 256) <= excluded[:, None]).reshape(-1).numpy()
        cert &= pair[m]
        assert cert.sum() >= 0.95 * pair[m].sum()
        diff = np.abs(cols - want).max(0)
        assert np.mean(diff[cert] <= 1e-3) >= 0.98


def _jax_args(pair, covs):
    return (jnp.asarray(pair["sp"]), jnp.asarray(pair["sm"]), jnp.asarray(covs[0]),
            jnp.asarray(pair["tp"]), jnp.asarray(pair["tm"]), jnp.asarray(covs[1]))


def _port_args(pair, covs):
    return (pair["sp"], pair["sm"], convert.covs_from_numpy(covs[0], device="cpu"),
            pair["tp"], pair["tm"], convert.covs_from_numpy(covs[1], device="cpu"))


def test_gicp_evaluate_matches_jax(pair, jax_covs):
    """The GICP objective on identical (JAX-made) covariances at a
    perturbed pose: err rtol 1e-4, H and b within 1e-4 of their largest
    entry (sums over ~5.5k correspondences in two orders)."""
    x = se3.se3_exp(torch.tensor([0.01, -0.005, 0.02, 0.1, -0.05, 0.02]))
    e_j, H_j, b_j = jgicp.gicp_evaluate(*_jax_args(pair, jax_covs),
                                        jnp.asarray(x.numpy()))
    e, H, b = gicp.gicp_evaluate(*_port_args(pair, jax_covs), x, device="cpu")
    np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)
    H_j, b_j = np.asarray(H_j), np.asarray(b_j)
    np.testing.assert_allclose(H.numpy(), H_j, atol=1e-4 * np.abs(H_j).max())
    np.testing.assert_allclose(b.numpy(), b_j, atol=1e-4 * np.abs(b_j).max())


@pytest.mark.parametrize("refresh", [None, 2])
def test_gicp_align_matches_jax(pair, jax_covs, refresh):
    """gicp_align on identical covariances, re-searching every iteration
    and in the two-phase form: pose within 1e-3 of JAX's, iterations
    within 1, both within 0.05 m / 1 deg of the ground truth."""
    cfg = jgicp.GICPConfig(refresh_iterations=refresh)
    eye = np.eye(4, dtype=np.float32)
    jres = jgicp.gicp_align(*_jax_args(pair, jax_covs), jnp.asarray(eye), cfg)
    res = gicp.gicp_align(*_port_args(pair, jax_covs), eye,
                          convert.config_from_jax(cfg), device="cpu")
    got, want = convert.lsq_result_to_numpy(res), convert.lsq_result_to_numpy(jres)
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-3)
    assert abs(got.iterations - want.iterations) <= 1
    for T in (got.transformation, want.transformation):
        t_err, r_err = _pose_errors(T, pair["gt"])
        assert t_err < 0.05 and r_err < 1.0, (t_err, r_err)


@pytest.mark.parametrize("refresh", [None, 2])
def test_gicp_align_reads_rows_by_index_as_gathered(pair, jax_covs, refresh, monkeypatch):
    """The objective's freeze gives the linearize the target indices, and
    the kernel reads the rows by index: gicp_align then gives the pose,
    iterations and host syncs of the same solve with the rows gathered
    first, bit for bit."""
    from fast_gicp_tpu_torch.ops import cuda_linearize
    from fast_gicp_tpu_torch.solver import lsq_solve

    eye = np.eye(4, dtype=np.float32)
    cfg = gicp.GICPConfig(refresh_iterations=refresh)
    calls = []
    by_index = cuda_linearize.linearize

    def gathered(p, ca, x, rows, valid, idx=None):
        calls.append(idx.dtype)
        return by_index(p, ca, x, rows[idx.long()], valid)

    def run():
        lsq_solve.host_syncs = 0
        res = gicp.gicp_align(*_port_args(pair, jax_covs), eye, cfg, device="cpu")
        return res, lsq_solve.host_syncs

    res, syncs = run()
    monkeypatch.setattr(cuda_linearize, "linearize", gathered)
    want, want_syncs = run()
    assert calls and set(calls) == {torch.int32}
    assert torch.equal(res.transformation, want.transformation)
    assert int(res.iterations) == int(want.iterations) and syncs == want_syncs


def test_gicp_register_fresh_matches_jax(pair):
    """The slice end to end.  Against the JAX package's fresh registration
    as its TPU path runs it (fused kNN covariances, here in interpret mode,
    then gicp_align): pose within 1e-3, iterations within 1.  Against the
    JAX package's CPU gicp_register_fresh (other candidate tiles, so other
    covariances for ~3% of the points): both within 0.05 m / 1 deg of the
    ground truth; their poses differ by up to 1.3e-2 (t_err 16.3 mm for the
    port, 3.9 mm for JAX's CPU path; tests/torch_gicp_parity.py)."""
    args = (pair["sp"], pair["sm"], pair["tp"], pair["tm"])
    eye = np.eye(4, dtype=np.float32)
    res, scov, tcov = gicp.gicp_register_fresh(*args, eye, device="cpu")
    got = convert.lsq_result_to_numpy(res)
    assert scov.shape == (6, pair["sp"].shape[0]) and tcov.shape == (6, pair["tp"].shape[0])
    assert got.converged and np.isfinite(got.transformation).all()

    fused = [_jax_fused_cols(pair[p], pair[m], "plane")
             for p, m in (("sp", "sm"), ("tp", "tm"))]
    for got_cov, want_cov, m in ((scov, fused[0], pair["sm"]), (tcov, fused[1], pair["tm"])):
        # near-isotropic neighbourhoods may flip their plane (see above)
        assert np.mean(np.abs(got_cov.numpy() - want_cov).max(0)[m] <= 1e-3) >= 0.99
    jres = convert.lsq_result_to_numpy(jgicp.gicp_align(
        *_jax_args(pair, fused), jnp.asarray(eye)))
    np.testing.assert_allclose(got.transformation, jres.transformation, atol=1e-3)
    assert abs(got.iterations - jres.iterations) <= 1

    jcpu = jgicp.gicp_register_fresh(*(jnp.asarray(a) for a in args), jnp.asarray(eye))
    for T in (got.transformation, np.asarray(jcpu[0].transformation)):
        t_err, r_err = _pose_errors(T, pair["gt"])
        assert t_err < 0.05 and r_err < 1.0, (t_err, r_err)


def _jax_fitness_pallas(T, sp, sm, tp, tm, max_range):
    """The body of the JAX package's fitness_score with the search its TPU
    path runs (`nn_search_pallas`, interpret mode)."""
    p_t = jse3.transform_points(jnp.asarray(T), jnp.asarray(sp))
    _, sq = pallas_kernels.nn_search_pallas(p_t, jnp.asarray(tp), jnp.asarray(tm),
                                            interpret=True)
    ok = jnp.asarray(sm) & (sq <= max_range * max_range)
    return float(jnp.sum(jnp.where(ok, sq, 0.0)) / jnp.maximum(jnp.sum(ok), 1))


@pytest.mark.parametrize("pose", ["identity", "ground_truth"])
def test_fitness_score_matches_jax(pair, pose):
    """With and without a max_range: rtol 1e-4 against the JAX package's
    fitness_score as its TPU path computes it ((q - t)^2 distances, as the
    port's), and against its CPU fitness_score at the ground-truth pose.
    Off the ground truth the CPU path's |q|^2 - 2 q.t + |t|^2 distances
    lose digits to cancellation, and points near the max_range gate fall on
    the other side of it: at the identity with a 0.5 m gate it reads
    6.3e-4 relative below the port (tests/torch_gicp_parity.py)."""
    T = np.eye(4, dtype=np.float32) if pose == "identity" else pair["gt"].astype(np.float32)
    args = (pair["sp"], pair["sm"], pair["tp"], pair["tm"])
    for max_range in (np.inf, 0.5):
        got = metrics.fitness_score(T, *args, max_range=max_range, device="cpu")
        assert got.ndim == 0
        np.testing.assert_allclose(float(got), _jax_fitness_pallas(T, *args, max_range),
                                   rtol=1e-4)
        if pose == "ground_truth":
            want = float(jmetrics.fitness_score(
                jnp.asarray(T), *(jnp.asarray(a) for a in args), max_range=max_range))
            np.testing.assert_allclose(float(got), want, rtol=1e-4)


def test_pose_error_matches_jax(pair):
    """float32 in both packages: rtol 1e-5."""
    gt = pair["gt"].astype(np.float32)
    est = gt @ np.asarray(jse3.se3_exp(jnp.float32([0.01, 0, 0.02, 0.1, 0, 0])))
    t_j, r_j = jmetrics.pose_error(jnp.asarray(gt), jnp.asarray(est))
    t, r = metrics.pose_error(gt, est)
    np.testing.assert_allclose([float(t), float(r)], [float(t_j), float(r_j)], rtol=1e-5)


def test_config_from_jax_gicp():
    cfg = jgicp.GICPConfig(k_correspondences=10, max_correspondence_distance=2.0,
                           refresh_iterations=3)
    got = convert.config_from_jax(cfg)
    assert isinstance(got, gicp.GICPConfig)
    assert got._asdict().keys() == cfg._asdict().keys()
    for name in gicp.GICPConfig._fields:
        if name != "lsq":
            assert getattr(got, name) == getattr(cfg, name), name
    assert tuple(got.lsq) == tuple(cfg.lsq)
    assert gicp.GICPConfig() == convert.config_from_jax(jgicp.GICPConfig())


def test_unported_estimators_raise():
    """Every estimator and regularization is ported now (the kNN slab and
    adaptive-radius kernels): each gives finite (6, N) columns, and only
    what no package supports raises -- an unknown regularization or
    estimator, or an approximate search on a cloud that is not padded to a
    multiple of 256 -- a ValueError, with nothing falling back to another
    statistic."""
    pts, mask = (torch.as_tensor(a) for a in _voxel_sorted_cloud())
    for method in ("min_eig", "normalized_min_eig", "frobenius"):
        cols = covariance.knn_covariance_cols(pts, mask, method=method)
        assert cols.shape == (6, 2048) and torch.isfinite(cols).all()
    assert torch.isfinite(covariance.knn_covariance_cols(pts, mask, approx=False)).all()
    assert torch.isfinite(covariance.estimate_covariance_cols(pts, mask, "adaptive")).all()
    with pytest.raises(ValueError):
        covariance.knn_covariance_cols(pts, mask, method="bogus")
    with pytest.raises(ValueError):
        covariance.estimate_covariance_cols(pts, mask, "kdtree")
    with pytest.raises(ValueError):
        covariance.knn_covariance_cols(pts[:1000], mask[:1000])
