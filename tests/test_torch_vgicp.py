"""Port vs JAX: the whole slice.  `vgicp_register` (RBF covariances for
both clouds, the dense raw voxel grid, the two-phase LM solve in the
target-centroid frame) of fast_gicp_tpu_torch with device="cpu" against
fast_gicp_tpu's on the small synthetic LiDAR pair, and the VGICP objective
evaluated by both packages on the same (JAX-built) voxel map."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.models import vgicp as jvgicp
from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu.ops import voxelmap as jvox
from fast_gicp_tpu.utils import downsample as jdown
from fast_gicp_tpu.utils import padding as jpad
from fast_gicp_tpu.utils import synthetic as jsyn
from fast_gicp_tpu_torch import convert, se3
from fast_gicp_tpu_torch.models import vgicp
from fast_gicp_tpu_torch.ops import soa
from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims, neighbor_offsets
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic


@pytest.fixture(scope="module")
def pair():
    """Frames 30 (target) and 31 (source) of the synthetic drive (seed 0,
    a 400k-point world, 0.3 m downsample: about 5.5k points each, padded
    to 6,144), made by the port's numpy-only utils, and the ground-truth
    target<-source pose."""
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=400_000)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    target = downsample.voxel_downsample(scans[30], 0.3)
    source = downsample.voxel_downsample(scans[31], 0.3)
    sp, sm = padding.pad_points(source)
    tp, tm = padding.pad_points(target)
    cfg = jvgicp.VGICPConfig(grid_dims=auto_grid_dims(target, 1.0),
                             refresh_iterations=2)
    return dict(sp=sp, sm=sm, tp=tp, tm=tm, cfg=cfg, scans=scans,
                gt=np.linalg.inv(gt[30]) @ gt[31])


def _pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return np.linalg.norm(d[:3, 3]), np.degrees(np.arccos(cos))


def test_utils_are_identical_copies(pair):
    """The port's numpy-only utils give the JAX package's arrays exactly."""
    rng = np.random.default_rng(0)
    world = jsyn.drive_world(rng, n=400_000)
    scans, _gt = jsyn.drive_scans(rng, n_frames=32, world=world)
    np.testing.assert_array_equal(scans[30], pair["scans"][30])
    tp, tm = jpad.pad_points(jdown.voxel_downsample(scans[30], 0.3))
    np.testing.assert_array_equal(tp, pair["tp"])
    np.testing.assert_array_equal(tm, pair["tm"])
    assert pair["tp"].shape[0] == 6144 and padding.DEFAULT_BUCKET == 2048


def test_vgicp_register_matches_jax(pair):
    """The slice end to end: pose elementwise within 1e-3 of JAX's,
    iterations within 1, and both within 0.05 m / 1 deg of the ground
    truth (gicp_test.cpp:148-149).  Summation orders differ (chunked
    matmul moments vs the port's, XLA reductions vs torch.sum)."""
    cfg = pair["cfg"]
    args = (pair["sp"], pair["sm"], pair["tp"], pair["tm"])
    eye = np.eye(4, dtype=np.float32)
    res = vgicp.vgicp_register(*args, eye, convert.config_from_jax(cfg),
                               device="cpu")
    jres = jvgicp.vgicp_register(*(jnp.asarray(a) for a in args),
                                 jnp.asarray(eye), cfg)
    got = convert.lsq_result_to_numpy(res)
    want = convert.lsq_result_to_numpy(jres)
    assert got.transformation.shape == (4, 4)
    assert np.isfinite(got.transformation).all()
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-3)
    assert abs(got.iterations - want.iterations) <= 1
    assert got.converged
    for T in (got.transformation, want.transformation):
        t_err, r_err = _pose_errors(T, pair["gt"])
        assert t_err < 0.05 and r_err < 1.0, (t_err, r_err)
    # The world-frame Hessian (A^T H' A through the translation adjoint),
    # within 1% of its largest entry: it is taken at the last
    # linearization point, which differs between the two solves as the
    # poses do, and the plane-regularized covariances of near-isotropic
    # neighbourhoods may differ between the two summation orders.
    scale = np.abs(want.hessian).max()
    np.testing.assert_allclose(got.hessian, want.hessian, atol=1e-2 * scale)


def test_vgicp_objective_on_jax_map_matches_jax(pair):
    """The port's raw-grid objective, fed the JAX package's voxel map and
    covariances through `convert`, against JAX's objective at a perturbed
    pose: err rtol 1e-4, H and b within 1e-4 of their largest entry (sums
    over ~5.5k correspondences in two orders)."""
    cfg = pair["cfg"]
    sp, sm, tp, tm = (pair[k] for k in ("sp", "sm", "tp", "tm"))
    c = tp[tm].mean(0).astype(np.float32)
    src, tgt = sp - c, tp - c
    scov = jcov.rbf_covariances(jnp.asarray(src), jnp.asarray(sm))
    tcov = jcov.rbf_covariances(jnp.asarray(tgt), jnp.asarray(tm))
    jmap = jvox.build_raw_grid(jnp.asarray(tgt), jnp.asarray(tm), 1.0, tcov,
                               cfg.grid_dims)
    offs = neighbor_offsets("direct1")
    jlin, _jerr = jvgicp.make_vgicp_objective(
        jnp.asarray(src), jnp.asarray(sm), scov, jmap, jnp.asarray(offs), cfg)
    tmap = convert.raw_grid_from_numpy(jmap.rows, jmap.grid8, jmap.origin,
                                       jmap.resolution, device="cpu")
    lin, err_fn, _f, _lf = vgicp.make_vgicp_objective(
        torch.as_tensor(src), torch.as_tensor(sm),
        soa.sym_cols_from_covs(torch.tensor(np.asarray(scov))), tmap, offs,
        convert.config_from_jax(cfg))
    x = se3.se3_exp(torch.tensor([0.01, -0.005, 0.02, 0.1, -0.05, 0.02]))
    e_j, H_j, b_j, _aux = jlin(jnp.asarray(x.numpy()))
    e, H, b, aux = lin(x)
    np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j),
                               atol=1e-4 * np.abs(np.asarray(H_j)).max())
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j),
                               atol=1e-4 * np.abs(np.asarray(b_j)).max())
    np.testing.assert_allclose(float(err_fn(x, aux)), float(e), rtol=1e-5)


@pytest.mark.parametrize("refresh", [None, 2])
def test_vgicp_align_reads_rows_by_index_as_gathered(pair, refresh, monkeypatch):
    """The objective's freeze gives the linearize the voxel row ids (int64),
    and the kernel reads the map's rows by id: vgicp_align then gives the
    pose, iterations and host syncs of the same solve with the rows gathered
    first, bit for bit."""
    from fast_gicp_tpu_torch.ops import cuda_linearize
    from fast_gicp_tpu_torch.ops.covariance import rbf_covariance_cols
    from fast_gicp_tpu_torch.solver import lsq_solve

    cfg = convert.config_from_jax(pair["cfg"])._replace(refresh_iterations=refresh)
    sp, sm, tp, tm = (torch.as_tensor(pair[k]) for k in ("sp", "sm", "tp", "tm"))
    scov, tcov = rbf_covariance_cols(sp, sm), rbf_covariance_cols(tp, tm)
    eye = np.eye(4, dtype=np.float32)
    calls = []
    by_index = cuda_linearize.linearize_raw

    def gathered(p, ca, x, rows, valid, idx=None):
        calls.append(idx.dtype)
        return by_index(p, ca, x, rows[idx], valid)

    def run():
        lsq_solve.host_syncs = 0
        res = vgicp.vgicp_align(sp, sm, scov, tp, tm, tcov, eye, cfg, device="cpu")
        return res, lsq_solve.host_syncs

    res, syncs = run()
    monkeypatch.setattr(cuda_linearize, "linearize_raw", gathered)
    want, want_syncs = run()
    assert calls and set(calls) == {torch.int64}
    assert torch.equal(res.transformation, want.transformation)
    assert int(res.iterations) == int(want.iterations) and syncs == want_syncs


def test_config_from_jax_and_back():
    cfg = jvgicp.VGICPConfig(grid_dims=(64, 64, 32), refresh_iterations=2)
    got = convert.config_from_jax(cfg)
    assert isinstance(got, vgicp.VGICPConfig)
    assert got._asdict().keys() == cfg._asdict().keys()
    for name in vgicp.VGICPConfig._fields:
        if name != "lsq":
            assert getattr(got, name) == getattr(cfg, name), name
    assert tuple(got.lsq) == tuple(cfg.lsq)
    assert vgicp.VGICPConfig() == convert.config_from_jax(jvgicp.VGICPConfig())
