"""Shared by tests/test_torch_align_rows_*.py: the `apps/align.py` twin's
`--device-loop` bodies at 2 trips on the CPU, as `DeviceRow` runs them (the
trip in the device form's plain version), against JAX bodies composed from
the same public functions and configs as the root app's `run_device_rows`
(apps/align.py:97-228) on the same jitters: each trip's pose within 1e-3
and its iterations within 1 (tests/test_torch_classes.py's bounds).

The pair is tests/test_torch_align_app.py's (frames 30/31 of the seed-0
drive, a 250k-point world, 0.5 m), on which JAX's CPU kNN covariances
(another candidate search than the port's fused contract) move no pose by
1e-3.  The rows are
split over three test files so that the JAX compiles of each run on a
worker of their own."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu_torch.apps import align as app
from fast_gicp_tpu_torch.utils import downsample, synthetic

TRIPS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rows(*names):
    """(name, col) pytest parameters of the named methods' rows."""
    return [pytest.param(n, c, id=f"{n}-{c}") for n in names for c in ("fresh", "reuse")]


def jax_bodies(source, target):
    """The root app's bodies (apps/align.py:97-228) without the scan: name ->
    (fresh, reuse), each a function of a (4, 4) jitter."""
    from fast_gicp_tpu.models.gicp import GICPConfig, gicp_align
    from fast_gicp_tpu.models.ndt import (
        NDTConfig, ndt_align, ndt_align_prebuilt, ndt_prepare_cloud,
    )
    from fast_gicp_tpu.models.vgicp import VGICPConfig, vgicp_align, vgicp_register
    from fast_gicp_tpu.ops.voxelmap import auto_grid_dims, build_ndt_grid_compact
    from fast_gicp_tpu.utils.padding import pad_points

    sp, sm = map(jnp.asarray, pad_points(source))
    tp, tm = map(jnp.asarray, pad_points(target))
    dims = auto_grid_dims(target, 1.0)
    ndims = auto_grid_dims(np.concatenate([source, target]), 1.0)
    eye = jnp.eye(4, dtype=jnp.float32)
    vcfg = VGICPConfig(grid_dims=dims, refresh_iterations=2)
    gcfg = GICPConfig(refresh_iterations=2)
    ncfg_d2d = NDTConfig(resolution=1.0, grid_dims=ndims, refresh_iterations=3,
                         max_source_voxels=2048)
    ncfg_p2d = ncfg_d2d._replace(distance_mode="p2d", refresh_iterations=3)
    # the precomputed covariances and maps, made at a body's first call (a
    # file compiles only what its rows run)
    pre = functools.cache(lambda kind: (jcov.rbf_covariances(sp, sm), jcov.rbf_covariances(tp, tm))
                          if kind == "rbf" else
                          (jcov.knn_covariances(sp, sm), jcov.knn_covariances(tp, tm)))

    def moved(J):
        return sp @ J[:3, :3].T + J[:3, 3], tp @ J[:3, :3].T + J[:3, 3]

    def rot(J, covs):
        return jnp.einsum("ij,njk,lk->nil", J[:3, :3], covs, J[:3, :3])

    def fgicp_fresh(J):
        sj, tj = moved(J)
        return gicp_align(sj, sm, jcov.knn_covariance_cols(sj, sm), tj, tm,
                          jcov.knn_covariance_cols(tj, tm), eye, gcfg)

    def fgicp_reuse(J):
        sj, tj = moved(J)
        return gicp_align(sj, sm, rot(J, pre("knn")[0]), tj, tm, rot(J, pre("knn")[1]), eye, gcfg)

    def vgicp_fresh(J):
        sj, tj = moved(J)
        return vgicp_align(sj, sm, jcov.knn_covariance_cols(sj, sm), tj, tm,
                           jcov.knn_covariance_cols(tj, tm), eye, vcfg)

    def vgicp_reuse(J):
        sj, tj = moved(J)
        return vgicp_align(sj, sm, rot(J, pre("knn")[0]), tj, tm, rot(J, pre("knn")[1]), eye, vcfg)

    def vgicp_rbf_fresh(J):
        sj, tj = moved(J)
        return vgicp_register(sj, sm, tj, tm, eye, vcfg)

    def vgicp_rbf_reuse(J):
        sj, tj = moved(J)
        return vgicp_align(sj, sm, rot(J, pre("rbf")[0]), tj, tm, rot(J, pre("rbf")[1]), eye, vcfg)

    def ndt_body(cfg):
        def body(J):
            sj, tj = moved(J)
            return ndt_align(sj, sm, tj, tm, eye, cfg)
        return body

    def ndt_reuse_body(cfg):
        prepared = functools.cache(lambda: ndt_prepare_cloud(tp, tm, cfg))

        def body(J):
            tvm, _, tcen = prepared()
            sj = sp @ J[:3, :3].T + J[:3, 3]
            if cfg.distance_mode == "d2d":
                w = sm.astype(sj.dtype)
                scen = jnp.sum(sj * w[:, None], 0) / jnp.maximum(jnp.sum(w), 1.0)
                _, stats = build_ndt_grid_compact(sj - scen, sm, cfg.resolution, cfg.grid_dims,
                                                  budget=cfg.max_source_voxels, with_map=False,
                                                  with_stats=True)
            else:
                stats, scen = None, tcen
            return ndt_align_prebuilt(sj, sm, stats, scen, tvm, tcen, eye, cfg)
        return body

    def adaptive(align_fn, cfg):
        def body(J):
            sj, tj = moved(J)
            return align_fn(sj, sm, jcov.adaptive_radius_covariances(sj, sm), tj, tm,
                            jcov.adaptive_radius_covariances(tj, tm), eye, cfg)
        return body

    return {
        "fgicp": (fgicp_fresh, fgicp_reuse),
        "fgicp_adaptive": (adaptive(gicp_align, gcfg), fgicp_reuse),
        "vgicp": (vgicp_fresh, vgicp_reuse),
        "vgicp_adaptive": (adaptive(vgicp_align, vcfg), vgicp_reuse),
        "vgicp_rbf": (vgicp_rbf_fresh, vgicp_rbf_reuse),
        "ndt_d2d": (ndt_body(ncfg_d2d), ndt_reuse_body(ncfg_d2d)),
        "ndt_p2d": (ndt_body(ncfg_p2d), ndt_reuse_body(ncfg_p2d)),
    }


def sides():
    """(port bodies, JAX bodies, jitters (TRIPS, 4, 4)) on the pair; the
    module's jit caches are cleared on both sides."""
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=250_000)
    scans, _gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    target, source = (downsample.approximate_voxel_downsample(scans[i], 0.5) for i in (30, 31))
    jax.clear_caches()
    jit = app.jitters(TRIPS)
    yield (app.device_bodies(source, target, "cpu"), jax_bodies(source, target), jit)
    jax.clear_caches()


def check_row(sides, name, col):
    """The row at its trips against the JAX body, trip by trip."""
    port, jbodies, jit = sides
    k = 0 if col == "fresh" else 1
    row = app.DeviceRow(port[name][k], torch.as_tensor(jit))
    poses, iters = row.run()
    assert row.graph.graph is None  # the CPU form: no graph, the device form's host loop
    for t in range(TRIPS):
        want = jbodies[name][k](jnp.asarray(jit[t]))
        np.testing.assert_allclose(poses[t].numpy(), np.asarray(want.transformation),
                                   atol=1e-3, err_msg=f"{name} {col} trip {t}")
        assert abs(int(iters[t]) - int(want.iterations)) <= 1, (name, col, t)
