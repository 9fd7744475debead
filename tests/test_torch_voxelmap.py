"""Port vs JAX: the dense raw voxel grid (fast_gicp_tpu_torch.ops.voxelmap
against fast_gicp_tpu.ops.voxelmap), and the state carried between the two
packages (fast_gicp_tpu_torch.convert)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.ops import voxelmap as jvox
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch.ops import voxelmap

RES = 1.0


def _scene(seed=2, n=2048):
    """Clustered points (several per voxel, some voxels far apart), SPD
    covariances and a mask with 10% of the points off."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-12.0, 12.0, (40, 3))
    pts = centers[rng.integers(0, 40, n)] + rng.normal(size=(n, 3)) * 0.6
    A = rng.normal(size=(n, 3, 3)) * 0.2
    covs = A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(3)
    mask = rng.uniform(size=n) > 0.1
    return pts.astype(np.float32), covs.astype(np.float32), mask


def _both(pts, covs, mask, dims):
    jmap = jvox.build_raw_grid(jnp.asarray(pts), jnp.asarray(mask), RES,
                               jnp.asarray(covs), dims)
    tmap = voxelmap.build_raw_grid(torch.as_tensor(pts), torch.as_tensor(mask),
                                   RES, torch.as_tensor(covs), dims)
    return jmap, tmap


@pytest.mark.parametrize("cov_layout", ["aos", "sym6"])
def test_build_raw_grid_matches_jax(cov_layout):
    """Rows rtol 1e-6 (atol 1e-5 on the sums of up to ~100 m-scale
    coordinates): both packages add the same f32 contributions into the
    same representative rows; only the order of the additions differs.
    The claim grid and origin are equal exactly."""
    pts, covs, mask = _scene()
    dims = voxelmap.auto_grid_dims(pts[mask], RES)
    assert dims == jvox.auto_grid_dims(pts[mask], RES)
    jmap = jvox.build_raw_grid(jnp.asarray(pts), jnp.asarray(mask), RES,
                               jnp.asarray(covs), dims)
    tcovs = torch.as_tensor(covs)
    if cov_layout == "sym6":
        from fast_gicp_tpu_torch.ops import soa
        tcovs = soa.sym_cols_from_covs(tcovs)
    tmap = voxelmap.build_raw_grid(torch.as_tensor(pts), torch.as_tensor(mask),
                                   RES, tcovs, dims)
    np.testing.assert_array_equal(tmap.origin.numpy(), np.asarray(jmap.origin))
    ncells = int(np.prod(dims))
    np.testing.assert_array_equal(
        tmap.grid.numpy()[:ncells], np.asarray(jmap.grid8).reshape(-1)[:ncells])
    np.testing.assert_allclose(tmap.rows.numpy(), np.asarray(jmap.rows),
                               rtol=1e-6, atol=1e-5)
    assert float(tmap.rows[:, 0].sum()) == mask.sum()
    np.testing.assert_array_equal(tmap.rows[-1].numpy(), 0.0)


def test_lookup_raw_rows_cols_matches_jax():
    """Lookups on query coords inside the grid, in empty cells and outside
    the grid on every side: exact, since both gather the same rows."""
    pts, covs, mask = _scene()
    dims = voxelmap.auto_grid_dims(pts[mask], RES)
    jmap, tmap = _both(pts, covs, mask, dims)
    origin = np.asarray(jmap.origin)
    rng = np.random.default_rng(9)
    # coords spanning the grid and 3 cells beyond it on each side
    q = origin + rng.integers(-3, np.asarray(dims) + 3, (4096, 3))
    q = q.astype(np.int32)
    want = np.asarray(jvox.lookup_raw_rows_cols(
        jmap, dims, jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]),
        jnp.asarray(q[:, 2])))
    tq = torch.as_tensor(q)
    got = voxelmap.lookup_raw_rows_cols(tmap, dims, tq[:, 0], tq[:, 1],
                                        tq[:, 2]).numpy()
    # the draw exercises hits, empty cells and out-of-grid coords
    rel = q - origin
    outside = np.any((rel < 0) | (rel >= np.asarray(dims)), axis=1)
    assert outside.sum() > 100 and (got[~outside, 0] == 0).sum() > 100
    assert (got[:, 0] > 0).sum() > 10
    np.testing.assert_array_equal(got[outside], 0.0)
    np.testing.assert_array_equal(got, want)


def test_raw_grid_from_numpy_round_trips_the_jax_map():
    """The JAX map's arrays, through `convert.raw_grid_from_numpy`, give
    the same lookups in the port as the port's own map."""
    pts, covs, mask = _scene(seed=4)
    dims = voxelmap.auto_grid_dims(pts[mask], RES)
    jmap, tmap = _both(pts, covs, mask, dims)
    cmap = convert.raw_grid_from_numpy(jmap.rows, jmap.grid8, jmap.origin,
                                       jmap.resolution, device="cpu")
    q = torch.as_tensor(voxelmap.voxel_coord(torch.as_tensor(pts), RES))
    a = voxelmap.lookup_raw_rows_cols(cmap, dims, q[:, 0], q[:, 1], q[:, 2])
    b = voxelmap.lookup_raw_rows_cols(tmap, dims, q[:, 0], q[:, 1], q[:, 2])
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-5)
    assert cmap.resolution == RES


def test_voxel_coord_true_division_matches_jax():
    """floor(p / res - 0.5) at and around cell boundaries, for a
    resolution whose reciprocal is inexact: exact."""
    res = 0.3
    k = np.arange(-200, 200, dtype=np.float32)
    p = np.concatenate([(k + 0.5) * np.float32(res),
                        np.nextafter((k + 0.5) * np.float32(res), np.float32(np.inf)),
                        np.nextafter((k + 0.5) * np.float32(res), np.float32(-np.inf))])
    p = np.stack([p, -p, p * 0.5], axis=1).astype(np.float32)
    want = np.asarray(jvox.voxel_coord(jnp.asarray(p), res))
    got = voxelmap.voxel_coord(torch.as_tensor(p), res).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["direct1", "direct7", "direct27", "direct_radius"])
def test_neighbor_offsets_and_grid_dims_match_jax(method):
    np.testing.assert_array_equal(voxelmap.neighbor_offsets(method),
                                  jvox.neighbor_offsets(method))
    pts, _covs, _mask = _scene()
    for res in (0.5, 1.0, 2.0):
        assert voxelmap.auto_grid_dims(pts, res) == jvox.auto_grid_dims(pts, res)
    assert voxelmap.auto_grid_dims(pts * 100.0, 0.1) is None
    assert jvox.auto_grid_dims(pts * 100.0, 0.1) is None
    # ~2.4e6 cells a side: the cell count no longer fits in int64, which
    # the port's Python-int product still rejects
    assert voxelmap.auto_grid_dims(pts * 1e4, 0.1) is None
