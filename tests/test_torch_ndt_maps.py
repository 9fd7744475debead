"""Port vs JAX: the NDT voxel maps and the MIN_EIG clamp
(fast_gicp_tpu_torch.ops.voxelmap / ops.soa against fast_gicp_tpu's).

Both packages get the same numpy points (already in the frame the maps are
built in, so no centroid is summed in two orders): a plane with near-planar
voxels, a dense blob and sparse points, with padding rows masked."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.ops import soa as jsoa
from fast_gicp_tpu.ops import voxelmap as jvox
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch.ops import soa, voxelmap
from tests.torch_cpu import warm_intra_op_threads

RES = 1.0


@pytest.fixture(autouse=True, scope="module")
def _warm_threads():
    warm_intra_op_threads()


def _cloud(seed, n=4096, pad=512):
    """A ground plane (voxels whose covariance has one eigenvalue far below
    1e-3), a dense blob and a sparse scatter, padded with masked rows."""
    rng = np.random.default_rng(seed)
    k = n // 3
    plane = np.column_stack([rng.uniform(-6, 6, k), rng.uniform(-6, 6, k),
                             0.002 * rng.standard_normal(k)])
    blob = rng.normal(size=(k, 3)) * 1.5 + [3.0, -2.0, 2.0]
    sparse = rng.uniform(-12, 12, size=(n - 2 * k, 3))
    pts = np.concatenate([plane, blob, sparse]).astype(np.float32)
    padded = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
    mask = np.arange(n + pad) < n
    return padded, mask, voxelmap.auto_grid_dims(pts, RES)


def _sym6(C):
    return np.stack([C[:, 0, 0], C[:, 0, 1], C[:, 0, 2],
                     C[:, 1, 1], C[:, 1, 2], C[:, 2, 2]]).astype(np.float32)


def test_clamp_eigs_cols_matches_jax():
    """Random SPD, near-planar (one eigenvalue ~1e-7), isotropic, two equal
    eigenvalues, rank one, zero and indefinite matrices.  Within 1e-5 of
    each column's largest entry: torch.arccos and XLA:CPU's arccos may
    differ in the last bit, which the Cayley-Hamilton projectors magnify
    near repeated eigenvalues."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(600, 3, 3))
    C = A @ np.swapaxes(A, 1, 2)
    Q, _ = np.linalg.qr(rng.normal(size=(600, 3, 3)))
    lam = np.stack([np.full(600, 1e-7), rng.uniform(1e-3, 0.5, 600),
                    rng.uniform(0.1, 1.0, 600)], 1)
    C[:100] = np.einsum("nij,nj,nkj->nik", Q[:100], lam[:100], Q[:100])  # near-planar
    C[100:150] = np.eye(3) * rng.uniform(1e-5, 1.0, (50, 1, 1))  # isotropic
    lam[150:200, 1] = lam[150:200, 2]  # two equal
    C[150:200] = np.einsum("nij,nj,nkj->nik", Q[150:200], lam[150:200], Q[150:200])
    v = rng.normal(size=(50, 3))
    C[200:250] = v[:, :, None] * v[:, None, :]  # rank one
    C[250:260] = 0.0
    C[260:300] = C[260:300] - 0.5 * np.eye(3)  # indefinite
    C6 = _sym6(C)
    got = soa.clamp_eigs_cols(torch.as_tensor(C6), 1e-3).numpy()
    want = np.asarray(jsoa.clamp_eigs_cols(jnp.asarray(C6), 1e-3))
    scale = np.abs(want).max(0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)
    # every clamped matrix has eigenvalues >= 1e-3 (up to f32 rounding)
    full = soa.sym_cols_to_rows9(torch.as_tensor(got)).reshape(-1, 3, 3).double()
    assert float(torch.linalg.eigvalsh(full).min()) > 1e-3 - 1e-5 * scale.max()


def test_sym_cols_from_packed_matches_jax():
    rows = np.random.default_rng(1).normal(size=(5, 64, 16)).astype(np.float32)
    got = soa.sym_cols_from_packed(torch.as_tensor(rows))
    want = jsoa.sym_cols_from_packed(jnp.asarray(rows))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_build_ndt_raw_grid_matches_jax(seed):
    """Claim grid and origin exact; the corner-relative moment sums within
    1e-6 (scatter-adds in the same index order, one rounding each)."""
    pts, mask, dims = _cloud(seed)
    got = voxelmap.build_ndt_raw_grid(torch.as_tensor(pts), torch.as_tensor(mask), RES, dims)
    want = jvox.build_ndt_raw_grid(jnp.asarray(pts), jnp.asarray(mask), RES, dims)
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    grid8 = np.asarray(want.grid8).reshape(-1)
    np.testing.assert_array_equal(got.grid[:-1].numpy(), grid8[:-8])
    assert got.dims == tuple(want.grid.shape)
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows), rtol=1e-6, atol=1e-6)
    assert not got.rows[-1].any()


@pytest.mark.parametrize("budget", [256, 4096])
@pytest.mark.parametrize("with_map, with_stats", [(True, True), (False, True), (True, False)])
def test_build_ndt_grid_compact_matches_jax(budget, with_map, with_stats):
    """Map rows and compact statistics within 1e-6 of the JAX build
    (relative to each row's scale for the clamped covariances).  256 is
    below the cloud's occupied voxel count: both drop the same voxels (the
    highest representative indices)."""
    pts, mask, dims = _cloud(2)
    got_map, got_stats = voxelmap.build_ndt_grid_compact(
        torch.as_tensor(pts), torch.as_tensor(mask), RES, dims, budget=budget,
        with_map=with_map, with_stats=with_stats)
    want_map, want_stats = jvox.build_ndt_grid_compact(
        jnp.asarray(pts), jnp.asarray(mask), RES, dims, budget=budget,
        with_map=with_map, with_stats=with_stats)
    assert (got_map is None) == (not with_map)
    assert (got_stats is None) == (not with_stats)
    if with_map:
        np.testing.assert_allclose(got_map.packed.numpy(), np.asarray(want_map.packed),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got_map.grid[:-1].numpy(),
                                      np.asarray(want_map.grid8).reshape(-1)[:-8])
        occupied = int((got_map.packed[:, 12] > 0).sum())
        n_occ = len(np.unique(np.floor(pts[mask] / RES - 0.5), axis=0))
        assert occupied == min(budget, n_occ)
        if budget < n_occ:
            assert occupied == budget  # the overflow drops voxels
    if with_stats:
        means, valid, cov6 = got_stats
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_stats[1]))
        np.testing.assert_allclose(means.numpy(), np.asarray(want_stats[0]), atol=1e-5)
        np.testing.assert_allclose(cov6.numpy(), np.asarray(want_stats[2]),
                                   rtol=1e-5, atol=1e-6)


def test_lookup_ndt_cols_matches_jax():
    """Rows gathered through the lookup equal the JAX package's for hits
    (every occupied voxel and its 26 neighbours), misses (empty cells) and
    out-of-grid queries, which read the zero row.  Ids agree inside the
    grid; outside it JAX may return a parked point's id, whose row is zero
    as well."""
    pts, mask, dims = _cloud(3)
    tmap, _ = voxelmap.build_ndt_grid_compact(torch.as_tensor(pts), torch.as_tensor(mask),
                                              RES, dims, budget=4096)
    jmap, _ = jvox.build_ndt_grid_compact(jnp.asarray(pts), jnp.asarray(mask), RES, dims,
                                          budget=4096)
    traw = voxelmap.build_ndt_raw_grid(torch.as_tensor(pts), torch.as_tensor(mask), RES, dims)
    jraw = jvox.build_ndt_raw_grid(jnp.asarray(pts), jnp.asarray(mask), RES, dims)
    occ = np.unique(np.floor(pts[mask] / RES - 0.5).astype(np.int32), axis=0)
    shifts = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)])
    q = (occ[None] + shifts[:, None]).reshape(-1, 3)
    far = np.array([[9999, 0, 0], [0, -9999, 0], [0, 0, 9999], [-5000, -5000, -5000]])
    q = np.concatenate([q, far]).astype(np.int32)
    inside = np.all((q - np.asarray(jmap.origin) >= 0) & (q - np.asarray(jmap.origin) < dims), 1)
    assert (~inside).sum() >= 4 and inside.sum() > len(occ)
    for tm, jm, table, jtable in ((tmap, jmap, tmap.packed, jmap.packed),
                                  (traw, jraw, traw.rows, jraw.rows)):
        ids = voxelmap.lookup_ndt_cols(tm, *(torch.as_tensor(q[:, a]) for a in range(3)))
        jids = np.asarray(jvox.lookup_ndt_cols(jm, *(jnp.asarray(q[:, a]) for a in range(3))))
        np.testing.assert_array_equal(ids.numpy()[inside], jids[inside])
        np.testing.assert_allclose(table[ids].numpy(), np.asarray(jtable)[jids],
                                   rtol=1e-5, atol=1e-6)
        assert (ids.numpy()[~inside] == pts.shape[0]).all()
        assert not table[ids[torch.as_tensor(~inside)]].any()
        misses = table[ids][:, 0 if tm is traw else 12] == 0
        assert int(misses.sum()) > int((~inside).sum())  # empty cells as well


def test_maps_carried_across_by_convert():
    """`convert` rebuilds the JAX maps as the port's, equal to the port's own
    build on the same points."""
    pts, mask, dims = _cloud(4)
    jraw = jvox.build_ndt_raw_grid(jnp.asarray(pts), jnp.asarray(mask), RES, dims)
    jmap, jstats = jvox.build_ndt_grid_compact(jnp.asarray(pts), jnp.asarray(mask), RES, dims,
                                               budget=2048, with_stats=True)
    raw = convert.raw_ndt_grid_from_numpy(jraw.rows, jraw.grid8, jraw.origin,
                                          jraw.resolution, jraw.grid.shape, device="cpu")
    fin = convert.ndt_grid_map_from_numpy(jmap.packed, jmap.grid8, jmap.origin,
                                          jmap.resolution, jmap.grid.shape, device="cpu")
    stats = convert.ndt_stats_from_numpy(*jstats, device="cpu")
    own_raw = voxelmap.build_ndt_raw_grid(torch.as_tensor(pts), torch.as_tensor(mask), RES, dims)
    own_map, own_stats = voxelmap.build_ndt_grid_compact(
        torch.as_tensor(pts), torch.as_tensor(mask), RES, dims, budget=2048, with_stats=True)
    assert raw.dims == own_raw.dims == fin.dims and raw.resolution == RES
    assert torch.equal(raw.grid[:-1], own_raw.grid[:-1])
    assert torch.equal(fin.grid[:-1], own_map.grid[:-1])
    torch.testing.assert_close(raw.rows, own_raw.rows, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(fin.packed, own_map.packed, rtol=1e-5, atol=1e-6)
    assert torch.equal(stats[1], own_stats[1])


def test_compact_ids_is_static_nonzero():
    """The first `budget` true indices ascending, filled with n; the count
    of true entries."""
    rng = np.random.default_rng(5)
    for n, budget, p in ((1000, 64, 0.3), (1000, 500, 0.3), (100, 100, 0.0), (50, 80, 1.0)):
        occ = rng.uniform(size=n) < p
        ids, count = voxelmap.compact_ids(torch.as_tensor(occ), budget)
        want = np.full(budget, n)
        nz = np.nonzero(occ)[0][:budget]
        want[:len(nz)] = nz
        np.testing.assert_array_equal(ids.numpy(), want)
        assert int(count) == int(occ.sum())
