"""Port vs JAX: the k-NN slab search and the regularizations.  The plain
version of the `knn_slab` kernel (fast_gicp_tpu_torch.ops.cuda_kernels)
against the Pallas body `knn_slab_pallas` (interpret mode) and against
fast_gicp_tpu.ops.neighbors' exact `knn_search`; the port's
`knn_search_culled` and `knn_search`; `regularize_covariances` in all five
modes; and the kNN and RBF covariance estimators with the regularizations
and the exact search that reach the slab kernel, against the JAX
package's CPU path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu.ops import neighbors as jneighbors
from fast_gicp_tpu.ops import pallas_kernels
from fast_gicp_tpu.ops import soa as jsoa
from fast_gicp_tpu_torch.ops import covariance, cuda_kernels, neighbors
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic


def _voxel_sorted_cloud(n=2048, extent=10.0, res=0.5, masked=70, seed=11):
    """A cloud in voxel-key order (the layout the tile culling relies on)
    with its last `masked` points masked."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * extent).astype(np.float32)
    keys = np.floor(pts / res).astype(np.int64)
    pts = pts[np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))]
    mask = np.ones(n, bool)
    mask[n - masked:] = False
    return pts, mask


@pytest.fixture(scope="module")
def small_target():
    """Frame 30 of the synthetic drive (seed 0, a 400k-point world, 0.3 m
    downsample), padded to 6,144 points: 24 tiles of 256, so the culled
    search leaves 8 of them out of every slab."""
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=400_000)
    scans, _gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    return padding.pad_points(downsample.voxel_downsample(scans[30], 0.3))


def _slab_emulation(query, qmask, target, tmask, cidx, k, ct):
    """numpy emulation of the slab contract with every operation rounded on
    its own: masked points parked at MASK_COORD, a tile id outside the
    target read as masked points, d^2 = ((dx^2 + dy^2) + dz^2) of each
    query tile against its candidate slab, a stable sort, the first k
    (global ids, d^2)."""
    park = np.float32(cuda_kernels.MASK_COORD)
    qry = np.where(qmask[:, None], query, park)
    tiles = np.where(tmask[:, None], target, park).reshape(-1, ct, 3)
    idx, sq = [], []
    for i, row in enumerate(np.asarray(cidx)):
        inside = (row >= 0) & (row < len(tiles))
        cand = np.where(inside[:, None, None], tiles[np.clip(row, 0, len(tiles) - 1)], park)
        cand = cand.reshape(-1, 3)
        gid = (row[:, None] * ct + np.arange(ct)).reshape(-1)
        q = qry[256 * i:256 * (i + 1)]
        d = np.zeros((256, cand.shape[0]), np.float32)
        for a in range(3):
            dd = q[:, a:a + 1] - cand[None, :, a]
            d = d + dd * dd
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        idx.append(gid[order])
        sq.append(np.take_along_axis(d, order, axis=1))
    return np.concatenate(idx).astype(np.int32), np.concatenate(sq)


def _untied(sq, tol):
    """(Nq, k) bool: positions whose d^2 is farther than tol from its
    neighbours in the row, where the order is unambiguous."""
    gap = np.diff(sq, axis=1) > tol
    ok = np.ones(sq.shape, bool)
    ok[:, 1:] &= gap
    ok[:, :-1] &= gap
    return ok


def test_knn_slab_plain_matches_pallas():
    """C = 4 tiles of 256 on a 2,048-point voxel-sorted cloud, k = 8.
    idx and sq bit-equal to the numpy emulation of the contract; against
    `knn_slab_pallas` (interpret mode) sq within rtol 1e-6 (XLA on the CPU
    contracts d^2's multiply-adds, so 20% of its entries differ by an ulp)
    and idx equal at every position not within 1e-5 of a neighbour in its
    row (all of them here)."""
    pts, mask = _voxel_sorted_cloud()
    n, k, C = pts.shape[0], 8, 4
    jt = jneighbors._masked_target(jnp.asarray(pts), jnp.asarray(mask))
    cidx_j, _ = jneighbors.select_candidate_tiles(
        jnp.asarray(pts).reshape(-1, 256, 3), jt.reshape(-1, 256, 3), C)
    idx_j, sq_j = pallas_kernels.knn_slab_pallas(
        jnp.asarray(pts), jnp.ones(n, bool), jnp.asarray(pts), jnp.asarray(mask),
        cidx_j, k, cand_tile=256, interpret=True)
    cidx = np.array(cidx_j)
    p = torch.as_tensor(pts)
    idx, sq = cuda_kernels.knn_slab(p, torch.ones(n, dtype=torch.bool), p,
                                    torch.as_tensor(mask), torch.as_tensor(cidx), k)
    assert idx.dtype == torch.int32 and idx.shape == (n, k) and sq.shape == (n, k)
    idx_e, sq_e = _slab_emulation(pts, np.ones(n, bool), pts, mask, cidx, k, 256)
    np.testing.assert_array_equal(idx.numpy(), idx_e)
    np.testing.assert_array_equal(sq.numpy(), sq_e)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_j), rtol=1e-6)
    untied = _untied(sq.numpy(), 1e-5)
    np.testing.assert_array_equal(idx.numpy()[untied], np.asarray(idx_j)[untied])
    assert untied.mean() > 0.99


SLAB_CASES = {c["name"]: c for c in synthetic.knn_slab_edge_cases()}


def _slab_args(case):
    return (torch.as_tensor(case["query"]), torch.as_tensor(case["qmask"]),
            torch.as_tensor(case["target"]), torch.as_tensor(case["tmask"]),
            torch.as_tensor(case["cidx"]), case["k"], case["cand_tile"])


@pytest.mark.parametrize("name", SLAB_CASES)
def test_knn_slab_edge_cases_plain_matches_emulation(name):
    """Every edge case of `synthetic.knn_slab_edge_cases` (ties across slab
    positions and tiles, slabs with fewer than k valid targets, tile ids -1
    and T, masked queries, k in {1, 20, 32}, both tile widths, the exact
    search): the plain version's idx and sq bit-equal to the numpy
    emulation on every row, masked queries included (the kernel computes
    them too)."""
    case = SLAB_CASES[name]
    idx, sq = cuda_kernels.knn_slab(*_slab_args(case))
    idx_e, sq_e = _slab_emulation(case["query"], case["qmask"], case["target"], case["tmask"],
                                  case["cidx"], case["k"], case["cand_tile"])
    np.testing.assert_array_equal(idx.numpy(), idx_e)
    np.testing.assert_array_equal(sq.numpy(), sq_e)


@pytest.mark.parametrize("name", [n for n, c in SLAB_CASES.items() if c["in_range"]])
def test_knn_slab_edge_cases_match_pallas(name):
    """The edge cases whose tile ids are all in range (the JAX package
    gathers other ids by its own indexing rules) against `knn_slab_pallas`
    (interpret mode): sq within rtol 1e-6 on every row (XLA on the CPU
    contracts d^2's multiply-adds, which moves the parked points' ~3e18 by
    an ulp); idx equal on every valid query's row, at every position where
    d^2 is exact (the grid cases: ties there are exact in both packages and
    go to the lower slab position in both), else where it is not within
    1e-6 of a neighbour in its row, relatively, or its tie is between two
    copies of one point.  Masked queries sit at MASK_COORD,
    whose d^2 both packages round differently."""
    case = SLAB_CASES[name]
    idx, sq = (a.numpy() for a in cuda_kernels.knn_slab(*_slab_args(case)))
    idx_j, sq_j = (np.asarray(a) for a in pallas_kernels.knn_slab_pallas(
        *(jnp.asarray(case[key]) for key in ("query", "qmask", "target", "tmask", "cidx")),
        case["k"], cand_tile=case["cand_tile"], interpret=True))
    np.testing.assert_allclose(sq, sq_j, rtol=1e-6)
    sure = np.ones(sq.shape, bool)
    if not case["exact_d2"]:
        # a tie between two copies of one point (a repeated point, the tile
        # listed twice, parked targets) is the same rounding in both
        parked = np.where(case["tmask"][:, None], case["target"],
                          np.float32(cuda_kernels.MASK_COORD))[idx]
        twins = (parked[:, 1:] == parked[:, :-1]).all(-1)
        clear = (np.diff(sq, axis=1) > 1e-6 * sq[:, 1:]) | twins
        sure[:, 1:] &= clear
        sure[:, :-1] &= clear
    sure &= case["qmask"][:, None]
    np.testing.assert_array_equal(idx[sure], idx_j[sure])
    assert sure[case["qmask"]].mean() > 0.9


def test_knn_slab_all_tiles_is_jax_exact_knn():
    """C = T (every 128-point tile a candidate) is the exact k-NN: the
    port's `knn_search` equals `knn_slab_plain` with cidx = arange(T) on
    the centered clouds, and matches JAX `knn_search(approx=False)` (an XLA
    top_k on |q|^2 - 2 q.t + |t|^2 distances, whose cancellation moves d^2
    by up to ~1.3e-5 here): sq within atol 1e-4, idx equal at every
    position not within 1e-4 of a neighbour in its row, ties included
    (both toward the lower target index), on at least 99% of positions."""
    pts, mask = _voxel_sorted_cloud(seed=5)
    n, k = pts.shape[0], 8
    idx_j, sq_j = jneighbors.knn_search(jnp.asarray(pts), jnp.asarray(pts),
                                        jnp.asarray(mask), k=k, approx=False)
    p, m = torch.as_tensor(pts), torch.as_tensor(mask)
    idx, sq = neighbors.knn_search(p, p, m, k, device="cpu")
    c = neighbors.masked_mean(p, m)
    T = n // 128
    cidx = torch.arange(T, dtype=torch.int32).expand(n // 256, T).contiguous()
    idx_s, sq_s = cuda_kernels.knn_slab_plain(p - c, torch.ones(n, dtype=torch.bool),
                                              p - c, m, cidx, k, cand_tile=128)
    np.testing.assert_array_equal(idx.numpy(), idx_s.numpy())
    np.testing.assert_array_equal(sq.numpy(), sq_s.numpy())
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_j), atol=1e-4)
    untied = _untied(sq.numpy(), 1e-4)
    np.testing.assert_array_equal(idx.numpy()[untied], np.asarray(idx_j)[untied])
    assert untied.mean() > 0.99
    assert mask[idx.numpy()].all()
    # a cloud that is not tile-aligned is padded inside; k > valid points
    # fills with masked targets in index order, as top_k does
    q = p[:300]
    idx, sq = neighbors.knn_search(q, p[:40], m[:40] & (torch.arange(40) < 30), 32,
                                   device="cpu")
    assert idx.shape == (300, 32)
    assert (sq[:, 30:] > 1e17).all() and (idx[:, 30:] == torch.arange(30, 32)).all()
    with pytest.raises(ValueError):
        neighbors.knn_search(q, p[:20], m[:20], 21, device="cpu")


def test_knn_search_culled_matches_jax(small_target):
    """On the small synthetic cloud (24 tiles of 256, 16 searched a query
    tile): the certificate equal to JAX's on every query whose k-th d^2 is
    not within 2e-3 of its bound, at least 90% of the valid queries
    certified; on the certified valid queries sq within atol 2e-3 of JAX's,
    and the neighbour set equal to JAX's wherever the k-th and (k+1)-th d^2
    are more than 5e-3 apart (at least 90% of them).  JAX's CPU path
    searches the same slabs but forms |q|^2 - 2 q.t + |t|^2, which at the
    cloud's ~50 m ranges moves d^2 by up to 9.6e-4, so nearer pairs may
    swap."""
    pts, mask = small_target
    k = 20
    idx_j, sq_j, cert_j = (np.asarray(a) for a in jneighbors.knn_search_culled(
        jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), k=k))
    idx, sq, cert = neighbors.knn_search_culled(pts, pts, mask, k, device="cpu")
    idx, sq, cert = idx.numpy(), sq.numpy(), cert.numpy()
    assert idx.shape == (pts.shape[0], k) and cert.dtype == bool
    # the bound the certificate compares with, per query
    qc, tc = jneighbors._center_clouds(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask))
    tt = jneighbors._masked_target(tc, jnp.asarray(mask))
    _c, excluded = jneighbors.select_candidate_tiles(qc.reshape(-1, 256, 3),
                                                     tt.reshape(-1, 256, 3), 16)
    bound = np.repeat(np.asarray(excluded), 256)
    clear = np.abs(sq[:, k - 1] - bound) > 2e-3
    np.testing.assert_array_equal(cert[clear], cert_j[clear])
    ok = cert & mask
    assert ok.sum() >= 0.9 * mask.sum()
    np.testing.assert_allclose(sq[ok], sq_j[ok], atol=2e-3)
    idx1, sq1, _cert = (a.numpy() for a in neighbors.knn_search_culled(
        pts, pts, mask, k + 1, device="cpu"))
    np.testing.assert_array_equal(idx1[:, :k], idx)
    set_untied = ok & (sq1[:, k] - sq1[:, k - 1] > 5e-3)
    assert set_untied.sum() >= 0.9 * ok.sum()
    np.testing.assert_array_equal(np.sort(idx[set_untied], axis=1),
                                  np.sort(idx_j[set_untied], axis=1))


def _test_covariances():
    """Random SPD covariances and degenerate ones: zero, isotropic, planar
    (rank 2), linear (rank 1) and near-planar, rotated."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(64, 3, 3))
    spd = A @ np.swapaxes(A, 1, 2) * rng.uniform(1e-3, 2.0, size=(64, 1, 1))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    degen = [np.zeros((3, 3)), 2.0 * np.eye(3)] + [
        R @ np.diag(d) @ R.T for d in ((1.0, 1.0, 0.0), (1.0, 0.0, 0.0), (1.0, 0.5, 1e-6),
                                       (0.04, 0.03, 2e-5))]
    return np.concatenate([spd, np.stack(degen)]).astype(np.float32)


@pytest.mark.parametrize("method", covariance.REGULARIZATION_METHODS)
def test_regularize_covariances_matches_jax(method):
    """Against the JAX package's regularize_covariances on (N, 3, 3) and,
    for every mode, its sym-6 path (`knn_covariance_cols`' regularization),
    within 1e-5 of each matrix's largest entry.  plane: against
    `soa.plane_covs_cols`, the form every JAX estimator uses (the (N, 3, 3)
    path takes another eigenvector formula, which picks another vector of
    a repeated smallest eigenspace: compared on the non-degenerate
    matrices only).  frobenius inverts C + 1e-3 I twice, which magnifies a
    last-bit difference (XLA on the CPU contracts the adjugate's
    multiply-adds) by its condition number kappa: there the tolerance is
    max(1e-5, 8 kappa eps) with eps = 2^-24 (measured: 5.8e-4 at kappa 4,100,
    6.7e-5 at kappa 342).  The sym-6 twin equals the (N, 3, 3) form."""
    covs = _test_covariances()
    got = covariance.regularize_covariances(torch.as_tensor(covs), method).numpy()
    cols = covariance.regularize_cov_cols(
        torch.as_tensor(np.asarray(jsoa.sym_cols_from_covs(jnp.asarray(covs)))), method)
    np.testing.assert_array_equal(
        np.asarray(jsoa.sym_cols_to_rows9(jnp.asarray(cols.numpy()))).reshape(-1, 3, 3), got)
    assert np.isfinite(got).all()
    scale = np.maximum(np.abs(got).max(axis=(1, 2), keepdims=True), 1e-30)
    if method == "plane":
        want = np.asarray(jsoa.sym_cols_to_rows9(jsoa.plane_covs_cols(
            jsoa.sym_cols_from_covs(jnp.asarray(covs))))).reshape(-1, 3, 3)
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)
        aos = np.asarray(jcov.regularize_covariances(jnp.asarray(covs), method))
        np.testing.assert_allclose(got[:64] / scale[:64], aos[:64] / scale[:64], atol=1e-4)
    else:
        want = np.asarray(jcov.regularize_covariances(jnp.asarray(covs), method))
        tol = np.full(len(covs), 1e-5)
        if method == "frobenius":
            w = np.linalg.eigvalsh(covs.astype(np.float64)) + 1e-3
            tol = np.maximum(tol, 8 * 2.0 ** -24 * np.abs(w).max(1) / np.abs(w).min(1))
        diff = np.abs(got - want).max(axis=(1, 2)) / scale[:, 0, 0]
        assert (diff <= tol).all(), (diff / tol).max()
    with pytest.raises(ValueError):
        covariance.regularize_covariances(torch.as_tensor(covs), "bogus")


@pytest.mark.parametrize("method,approx", [("min_eig", True), ("normalized_min_eig", True),
                                           ("frobenius", True), ("none", False),
                                           ("min_eig", False)])
def test_knn_covariance_cols_matches_jax_cpu(method, approx):
    """The estimator paths that reach the slab kernel against the JAX
    package's CPU `knn_covariance_cols` (the culled search with XLA's
    top-k for approx, the full top_k for approx=False) on a 2,048-point
    voxel-sorted cloud: every valid point within 1e-4 of each matrix's
    largest entry (measured: 6e-6, frobenius)."""
    pts, mask = _voxel_sorted_cloud()
    want = np.asarray(jcov.knn_covariance_cols(jnp.asarray(pts), jnp.asarray(mask),
                                               method=method, approx=approx))
    got = covariance.knn_covariance_cols(torch.as_tensor(pts), torch.as_tensor(mask),
                                         method=method, approx=approx).numpy()
    assert got.shape == (6, pts.shape[0]) and np.isfinite(got).all()
    scale = np.abs(want).max(0)
    diff = (np.abs(got - want).max(0) / scale)[mask]
    assert diff.max() <= 1e-4, diff.max()
    aos = covariance.knn_covariances(pts, mask, method=method, approx=approx, device="cpu")
    np.testing.assert_array_equal(aos.reshape(-1, 9)[:, [0, 1, 2, 4, 5, 8]].T.numpy(), got)


@pytest.mark.parametrize("method", ["min_eig", "normalized_min_eig", "frobenius"])
def test_rbf_covariance_cols_regularizations_match_jax_cpu(method):
    """The RBF estimator with the regularizations beyond plane and none,
    against the JAX package's CPU `rbf_covariance_cols` on a 2,048-point
    cloud: every valid point within 1e-3 of each matrix's largest entry
    (the JAX CPU path forms |q|^2 - 2 q.t + |t|^2 distances)."""
    pts, mask = _voxel_sorted_cloud(seed=8)
    want = np.asarray(jcov.rbf_covariance_cols(jnp.asarray(pts), jnp.asarray(mask),
                                               method=method))
    got = covariance.rbf_covariance_cols(torch.as_tensor(pts), torch.as_tensor(mask),
                                         method=method).numpy()
    scale = np.abs(want).max(0)
    diff = (np.abs(got - want).max(0) / scale)[mask]
    assert diff.max() <= 1e-3, diff.max()


def test_knn_slab_rejects_bad_inputs():
    p = torch.zeros((512, 3))
    m = torch.ones(512, dtype=torch.bool)
    cidx = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_kernels.knn_slab(p, m, p, m, cidx, 33)  # k > 32
    with pytest.raises(ValueError):
        cuda_kernels.knn_slab(p, m, p, m, cidx, 20, cand_tile=64)
    with pytest.raises(ValueError):
        cuda_kernels.knn_slab(p[:500], m[:500], p, m, cidx, 20)  # not tiled
    with pytest.raises(ValueError):
        cuda_kernels.knn_slab(p, m, p, m, cidx.long(), 20)
    with pytest.raises(ValueError):
        covariance.knn_covariance_cols(p, m, k=40, method="min_eig")
