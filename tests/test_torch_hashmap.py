"""Port vs JAX: the Gaussian voxel maps (`build_voxelmap`: the hash-table
`VoxelMap` and the sparse dense-grid `GridVoxelMap`, four accumulation
modes), their lookups, the VGICP objective, evaluation and Mahalanobis
surface on them, and `covariances_from_neighbors`, with device="cpu"
against the JAX package on the CPU.  The JAX objective runs its XLA path
there (`pallas_linearize.supported` is False off the TPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.models import vgicp as jvgicp
from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu.ops import linalg3 as jlinalg3
from fast_gicp_tpu.ops import voxelmap as jvox
from fast_gicp_tpu_torch import convert, se3
from fast_gicp_tpu_torch.models import vgicp
from fast_gicp_tpu_torch.ops import covariance, linalg3, soa, voxelmap
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic

RES = 1.0
MODES = voxelmap.ACCUMULATION_MODES
KINDS = ("hash", "grid")
DIMS = (32, 32, 32)


def _scene(seed=2, n=2048):
    """Clustered points about the origin (negative coordinates on every
    axis), SPD covariances and a mask with 10% of the points off."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-12.0, 12.0, (40, 3))
    pts = centers[rng.integers(0, 40, n)] + rng.normal(size=(n, 3)) * 0.6
    A = rng.normal(size=(n, 3, 3)) * 0.2
    covs = A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(3)
    mask = rng.uniform(size=n) > 0.1
    return pts.astype(np.float32), covs.astype(np.float32), mask


def _build(pts, covs, mask, mode, kind, **kw):
    dims = DIMS if kind == "grid" else None
    jmap = jvox.build_voxelmap(jnp.asarray(pts), jnp.asarray(mask), RES,
                               covs=jnp.asarray(covs), mode=mode, grid_dims=dims, **kw)
    tmap = voxelmap.build_voxelmap(torch.as_tensor(pts), torch.as_tensor(mask), RES,
                                   covs=torch.as_tensor(covs), mode=mode, grid_dims=dims,
                                   device="cpu", **kw)
    return jmap, tmap


def _close_per_row(got, want, tol=1e-5):
    """Each entry within `tol` of its row's scale (the largest |entry| of
    that voxel's field), so near-zero off-diagonals are held to the
    voxel's own magnitude."""
    got = np.asarray(got).reshape(len(got), -1)
    want = np.asarray(want).reshape(len(want), -1)
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    bad = np.abs(got - want) > tol * scale
    assert not bad.any(), f"{bad.sum()} entries off, max rel {(np.abs(got - want) / scale).max()}"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_build_voxelmap_matches_jax(mode, kind):
    """Integer fields (counts, coords, num_voxels, and the table and lut or
    the grid and origin) exactly equal; the finalized statistics per entry
    within 1e-5 of the voxel's scale.  The stable three-key sort gives the
    voxels JAX's lexicographic ids, so the scatter-min claiming rounds fill
    the same table."""
    pts, covs, mask = _scene()
    jmap, tmap = _build(pts, covs, mask, mode, kind)
    ints = ("counts", "coords", "num_voxels") + (
        ("table", "lut") if kind == "hash" else ("grid", "origin"))
    for f in ints:
        got, want = getattr(tmap, f).numpy(), np.asarray(getattr(jmap, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("means", "covs", "packed"):
        _close_per_row(getattr(tmap, f).numpy(), getattr(jmap, f))
    assert tmap.packed.is_contiguous() and tmap.resolution == RES
    assert int(tmap.num_voxels) > 100 and int(tmap.counts.sum()) == mask.sum()


def test_build_voxelmap_sym6_covs_and_small_capacity():
    """(6, N) sym-6 covariances build the same map as (N, 3, 3); a capacity
    below the voxel count drops the highest ids as JAX does."""
    pts, covs, mask = _scene(seed=5)
    a = voxelmap.build_voxelmap(torch.as_tensor(pts), torch.as_tensor(mask), RES,
                                covs=torch.as_tensor(covs), device="cpu")
    b = voxelmap.build_voxelmap(torch.as_tensor(pts), torch.as_tensor(mask), RES,
                                covs=soa.sym_cols_from_covs(torch.as_tensor(covs)),
                                device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b) if isinstance(x, torch.Tensor))
    jmap, tmap = _build(pts, covs, mask, "additive", "hash", capacity=64)
    for f in ("counts", "coords", "num_voxels", "table", "lut"):
        np.testing.assert_array_equal(getattr(tmap, f).numpy(), np.asarray(getattr(jmap, f)))
    _close_per_row(tmap.packed.numpy(), jmap.packed)
    assert int(tmap.num_voxels) > 64


def _colliding_coords(table_size, per_slot=4, seed=0):
    """Integer coords (with negative components) whose hashes share one
    starting slot of a table of `table_size`, and more that share another:
    the probe chains run past their first slot."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-40, 40, (20000, 3)).astype(np.int32)
    c = np.unique(c, axis=0)
    h = np.asarray(jvox._hash_coords(jnp.asarray(c))) & (table_size - 1)
    slots, counts = np.unique(h, return_counts=True)
    full = slots[counts >= per_slot][:2]
    return [c[h == s][:per_slot] for s in full]


def test_hash_coords_match_jax_on_negative_coordinates():
    rng = np.random.default_rng(1)
    c = rng.integers(-2**30, 2**30, (4096, 3)).astype(np.int32)
    c[:3] = [[-1, -1, -1], [-2**30, 2**30 - 1, 0], [0, 0, 0]]
    want = np.asarray(jvox._hash_coords(jnp.asarray(c))).astype(np.int64)
    t = torch.as_tensor(c)
    got = voxelmap._hash_coords(t[:, 0], t[:, 1], t[:, 2]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_lookups_match_jax(kind):
    """`lookup_voxels` and `lookup_voxels_cols` give JAX's ids on present
    voxels, absent coords next to them, coords far away (out of the grid),
    negative coordinates and, for the hash map, voxels and absent coords
    whose probe chains collide (built in, so the chains run several
    slots); all probe rounds run, so the ids are JAX's early-exit ids."""
    pts, covs, mask = _scene(seed=3)
    n = pts.shape[0]
    cap = n
    table_size = voxelmap.next_pow2(8 * cap)
    groups = _colliding_coords(table_size)
    if kind == "hash":
        # two voxels of each colliding group get points; the others stay
        # absent but hash to the same slot
        extra = np.concatenate([(g[:2].astype(np.float32) + 1.0) for g in groups])
        pts = np.concatenate([pts[: n - len(extra)], extra]).astype(np.float32)
        mask[n - len(extra):] = True
    jmap, tmap = _build(pts, covs, mask, "additive", kind)
    occupied = np.asarray(jmap.coords)[np.asarray(jmap.counts) > 0]
    rng = np.random.default_rng(7)
    q = np.concatenate([
        occupied,
        occupied + rng.integers(-2, 3, occupied.shape),
        rng.integers(-60, 60, (2000, 3)),
        np.concatenate(groups),
        np.array([[-1, -1, -1], [-40, -40, -40], [1000, 0, 0]]),
    ]).astype(np.int32)
    want = np.asarray(jvox.lookup_voxels(jmap, jnp.asarray(q)))
    got = voxelmap.lookup_voxels(tmap, torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(got, want)
    tq = torch.as_tensor(q)
    cols = voxelmap.lookup_voxels_cols(tmap, tq[:, 0], tq[:, 1], tq[:, 2]).numpy()
    np.testing.assert_array_equal(cols, want)
    assert (want >= 0).sum() >= len(occupied) and (want == -1).sum() > 500
    if kind == "hash":
        hits = want[-3 - sum(len(g) for g in groups):-3]
        assert (hits >= 0).sum() == 2 * len(groups) and (hits == -1).sum() >= 2
    means, cov33, cnt = voxelmap.gather_voxel_stats(tmap, torch.as_tensor(np.maximum(want, 0)))
    jm, jc, jn = jvox.gather_voxel_stats(jmap, jnp.asarray(np.maximum(want, 0)))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jn))
    _close_per_row(means.numpy(), jm)
    _close_per_row(cov33.numpy(), jc)


def test_voxel_coord_on_faces_at_0_3_m():
    """On the float32 coordinates next to 0.3 m voxel faces where the true
    division and the product with f32(1 / 0.3) bin differently
    (`synthetic._split_faces`), voxel_coord takes the division's side, as
    JAX does."""
    q = synthetic._split_faces(0.3, -60, 60)
    assert q.size > 20
    p = np.stack([q, -q, q], axis=1).astype(np.float32)
    want = np.asarray(jvox.voxel_coord(jnp.asarray(p), 0.3))
    np.testing.assert_array_equal(voxelmap.voxel_coord(torch.as_tensor(p), 0.3).numpy(), want)
    true_div = np.floor(p / np.float32(0.3) - np.float32(0.5)).astype(np.int32)
    prod = np.floor(p * np.float32(1 / 0.3) - np.float32(0.5)).astype(np.int32)
    np.testing.assert_array_equal(want, true_div)
    assert (prod != true_div).any()


def test_inv3_eps_matches_jax_and_keeps_the_unguarded_bits():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(512, 3, 3)).astype(np.float32)
    A[:8] = 0.0
    A[8:16, 2] = A[8:16, 1]  # singular
    t = torch.as_tensor(A)
    for eps in (1e-30, 1e-3):
        np.testing.assert_allclose(linalg3.inv3(t, eps=eps).numpy(),
                                   np.asarray(jlinalg3.inv3(jnp.asarray(A), eps=eps)),
                                   rtol=1e-5, atol=0)
    ok = A[16:]
    assert torch.equal(linalg3.inv3(t[16:]), linalg3.inv3(t[16:], eps=0.0))
    np.testing.assert_allclose(linalg3.inv3(t[16:]).numpy(),
                               np.asarray(jlinalg3.inv3(jnp.asarray(ok))), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    """The small synthetic pair (frames 30/31, seed 0, 0.3 m downsample,
    6,144 padded points each), centred on the target's centroid as the
    aligns centre it, with RBF covariances from JAX."""
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=400_000)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    sp, sm = padding.pad_points(downsample.voxel_downsample(scans[31], 0.3))
    tp, tm = padding.pad_points(downsample.voxel_downsample(scans[30], 0.3))
    c = tp[tm].mean(0).astype(np.float32)
    sp, tp = sp - c, tp - c
    scov = np.asarray(jcov.rbf_covariances(jnp.asarray(sp), jnp.asarray(sm)))
    tcov = np.asarray(jcov.rbf_covariances(jnp.asarray(tp), jnp.asarray(tm)))
    return dict(sp=sp, sm=sm, tp=tp, tm=tm, scov=scov, tcov=tcov, c=c,
                gt=np.linalg.inv(gt[30]) @ gt[31])


@pytest.mark.parametrize("method", covariance.REGULARIZATION_METHODS)
def test_covariances_from_neighbors_matches_jax(pair, method):
    """Host-supplied kNN lists (the kd-tree path: the port's
    `native.knn_search`, here its numpy fallback) on the small pair's
    target.  The neighbourhood moments ("none") within 1e-5 of each
    matrix's largest entry of JAX's; each mode is exactly the port's
    `regularize_covariances` of them (held to JAX's by
    tests/test_torch_knn_slab.py), and against JAX: plane within 1e-5 of
    JAX's sym-6 plane form where the smallest eigenvalue is apart from the
    next by > 5% of the largest (at a near-repeated smallest eigenvalue the
    plane's normal is ill-determined: a last-bit difference in the moments
    turns it), min_eig and normalized_min_eig within
    1e-4 (measured 2.2e-5: eigenvectors of near-repeated eigenvalues),
    frobenius within max(1e-5, 8 kappa eps) (its double inverse)."""
    from fast_gicp_tpu.ops import soa as jsoa
    from fast_gicp_tpu_torch import native

    pts = pair["tp"][pair["tm"]][:2048]
    idx, _sq = native.knn_search(pts, pts, 20)
    raw = covariance.covariances_from_neighbors(torch.as_tensor(pts), idx, "none")
    got = covariance.covariances_from_neighbors(torch.as_tensor(pts), idx, method)
    assert got.shape == (len(pts), 3, 3)
    assert torch.equal(got, covariance.regularize_covariances(raw, method))
    jraw = jcov.covariances_from_neighbors(jnp.asarray(pts), jnp.asarray(idx), method="none")
    _close_per_row(raw.numpy(), jraw)
    if method == "plane":
        want = np.asarray(jsoa.sym_cols_to_rows9(jsoa.plane_covs_cols(
            jsoa.sym_cols_from_covs(jraw)))).reshape(-1, 3, 3)
        w = np.linalg.eigvalsh(np.asarray(jraw, np.float64))
        apart = (w[:, 1] - w[:, 0]) > 0.05 * w[:, 2]
        assert apart.mean() > 0.9
        _close_per_row(got.numpy()[apart], want[apart])
        return
    want = np.asarray(jcov.covariances_from_neighbors(jnp.asarray(pts), jnp.asarray(idx),
                                                      method=method))
    if method != "frobenius":
        _close_per_row(got.numpy(), want, 1e-5 if method == "none" else 1e-4)
        return
    w = np.linalg.eigvalsh(np.asarray(jraw, np.float64)) + 1e-3
    tol = np.maximum(1e-5, 8 * 2.0 ** -24 * np.abs(w).max(1) / np.abs(w).min(1))
    scale = np.abs(want).max(axis=(1, 2))
    assert (np.abs(got.numpy() - want).max(axis=(1, 2)) <= tol * scale).all()


OBJECTIVES = [("hash", "additive", "direct1"), ("hash", "multiplicative", "direct7"),
              ("grid", "multiplicative", "direct7"), ("grid", "raw", "direct27"),
              ("hash", "additive_weighted", "direct_radius")]


@pytest.mark.parametrize("kind,mode,search", OBJECTIVES)
def test_vgicp_objective_matches_jax(pair, kind, mode, search):
    """make_vgicp_objective on the hash and grid maps: err, H and b within
    1e-4 (relative; H and b to their largest entry) of JAX's XLA path at a
    perturbed pose, on the map JAX built (through `convert`) and on the
    port's own; the frozen ids and validity equal JAX's lookup; the trial
    error at the linearization pose equals err."""
    dims = voxelmap.auto_grid_dims(pair["tp"][pair["tm"]], RES) if kind == "grid" else None
    jcfg = jvgicp.VGICPConfig(grid_dims=dims, voxel_accumulation=mode,
                              neighbor_search_method=search)
    cfg = convert.config_from_jax(jcfg)
    jmap = jvox.build_voxelmap(jnp.asarray(pair["tp"]), jnp.asarray(pair["tm"]), RES,
                               covs=jnp.asarray(pair["tcov"]), mode=mode, grid_dims=dims)
    offs = voxelmap.neighbor_offsets(search)
    jlin, _jerr = jvgicp.make_vgicp_objective(
        jnp.asarray(pair["sp"]), jnp.asarray(pair["sm"]), jnp.asarray(pair["scov"]), jmap,
        jnp.asarray(offs), jcfg)
    x = se3.se3_exp(torch.tensor([0.01, -0.005, 0.02, 0.1, -0.05, 0.02]))
    e_j, H_j, b_j, _aux = (np.asarray(v) if not isinstance(v, tuple) else v
                           for v in jlin(jnp.asarray(x.numpy())))
    to_port = (convert.voxel_map_from_numpy if kind == "hash"
               else convert.grid_voxel_map_from_numpy)
    own = voxelmap.build_voxelmap(torch.as_tensor(pair["tp"]), torch.as_tensor(pair["tm"]),
                                  RES, covs=torch.as_tensor(pair["tcov"]), mode=mode,
                                  grid_dims=dims, device="cpu")
    for tmap in (to_port(jmap, device="cpu"), own):
        lin, err_fn, freeze, _lf = vgicp.make_vgicp_objective(
            torch.as_tensor(pair["sp"]), torch.as_tensor(pair["sm"]),
            torch.as_tensor(pair["scov"]), tmap, offs, cfg)
        e, H, b, aux = lin(x)
        np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)
        np.testing.assert_allclose(H.numpy(), H_j, atol=1e-4 * np.abs(H_j).max())
        np.testing.assert_allclose(b.numpy(), b_j, atol=1e-4 * np.abs(b_j).max())
        np.testing.assert_allclose(float(err_fn(x, aux)), float(e), rtol=1e-5)
        ids, valid = freeze(x)
        assert ids.dtype == torch.int32 and ids.shape == (len(offs) * len(pair["sp"]),)
        q = vgicp._query_cols(torch.as_tensor(pair["sp"]).T, x, RES, offs)
        want_vids = np.asarray(jvox.lookup_voxels_cols(
            jmap, *(jnp.asarray(c.numpy()) for c in q))).reshape(-1)
        np.testing.assert_array_equal(ids.numpy(), np.maximum(want_vids, 0))
        want_valid = (want_vids >= 0) & np.tile(pair["sm"], len(offs))
        np.testing.assert_array_equal(valid.numpy(), want_valid.astype(np.float32))
        assert 0 < want_valid.sum() < want_valid.size


@pytest.mark.parametrize("kind,mode", [("hash", "additive"), ("grid", "multiplicative")])
def test_vgicp_evaluate_matches_jax(pair, kind, mode):
    """vgicp_evaluate (target-centroid frame, world-frame H and b) within
    1e-4 of JAX's."""
    dims = voxelmap.auto_grid_dims(pair["tp"][pair["tm"]], RES) if kind == "grid" else None
    jcfg = jvgicp.VGICPConfig(grid_dims=dims, voxel_accumulation=mode,
                              neighbor_search_method="direct7")
    args = [pair[k] for k in ("sp", "sm", "scov", "tp", "tm", "tcov")]
    pose = se3.se3_exp(torch.tensor([0.005, 0.01, -0.01, 0.05, 0.02, -0.03])).numpy()
    je, jH, jb = (np.asarray(v) for v in jvgicp.vgicp_evaluate(
        *(jnp.asarray(a) for a in args), jnp.asarray(pose), jcfg))
    e, H, b = vgicp.vgicp_evaluate(*args, pose, convert.config_from_jax(jcfg), device="cpu")
    np.testing.assert_allclose(float(e), float(je), rtol=1e-4)
    np.testing.assert_allclose(H.numpy(), jH, atol=1e-4 * np.abs(jH).max())
    np.testing.assert_allclose(b.numpy(), jb, atol=1e-4 * np.abs(jb).max())


@pytest.mark.parametrize("kind,mode", [("hash", "additive"), ("grid", "multiplicative")])
def test_vgicp_mahalanobis_matches_jax(kind, mode):
    """vgicp_mahalanobis on `_scene` (well-conditioned covariances; the
    source is the target jittered): the same validity, M within
    max(1e-5, 8 kappa eps) of each matrix's largest entry, kappa the
    condition number of the matrix it inverts (on the synthetic LiDAR
    pair's plane covariances, kappa ~1e3, a multiplicative voxel's chain of
    inverses grows last-bit differences far beyond kappa eps)."""
    tp, tcov, tm = _scene()
    rng = np.random.default_rng(8)
    sp = (tp + rng.normal(size=tp.shape) * 0.3).astype(np.float32)
    sm = rng.uniform(size=len(sp)) > 0.2
    jcfg = jvgicp.VGICPConfig(grid_dims=DIMS if kind == "grid" else None,
                              voxel_accumulation=mode, neighbor_search_method="direct7")
    args = [sp, sm, tcov, tp, tm, tcov]
    pose = se3.se3_exp(torch.tensor([0.005, 0.01, -0.01, 0.05, 0.02, -0.03])).numpy()
    jM, jv = (np.asarray(v) for v in jvgicp.vgicp_mahalanobis(
        *(jnp.asarray(a) for a in args), jnp.asarray(pose), jcfg))
    M, valid = vgicp.vgicp_mahalanobis(*args, pose, convert.config_from_jax(jcfg),
                                       device="cpu")
    assert M.shape == jM.shape == (7, 6, len(sp))
    np.testing.assert_array_equal(valid.numpy(), jv)
    assert jv.any() and not jv.all()
    v = jv.reshape(-1)
    got = M.numpy().transpose(0, 2, 1).reshape(-1, 6)
    want = jM.transpose(0, 2, 1).reshape(-1, 6)
    assert not got[~v].any()
    w = np.linalg.eigvalsh(want[v][:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(-1, 3, 3)
                           .astype(np.float64))
    tol = np.maximum(1e-5, 8 * 2.0 ** -24 * np.abs(w).max(1) / np.abs(w).min(1))
    scale = np.abs(want[v]).max(1)
    assert (np.abs(got[v] - want[v]).max(1) <= tol * scale).all()


def test_vgicp_align_multires_matches_jax(pair):
    """Coarse-to-fine on the hash map from a guess 0.6 m and 2 deg off:
    each level starts from the last's pose; the final pose within 1e-3 of
    JAX's and both within 0.05 m of the ground truth, restated for the
    pair's centring on the target's centroid c (x - c on both sides)."""
    jcfg = jvgicp.VGICPConfig()
    args = [pair[k] for k in ("sp", "sm", "scov", "tp", "tm", "tcov")]
    gt = pair["gt"].copy()
    gt[:3, 3] += gt[:3, :3] @ pair["c"] - pair["c"]
    off = se3.se3_exp(torch.tensor([0.0, 0.0, 0.035, 0.6, -0.3, 0.0])).numpy()
    guess = (off @ gt).astype(np.float32)
    jres = jvgicp.vgicp_align_multires(*(jnp.asarray(a) for a in args), jnp.asarray(guess),
                                       resolutions=(3.0, 1.0), config=jcfg)
    res = vgicp.vgicp_align_multires(*args, guess, resolutions=(3.0, 1.0),
                                     config=convert.config_from_jax(jcfg), device="cpu")
    got, want = convert.lsq_result_to_numpy(res), convert.lsq_result_to_numpy(jres)
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-3)
    assert abs(got.iterations - want.iterations) <= 1
    for T in (got.transformation, want.transformation):
        assert np.linalg.norm((np.linalg.inv(gt) @ T)[:3, 3]) < 0.05
