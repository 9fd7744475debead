"""Port vs JAX: the adaptive-radius covariances and the slice end to end.
The plain versions of the `radius_count` and `radius_window` kernels
(fast_gicp_tpu_torch.ops.cuda_kernels) against the Pallas bodies behind
`radius_window_moments_T` (interpret mode) and a numpy emulation of the
counting rule; `adaptive_radius_covariance_cols` against the JAX
package's; and `gicp_register_fresh` with the adaptive estimator and with
the kNN estimator's MIN_EIG regularization against the JAX package's, on
the small synthetic LiDAR pair."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.models import gicp as jgicp
from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu.ops import pallas_kernels
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch.models import gicp
from fast_gicp_tpu_torch.ops import covariance, cuda_kernels
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic


def _cloud(case, n=2048):
    """2,048 voxel-sorted points, the last 90 masked: "room" fills a 10 m
    cube; "street" spreads over 120 m x 120 m x 4 m, where far points sit
    ~60 m from the cloud mean and the window moments cancel ~10^4-fold."""
    rng = np.random.default_rng(21)
    size = np.float32([10, 10, 10]) if case == "room" else np.float32([120, 120, 4])
    pts = (rng.random((n, 3)) * size).astype(np.float32)
    keys = np.floor(pts / 0.5).astype(np.int64)
    pts = pts[np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))]
    mask = np.ones(n, bool)
    mask[-90:] = False
    center = (pts[mask].astype(np.float64).mean(0)).astype(np.float32)
    return pts, mask, center


def _count_emulation(pts, mask, center, r2):
    """numpy emulation of the counting rule with every operation rounded on
    its own: centered clouds, masked targets parked at MASK_COORD,
    d^2 = ((dx^2 + dy^2) + dz^2), counts of d^2 <= r2[l]."""
    y = pts - center
    t = np.where(mask[:, None], y, np.float32(cuda_kernels.MASK_COORD))
    d = np.zeros((len(y), len(t)), np.float32)
    for a in range(3):
        dd = y[:, a:a + 1] - t[None, :, a]
        d = d + dd * dd
    return np.stack([(d <= r).sum(1) for r in r2]).astype(np.float32)


@pytest.mark.parametrize("case", ["room", "street"])
def test_radius_count_and_window_plain_match_pallas(case):
    """On the valid queries: counts equal to the numpy emulation exactly
    and to `radius_window_moments_T`'s count pass (interpret mode) on all
    but 0.1% of the (rung, query) entries (XLA on the CPU contracts d^2's
    multiply-adds, so a target on a rung boundary may fall on its other
    side); the window rows 1-12, from the same per-query radii, within 1e-5
    of each query's own largest entry in them (f32 sums in two orders, the
    raw rows before the finalize's cancellation; measured 3.7e-7)."""
    pts, mask, center = _cloud(case)
    r2 = covariance.default_radius_ladder()
    k = 20
    p, m, c = torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(center)
    cnt = cuda_kernels.radius_count(p, m, p, m, c, torch.as_tensor(r2))
    assert cnt.shape == (len(r2), len(pts)) and cnt.dtype == torch.float32
    np.testing.assert_array_equal(cnt.numpy()[:, mask],
                                  _count_emulation(pts, mask, center, r2)[:, mask])
    want = np.asarray(pallas_kernels.radius_window_moments_T(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(r2), k, jnp.asarray(center), interpret=True))
    got = covariance.radius_window_moments(p, m, p, m, torch.as_tensor(r2), k, c).numpy()
    assert got.shape == (16, len(pts))
    # the Pallas window count (row 0) is the count at each query's rung
    np.testing.assert_array_equal(got[0][mask] >= k, want[0][mask] >= k)
    np.testing.assert_array_equal(got[0][mask], want[0][mask])
    g, w = got[1:13, mask], want[1:13, mask]
    diff = np.abs(g - w) / (np.abs(w).max(0, keepdims=True) + 1e-30)
    assert diff.max() <= 1e-5, diff.max(1)
    np.testing.assert_array_equal(got[13:], 0.0)
    # rows 5 = 7, 6 = 10, 9 = 11: y_a y_b summed once
    np.testing.assert_array_equal(got[[5, 6, 9]], got[[7, 10, 11]])


def test_radius_rungs_against_pallas_counts():
    """The rung each valid query takes, from the port's counts and from
    the Pallas count kernel's (the same rule in both packages: the smallest
    rung holding >= k targets, else the last): equal on at least 99.9% of
    the queries (rung-boundary contractions, as above); and a query with
    fewer than k targets within the largest rung takes the last rung."""
    pts, mask, center = _cloud("street")
    r2 = covariance.default_radius_ladder()
    p, m, c = torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(center)
    got = covariance.radius_window_moments(p, m, p, m, torch.as_tensor(r2), 20, c)
    want = covariance.radius_window_moments(p, m, p, m, torch.as_tensor(r2), 10_000, c)
    cnt_last = cuda_kernels.radius_count(p, m, p, m, c, torch.as_tensor(r2[-1:]))[0]
    np.testing.assert_array_equal(want[0].numpy()[mask], cnt_last.numpy()[mask])
    jwant = np.asarray(pallas_kernels.radius_window_moments_T(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(r2), 20, jnp.asarray(center), interpret=True))
    assert np.mean(got[0].numpy()[mask] == jwant[0][mask]) >= 0.999


COUNT_CASES = {c["name"]: c for c in synthetic.radius_count_edge_cases()}


def _pallas_counts(pts, mask, center, r2):
    """(L, N) counts from the count pass of `radius_window_moments_T` as the
    JAX package runs it, `_count_kernel` in interpret mode behind its tile
    cull by the ladder's last rung, the cloud against itself."""
    f32 = jnp.float32
    m = jnp.asarray(mask)
    y = jnp.asarray(pts) - jnp.asarray(center)
    rq, rt = pallas_kernels._RQT, pallas_kernels._RTT
    gap = pallas_kernels._tile_gap_sq(y, m.astype(f32), y, m.astype(f32), rq, rt)
    pT = pallas_kernels._prep_transposed(y, m)
    n, L = len(pts), len(r2)
    return np.asarray(pl.pallas_call(
        pallas_kernels._count_kernel,
        grid=(n // rq, n // rt),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec((8, rq), lambda i, j: (0, i)),
                  pl.BlockSpec((8, rt), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((L, rq), lambda i, j: (0, i)),
        out_shape=jax.ShapeDtypeStruct((L, n), f32),
        interpret=True,
    )((gap <= r2[-1]).astype(jnp.int32), jnp.asarray(r2, f32), pT, pT))


@pytest.mark.parametrize("name", COUNT_CASES)
def test_radius_count_edge_cases_plain_matches_emulation(name):
    """Every edge case of `synthetic.radius_count_edge_cases` (pairs exactly
    on rungs, ladders ascending, non-ascending and with repeated rungs, L in
    {1, 20, 32}, masked points): the plain version's counts on the valid
    queries bit-equal to the numpy emulation, and the on-rung pairs counted
    (each rung holds a pair at exactly its d^2)."""
    case = COUNT_CASES[name]
    pts, mask, center, r2 = (case[key] for key in ("points", "mask", "center", "r2"))
    cnt = cuda_kernels.radius_count(*(torch.as_tensor(a) for a in (pts, mask, pts, mask,
                                                                   center, r2)))
    want = _count_emulation(pts, mask, center, r2)
    np.testing.assert_array_equal(cnt.numpy()[:, mask], want[:, mask])
    below = _count_emulation(pts, mask, center, np.nextafter(r2, np.float32(-1)))
    assert (want[:, mask] > below[:, mask]).any(axis=1).all()


@pytest.mark.parametrize("name", [n for n, c in COUNT_CASES.items() if c["ascending"]])
def test_radius_count_edge_cases_match_pallas(name):
    """The edge cases with a non-decreasing ladder (the JAX package culls
    by the last rung, so only there is its contract the same) against the
    Pallas count pass in interpret mode, on the valid queries: equal
    everywhere on the exact grid; on the street cloud equal on every (rung,
    query) entry with no target within 1e-6 of the rung in d^2 (XLA on the
    CPU contracts d^2's multiply-adds, so an on-rung pair may fall on either
    side there)."""
    case = COUNT_CASES[name]
    pts, mask, center, r2 = (case[key] for key in ("points", "mask", "center", "r2"))
    got = cuda_kernels.radius_count(*(torch.as_tensor(a) for a in (pts, mask, pts, mask,
                                                                   center, r2))).numpy()
    want = _pallas_counts(pts, mask, center, r2)
    sure = np.ones(got.shape, bool)
    if not case["exact_d2"]:
        lo = _count_emulation(pts, mask, center, r2 * np.float32(1 - 1e-6))
        hi = _count_emulation(pts, mask, center, r2 * np.float32(1 + 1e-6))
        sure = lo == hi
    sure &= mask[None, :]
    np.testing.assert_array_equal(got[sure], want[sure])
    assert sure.sum() >= 0.5 * mask.sum() * len(r2)


WINDOW_CASES = {c["name"]: c for c in synthetic.radius_window_edge_cases()}


def _window_d2(case):
    """(nq, nt) f32 d^2 of the centered clouds, masked points parked at
    MASK_COORD, every operation rounded on its own."""
    park = np.float32(cuda_kernels.MASK_COORD)
    yq = np.where(case["qmask"][:, None], case["query"] - case["center"], park)
    yt = np.where(case["tmask"][:, None], case["target"] - case["center"], park)
    return synthetic._sq_dist_f32(yq, yt)


def _window_numpy(case):
    """(16, nq) window rows in f64 over the targets with f32 d^2 <= r2q."""
    v = case["tmask"].astype(np.float64)
    y = (case["target"] - case["center"]).astype(np.float64) * v[:, None]
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    feats = np.stack([v, y0, y1, y2, y0 * y0, y0 * y1, y0 * y2, y1 * y0, y1 * y1, y1 * y2,
                      y2 * y0, y2 * y1, y2 * y2], 1)
    w = (_window_d2(case) <= case["r2q"][:, None]).astype(np.float64)
    return np.concatenate([(w @ feats).T, np.zeros((3, w.shape[0]))])


def _window_args(case):
    return [torch.as_tensor(case[key]) for key in ("query", "qmask", "target", "tmask",
                                                   "center", "r2q")]


@pytest.mark.parametrize("name", WINDOW_CASES)
def test_radius_window_plain_edge_cases_match_numpy(name):
    """Every edge case of `synthetic.radius_window_edge_cases` (r2q = 0,
    windows on pairs' d^2 among duplicates, the largest rung beside the
    smallest in every warp, masked points, nq and nt not multiples of 32,
    nt < 32): on the valid queries the plain version's count row equal to
    the numpy window's and rows 1-12 within 1e-5 of each query's largest
    |entry| of the f64 sums (WINDOW_REL_TOL of the card's check); rows
    13-15 zero.  The r2q = 0 case counts each query's exact duplicates."""
    case = WINDOW_CASES[name]
    got = cuda_kernels.radius_window(*_window_args(case)).numpy()
    want = _window_numpy(case)
    m = case["qmask"]
    np.testing.assert_array_equal(got[0, m], want[0, m])
    g, w = got[1:13, m], want[1:13, m]
    scale = np.abs(w).max(0, keepdims=True) + 1e-30
    assert (np.abs(g - w) <= 1e-5 * scale).all(), (np.abs(g - w) / scale).max(1)
    np.testing.assert_array_equal(got[13:], 0.0)
    if name == "r2q_zero_duplicates":
        dup = (case["query"][:, None, :] == case["target"][None]).all(-1) & case["tmask"]
        np.testing.assert_array_equal(got[0, m], dup.sum(1)[m])


@pytest.mark.parametrize("name", [n for n, c in WINDOW_CASES.items() if c["jax"]])
def test_radius_window_plain_edge_cases_match_pallas(name):
    """The edge cases of JAX's sizes against `_window_kernel` in interpret
    mode at the same per-query r2q, every tile pair visited (the cull only
    skips tiles with nothing in any window): on the valid queries the count
    row equal and rows 1-12 within 1e-5 of each query's largest |entry|.
    On the street cloud only the queries with no target within 1e-6 of the
    window in d^2 are held (XLA on the CPU contracts d^2's multiply-adds,
    so a pair on the window may fall on either side); at least half."""
    case = WINDOW_CASES[name]
    f32 = jnp.float32
    q, qm, t, tm, c = (jnp.asarray(case[key]) for key in ("query", "qmask", "target",
                                                          "tmask", "center"))
    yt = t - c
    tv = tm.astype(f32)
    y0, y1, y2 = (yt[:, a] * tv for a in range(3))
    zero = jnp.zeros_like(y0)
    feats = jnp.stack([tv, y0, y1, y2, y0 * y0, y0 * y1, y0 * y2, y1 * y0, y1 * y1,
                       y1 * y2, y2 * y0, y2 * y1, y2 * y2, zero, zero, zero])
    rq, rt = pallas_kernels._RQT, pallas_kernels._RTT
    nq, nt = q.shape[0], t.shape[0]
    want = np.asarray(pl.pallas_call(
        pallas_kernels._window_kernel,
        grid=(nq // rq, nt // rt),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec((1, rq), lambda i, j: (0, i)),
                  pl.BlockSpec((8, rq), lambda i, j: (0, i)),
                  pl.BlockSpec((8, rt), lambda i, j: (0, j)),
                  pl.BlockSpec((16, rt), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((16, rq), lambda i, j: (0, i)),
        out_shape=jax.ShapeDtypeStruct((16, nq), f32),
        interpret=True,
    )(jnp.ones((nq // rq, nt // rt), jnp.int32), jnp.asarray(case["r2q"])[None, :],
      pallas_kernels._prep_transposed(q - c, qm), pallas_kernels._prep_transposed(yt, tm),
      feats))
    got = cuda_kernels.radius_window(*_window_args(case)).numpy()
    sure = case["qmask"].copy()
    if not case["exact_d2"]:
        d, r2q = _window_d2(case), case["r2q"][:, None]
        sure &= ~(np.abs(d - r2q) <= 1e-6 * r2q).any(1)
        assert sure.sum() >= 0.5 * case["qmask"].sum()
    np.testing.assert_array_equal(got[0, sure], want[0, sure])
    g, w = got[1:13, sure], want[1:13, sure]
    scale = np.abs(w).max(0, keepdims=True) + 1e-30
    assert (np.abs(g - w) <= 1e-5 * scale).all(), (np.abs(g - w) / scale).max(1)


@pytest.mark.parametrize("method", ["plane", "none"])
def test_adaptive_radius_covariance_cols_matches_jax(method):
    """Against the JAX package's CPU `adaptive_radius_covariance_cols` (its
    XLA form of the same two passes) on the valid points of the "room"
    cloud: "none" within 1e-4 absolute everywhere (measured 1.1e-5);
    "plane" on at least 99% of the points within 1e-4, all within 1e-3 (a
    near-isotropic window's smallest eigenvector turns with the last digits
    of its moments).  The (N, 3, 3) form matches the columns."""
    pts, mask, _c = _cloud("room")
    want = np.asarray(jcov.adaptive_radius_covariance_cols(
        jnp.asarray(pts), jnp.asarray(mask), method=method))
    got = covariance.adaptive_radius_covariance_cols(torch.as_tensor(pts),
                                                     torch.as_tensor(mask), method=method)
    assert got.shape == (6, len(pts)) and torch.isfinite(got).all()
    diff = np.abs(got.numpy() - want).max(0)[mask]
    if method == "none":
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert np.mean(diff <= 1e-4) >= 0.99 and diff.max() <= 1e-3, np.sort(diff)[-5:]
    aos = covariance.adaptive_radius_covariances(pts, mask, method=method, device="cpu")
    np.testing.assert_array_equal(aos.reshape(-1, 9)[:, [0, 1, 2, 4, 5, 8]].T.numpy(),
                                  got.numpy())


@pytest.fixture(scope="module")
def pair():
    """Frames 30 (target) and 31 (source) of the synthetic drive (seed 0,
    a 400k-point world, 0.3 m downsample, padded to 6,144 points) and the
    ground-truth target<-source pose."""
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=400_000)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    sp, sm = padding.pad_points(downsample.voxel_downsample(scans[31], 0.3))
    tp, tm = padding.pad_points(downsample.voxel_downsample(scans[30], 0.3))
    return dict(args=(sp, sm, tp, tm), gt=np.linalg.inv(gt[30]) @ gt[31])


def _pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return np.linalg.norm(d[:3, 3]), np.degrees(np.arccos(cos))


@pytest.mark.parametrize("method,regularization", [("adaptive", "plane"),
                                                   ("knn", "min_eig")])
def test_gicp_register_fresh_matches_jax(pair, method, regularization):
    """The slice end to end on the small pair: `gicp_register_fresh` with
    adaptive-radius covariances (FastGICP's "adaptive" estimation) and with
    kNN covariances under MIN_EIG (the culled slab search), the port on the
    CPU against the JAX package's CPU path: pose within 1e-3, iterations
    within 1, both within 0.05 m / 1 deg of the ground truth."""
    eye = np.eye(4, dtype=np.float32)
    kw = dict(method=method, regularization=regularization)
    res, scov, tcov = gicp.gicp_register_fresh(*pair["args"], eye, device="cpu", **kw)
    jres = jgicp.gicp_register_fresh(*(jnp.asarray(a) for a in pair["args"]),
                                     jnp.asarray(eye), **kw)[0]
    got, want = convert.lsq_result_to_numpy(res), convert.lsq_result_to_numpy(jres)
    assert scov.shape == (6, pair["args"][0].shape[0]) and torch.isfinite(scov).all()
    assert got.converged
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-3)
    assert abs(got.iterations - want.iterations) <= 1
    for T in (got.transformation, want.transformation):
        t_err, r_err = _pose_errors(T, pair["gt"])
        assert t_err < 0.05 and r_err < 1.0, (t_err, r_err)


def test_radius_kernels_reject_bad_inputs():
    p = torch.zeros((256, 3))
    m = torch.ones(256, dtype=torch.bool)
    c = torch.zeros(3)
    with pytest.raises(ValueError):
        cuda_kernels.radius_count(p, m, p, m, c, torch.ones(33))  # > 32 rungs
    with pytest.raises(ValueError):
        cuda_kernels.radius_count(p, m, p, m, c, torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        cuda_kernels.radius_window(p, m, p, m, c, torch.ones(255))
    with pytest.raises(ValueError):
        cuda_kernels.radius_window(p, m, p, m, torch.zeros(2), torch.ones(256))
