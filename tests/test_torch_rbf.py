"""Port vs JAX: the RBF moment kernel's plain version and the RBF
covariances (fast_gicp_tpu_torch.ops.cuda_kernels / ops.covariance against
fast_gicp_tpu.ops.pallas_kernels / ops.covariance).

The JAX side of the moment test is the Pallas kernel body itself, run in
interpret mode; the cases follow tests/test_pallas_linearize.py (plain,
80 m offset, +-60 m extent).  The Pallas kernel accumulates bf16 hi/lo
features and the plain version f32, so the f64 dense reference is the
arbiter: the plain version is held to it elementwise in every case, and to
the Pallas kernel elementwise where the kernel itself meets that tolerance
against f64 (the plain case, as test_pallas_linearize.py checks it).  The
adversarial inputs of `utils.synthetic.rbf_moments_edge_cases` hold the
plain version to f64 and to the Pallas kernel's own bf16 contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu.ops import pallas_kernels
from fast_gicp_tpu_torch.ops import covariance, cuda_kernels
from fast_gicp_tpu_torch.utils import synthetic

N = 2048
KW, MD = 0.5, 3.0
# (rows, atol) of the moment comparison; rtol 5e-3 on all of them
MOMENT_TOLS = ((slice(0, 1), 1e-4), (slice(1, 4), 2e-2), (slice(4, 13), 5e-2))


def _cloud(case):
    rng = np.random.default_rng(5)
    if case == "plain":
        x = rng.normal(size=(N, 3)) * 2.0
    elif case == "offset80":
        x = rng.normal(size=(N, 3)) + np.float32([80.0, -55.0, 20.0])
    else:  # LiDAR-scale internal extent, +-60 m clusters
        centers = rng.uniform(-60, 60, (64, 3))
        centers[:, 2] *= 0.05
        x = centers[rng.integers(0, 64, N)] + rng.normal(size=(N, 3))
    mask = rng.uniform(size=N) > 0.1
    return x.astype(np.float32), mask


def _center(x, mask):
    return ((x * mask[:, None]).sum(0) / mask.sum()).astype(np.float32)


def _f64_moments(x, mask, center):
    """Dense f64 reference of the centered moments, as (16, N) rows."""
    y = np.asarray(x, np.float64) - np.asarray(center, np.float64)
    d = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    w = np.where((d <= MD**2) & mask[None, :], np.exp(-KW * d), 0.0)
    wyy = np.einsum("qt,ti,tj->qij", w, y, y).reshape(-1, 9)
    return np.concatenate([w.sum(1)[None], (w @ y).T, wyy.T, np.zeros((3, N))])


def _covs(m):
    """(N, 3, 3) covariances from (16, N) moment rows."""
    sw = np.maximum(m[0], 1e-9)
    mean = m[1:4].T / sw[:, None]
    return m[4:13].T.reshape(-1, 3, 3) / sw[:, None, None] - np.einsum(
        "ni,nj->nij", mean, mean)


def _plain(x, mask, center):
    t = torch.as_tensor(x)
    m = torch.as_tensor(mask)
    return cuda_kernels.rbf_moments_plain(
        t, m, t, m, torch.as_tensor(center), KW, MD).numpy()


@pytest.mark.parametrize("case", ["plain", "offset80", "extent60"])
def test_rbf_moments_plain_matches_pallas_and_f64(case):
    """Moment rows: rtol 5e-3 with atol 1e-4 / 2e-2 / 5e-2 on the sum w,
    sum w y and sum w yy rows, against f64 in every case and against the
    Pallas kernel in the plain case; rows of masked queries carry no
    meaning and are skipped.  Covariances from both the plain and the
    Pallas moments stay within 5% of the f64 reference's scale."""
    x, mask = _cloud(case)
    center = _center(x, mask)
    got = _plain(x, mask, center)
    want = np.asarray(pallas_kernels.rbf_cross_moments_centered_T(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(x), jnp.asarray(mask),
        KW, MD, jnp.asarray(center), interpret=True))
    ref = _f64_moments(x, mask, center)
    assert got.dtype == np.float32
    for rows, atol in MOMENT_TOLS:
        np.testing.assert_allclose(got[rows][:, mask], ref[rows][:, mask],
                                   rtol=5e-3, atol=atol)
        if case == "plain":
            np.testing.assert_allclose(got[rows][:, mask], want[rows][:, mask],
                                       rtol=5e-3, atol=atol)
    np.testing.assert_array_equal(got[13:], 0.0)

    live = mask & (ref[0] > 1.0)
    c_ref = _covs(ref)[live]
    scale = max(np.abs(np.trace(c_ref, axis1=1, axis2=2) / 3).mean(), 1.0)
    for m in (got, want):
        assert np.abs(_covs(m)[live] - c_ref).max() < 0.05 * scale


@pytest.mark.parametrize("case", ["plain", "offset80"])
@pytest.mark.parametrize("method", ["plane", "none"])
def test_rbf_covariances_match_jax(case, method):
    """(N, 3, 3) covariances against the JAX package's: all finite, and
    max |diff| <= 1e-3 on at least 99.5% of the valid points -- a
    near-isotropic neighbourhood has an ill-defined smallest eigenvector,
    so its plane-regularized covariance may flip between the two
    summation orders.  (The +-60 m extent case is held against f64 below:
    the JAX package's CPU fallback forms d^2 as |q|^2 - 2 q.t + |t|^2,
    which loses the digits this tolerance needs at that extent.)"""
    x, mask = _cloud(case)
    got = covariance.rbf_covariances(x, mask, KW, MD, method=method,
                                     device="cpu").numpy()
    want = np.asarray(jcov.rbf_covariances(jnp.asarray(x), jnp.asarray(mask),
                                           KW, MD, method=method))
    assert got.shape == (N, 3, 3) and np.isfinite(got).all()
    diff = np.abs(got - want).reshape(N, 9).max(1)[mask]
    assert np.mean(diff <= 1e-3) >= 0.995, np.sort(diff)[-10:]


def test_rbf_covariances_wide_extent_match_f64():
    """At +-60 m extent the unregularized covariances stay within 5e-3 m^2
    of the f64 reference on every point with a real neighbourhood.  The
    moments are f32 about the cloud mean, so E[y y^T] - mu mu^T cancels
    terms of up to |y|^2 ~ 3600 m^2: f32 rounding there is ~2e-4 m^2 per
    moment, about 2e-3 m^2 after the finalize."""
    x, mask = _cloud("extent60")
    got = covariance.rbf_covariances(x, mask, KW, MD, method="none",
                                     device="cpu").numpy()
    ref = _f64_moments(x, mask, _center(x, mask))
    live = mask & (ref[0] > 1.0)
    assert np.isfinite(got).all()
    assert np.abs(got - _covs(ref))[live].max() <= 5e-3


RBF_EDGE_CASES = synthetic.rbf_moments_edge_cases()


def _edge_args(case):
    return (*(torch.as_tensor(case[k]) for k in ("query", "qmask", "target", "tmask", "center")),
            case["kernel_width"], case["max_dist"])


def _edge_numpy(case):
    """(16, Nq) f64 moments with the range test on f32 d^2 rounded in the
    kernels' order, and sum |w f| of each entry (the scale of its terms)."""
    yq = (case["query"] - case["center"]).astype(np.float32)
    yt = (case["target"] - case["center"]).astype(np.float32)
    d = synthetic._sq_dist_f32(yq, yt)
    md2 = np.float32(case["max_dist"] * case["max_dist"])
    w = np.where((d <= md2) & case["tmask"][None, :],
                 np.exp(-case["kernel_width"] * d.astype(np.float64)), 0.0)
    y = yt.astype(np.float64)
    f = np.concatenate([np.ones((len(y), 1)), y, (y[:, :, None] * y[:, None, :]).reshape(-1, 9),
                        np.zeros((len(y), 3))], axis=1)
    return (w @ f).T, (w @ np.abs(f)).T


@pytest.mark.parametrize("case", RBF_EDGE_CASES, ids=[c["name"] for c in RBF_EDGE_CASES])
def test_rbf_moments_plain_edge_cases_match_f64(case):
    """The plain version (the card's reference) on the adversarial inputs of
    `rbf_moments_edge_cases` (pairs exactly on the radius, masked targets
    in range, nq != nt, nt < 128, a block with nothing in range, kernel
    width 0) against f64 moments that take the same f32 range decisions:
    rtol 5e-3 with atol 1e-4 / 2e-2 / 5e-2 on the valid queries."""
    got = cuda_kernels.rbf_moments(*_edge_args(case)).numpy()
    ref, _scale = _edge_numpy(case)
    v = case["qmask"]
    for rows, atol in MOMENT_TOLS:
        np.testing.assert_allclose(got[rows][:, v], ref[rows][:, v], rtol=5e-3, atol=atol)
    np.testing.assert_array_equal(got[13:], 0.0)
    if case["name"] == "block_nothing_in_range":
        np.testing.assert_array_equal(got[:, :128], 0.0)


JAX_RBF_CASES = [c for c in RBF_EDGE_CASES if c["jax"]]


@pytest.mark.parametrize("case", JAX_RBF_CASES, ids=[c["name"] for c in JAX_RBF_CASES])
def test_rbf_moments_plain_edge_cases_match_pallas(case):
    """Against `rbf_cross_moments_centered_T` (interpret mode) on the edge
    cases whose sizes it takes.  The Pallas kernel rounds each weight to
    bf16 for its matmul (half an ulp is 2^-8 of it), so its contract is
    looser than the plain version's f32: each entry is held within 2^-7 of
    the sum of its terms' magnitudes, sum |w f| (one bf16 ulp, leaving room
    for the f32 accumulation), on the valid queries."""
    want = np.asarray(pallas_kernels.rbf_cross_moments_centered_T(
        jnp.asarray(case["query"]), jnp.asarray(case["qmask"]), jnp.asarray(case["target"]),
        jnp.asarray(case["tmask"]), case["kernel_width"], case["max_dist"],
        jnp.asarray(case["center"]), interpret=True))
    got = cuda_kernels.rbf_moments(*_edge_args(case)).numpy()
    _ref, scale = _edge_numpy(case)
    v = case["qmask"]
    assert (np.abs(got - want)[:, v] <= 2.0 ** -7 * scale[:, v] + 1e-6).all()
