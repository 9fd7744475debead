"""Port vs JAX: the plain versions of the linearize (raw and finalized
rows) and error kernels (fast_gicp_tpu_torch.ops.cuda_linearize) against
the Pallas kernel bodies `linearize_raw_pallas` / `linearize_pallas` /
`error_pallas`, run in interpret mode.

Inputs in the style of tests/test_pallas_linearize.py: random SPD source
and voxel covariances, raw voxel rows [count, sum mu, sum cov, pad] with
some empty (count 0) rows, and 25% of the source masked."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu import se3 as jse3
from fast_gicp_tpu.ops import pallas_linearize
from fast_gicp_tpu_torch.ops import cuda_linearize

N = 2048


def _inputs(seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(N, 3)) * 5
    q = rng.normal(size=(N, 3)) * 5
    A = rng.normal(size=(N, 3, 3))
    covs_a = A @ np.swapaxes(A, 1, 2) + 0.3 * np.eye(3)
    B = rng.normal(size=(N, 3, 3))
    covs_b = B @ np.swapaxes(B, 1, 2) + 0.3 * np.eye(3)
    counts = rng.integers(0, 20, N).astype(np.float64)  # 0: a miss
    valid = (rng.uniform(size=N) > 0.25).astype(np.float32)
    rows = np.concatenate(
        [counts[:, None], q * counts[:, None],
         covs_b.reshape(N, 9) * counts[:, None], np.zeros((N, 3))], axis=1)
    ca6 = covs_a.reshape(N, 9)[:, [0, 1, 2, 4, 5, 8]]
    x = np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * 0.2)))
    f32 = lambda a: np.array(a, np.float32, order="C")  # noqa: E731
    return f32(p.T), f32(ca6.T), f32(x), f32(rows), valid


def _pad8(a):
    return jnp.concatenate([jnp.asarray(a), jnp.zeros((8 - a.shape[0], a.shape[1]),
                                                      jnp.float32)])


def _jax_linearize(P, CA, x, rows, valid):
    return pallas_linearize.linearize_raw_pallas(
        _pad8(P), _pad8(CA), jnp.asarray(x), jnp.asarray(rows.T),
        _pad8(valid[None]), interpret=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_linearize_raw_plain_matches_pallas(seed):
    """err rtol 1e-4; H and b rtol 3e-3, atol 0.5 (the tolerances of
    test_pallas_linearize.py: 28 sums over 2048 terms of up to ~1e3 in two
    summation orders); aux rtol 1e-5, atol 1e-6 (per-element, same
    formulas)."""
    P, CA, x, rows, valid = _inputs(seed)
    err_j, H_j, b_j, aux_j = _jax_linearize(P, CA, x, rows, valid)
    err, H, b, aux = cuda_linearize.linearize_raw(
        *(torch.as_tensor(a) for a in (P, CA, x, rows, valid)))
    np.testing.assert_allclose(float(err), float(err_j), rtol=1e-4)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), rtol=3e-3, atol=0.5)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=3e-3, atol=0.5)
    assert aux.shape == (cuda_linearize.AUX_ROWS, N)
    np.testing.assert_allclose(aux.numpy(), np.asarray(aux_j)[:10],
                               rtol=1e-5, atol=1e-6)
    # the raw kernel's row 6 is the weight sqrt(count) * valid * alive
    w = np.sqrt(rows[:, 0]) * valid * (rows[:, 0] > 0)
    np.testing.assert_allclose(aux[6].numpy(), w, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_error_plain_matches_pallas(seed):
    """The trial error at a pose other than the linearization point, both
    packages reading the same frozen aux: rtol 1e-4."""
    P, CA, x, rows, valid = _inputs(seed)
    _e, _H, _b, aux = cuda_linearize.linearize_raw(
        *(torch.as_tensor(a) for a in (P, CA, x, rows, valid)))
    x2 = np.asarray(jse3.se3_exp(jnp.asarray(
        np.float32([0.02, 0.01, -0.03, 0.1, 0.2, 0.0])))) @ x
    aux16 = jnp.concatenate([jnp.asarray(aux.numpy()),
                             jnp.zeros((6, N), jnp.float32)])
    want = float(pallas_linearize.error_pallas(_pad8(P), aux16, jnp.asarray(x2),
                                               interpret=True))
    got = float(cuda_linearize.error(torch.as_tensor(P),
                                     torch.as_tensor(x2.astype(np.float32)), aux))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # at the linearization point the error is the linearization's err
    e0 = float(cuda_linearize.error(torch.as_tensor(P), torch.as_tensor(x), aux))
    np.testing.assert_allclose(e0, float(_e), rtol=1e-5)


def _finalized_rows(rows):
    """The same target statistics as GICP's finalized rows [mu (3), cov9,
    count, pad (3)], with count 1 (GICP's unit weight) where the raw row
    had a point and 0 where it was a miss."""
    count = rows[:, 0]
    inv = np.where(count > 0, 1.0 / np.maximum(count, 1.0), 0.0)[:, None]
    return np.concatenate(
        [rows[:, 1:4] * inv, rows[:, 4:13] * inv, (count > 0)[:, None],
         np.zeros((rows.shape[0], 3))], axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_linearize_plain_matches_pallas(seed):
    """Finalized rows against `linearize_pallas`: the tolerances of the
    raw-row test above (err rtol 1e-4; H and b rtol 3e-3, atol 0.5; aux
    rtol 1e-5, atol 1e-6)."""
    P, CA, x, raw, valid = _inputs(seed)
    rows = _finalized_rows(raw)
    err_j, H_j, b_j, aux_j = pallas_linearize.linearize_pallas(
        _pad8(P), _pad8(CA), jnp.asarray(x), jnp.asarray(rows.T),
        _pad8(valid[None]), interpret=True)
    err, H, b, aux = cuda_linearize.linearize(
        *(torch.as_tensor(a) for a in (P, CA, x, rows, valid)))
    np.testing.assert_allclose(float(err), float(err_j), rtol=1e-4)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), rtol=3e-3, atol=0.5)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=3e-3, atol=0.5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(aux_j)[:10],
                               rtol=1e-5, atol=1e-6)
    # the weight row is sqrt(count) * valid: a miss (count 0) weighs nothing
    np.testing.assert_array_equal(aux[6].numpy(), rows[:, 12] * valid)


def test_wrappers_reject_bad_inputs():
    P, CA, x, rows, valid = (torch.as_tensor(a) for a in _inputs(0))
    with pytest.raises(ValueError):
        cuda_linearize.linearize_raw(P, CA, x, rows.T, valid)
    with pytest.raises(ValueError):
        cuda_linearize.linearize_raw(P.double(), CA, x, rows, valid)
    with pytest.raises(ValueError):
        cuda_linearize.error(P, x, torch.zeros(16, N))
    with pytest.raises(ValueError):
        cuda_linearize.linearize(P, CA, x, rows[:, :13], valid)
