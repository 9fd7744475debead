"""Port vs JAX: the plain versions of the linearize (raw and finalized
rows, gathered or read by index) and error kernels
(fast_gicp_tpu_torch.ops.cuda_linearize) against the Pallas kernel bodies
`linearize_raw_pallas` / `linearize_pallas` / `error_pallas`, run in
interpret mode and fed the gathered rows.

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
from fast_gicp_tpu_torch.utils import synthetic

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


def _table_and_ids(seed, raw, dtype):
    """_inputs(seed)'s target rows as a table of N rows (raw, or finalized
    as GICP's), and ids (N,) of `dtype` naming only a quarter of them: ids
    repeat, and some name miss rows (count 0)."""
    P, CA, x, table, valid = _inputs(seed)
    if not raw:
        table = _finalized_rows(table)
    ids = np.random.default_rng(seed + 100).integers(0, N // 4, N).astype(dtype)
    return P, CA, x, table, valid, ids


def _cancellation(P, CA, x, rows, raw):
    """(L,) the largest cancellation factor (|s| + |t|) / |s - t| of the
    adjugate entries and of the determinant that invert C_B + R C_A R^T,
    taken in float64 from the inputs (gathered rows, raw or finalized)."""
    R = np.asarray(x, np.float64)[:3, :3]
    C = np.asarray(CA, np.float64)[[0, 1, 2, 1, 3, 4, 2, 4, 5]].T.reshape(-1, 3, 3)
    r = np.asarray(rows, np.float64)
    B = (r[:, 4:13] / np.maximum(r[:, :1], 1.0) if raw else r[:, 3:12]).reshape(-1, 3, 3)
    e = B + R @ C @ R.T
    st = [(e[:, 1, 1] * e[:, 2, 2], e[:, 1, 2] * e[:, 1, 2]),
          (e[:, 0, 2] * e[:, 1, 2], e[:, 0, 1] * e[:, 2, 2]),
          (e[:, 0, 1] * e[:, 1, 2], e[:, 0, 2] * e[:, 1, 1])]
    terms = np.stack([e[:, 0, k] * (s - t) for k, (s, t) in enumerate(st)])
    st += [(e[:, 0, 0] * e[:, 2, 2], e[:, 0, 2] * e[:, 0, 2]),
           (e[:, 0, 1] * e[:, 0, 2], e[:, 0, 0] * e[:, 1, 2]),
           (e[:, 0, 0] * e[:, 1, 1], e[:, 0, 1] * e[:, 0, 1])]
    with np.errstate(divide="ignore", invalid="ignore"):
        k_adj = np.stack([(abs(s) + abs(t)) / abs(s - t) for s, t in st]).max(0)
        k_det = abs(terms).sum(0) / abs(terms.sum(0))
    return np.nan_to_num(np.maximum(k_adj, k_det), nan=np.inf)


# Lanes whose inverse cancels more than this are held to their largest |M|:
# a fused multiply-add moves an entry by up to ~kappa * 2^-24 of itself.
CANCELLING = 64.0


def _assert_aux_close(aux, aux_j, kappa):
    """aux against the Pallas kernel's: M (rows 0-5) rtol 1e-5, atol 1e-6
    on the lanes whose inverse cancels at most CANCELLING-fold (kappa, from
    _cancellation), and within 1e-5 of the lane's largest |M| on the
    others, since XLA:CPU fuses multiply-adds in interpret mode; w and mu_B
    (rows 6-9) rtol 1e-5, atol 1e-6.  Readings on _table_and_ids' inputs,
    seeds 0-5, raw and finalized rows: 38-49 of the 2,048 lanes cancel more
    than 64-fold; one M entry on them misses the per-element limit (seed 0,
    finalized, kappa 1,352: 4.3e-4 of itself), and the largest error on
    any lane is 7.4e-6 of the lane's largest |M|."""
    aux, aux_j = aux.numpy(), np.asarray(aux_j)
    calm = kappa <= CANCELLING
    np.testing.assert_allclose(aux[:6, calm], aux_j[:6, calm], rtol=1e-5, atol=1e-6)
    scale = np.maximum(np.abs(aux_j[:6, ~calm]).max(0), 1e-30)
    np.testing.assert_allclose(aux[:6, ~calm] / scale, aux_j[:6, ~calm] / scale,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(aux[6:10], aux_j[6:10], rtol=1e-5, atol=1e-6)


def _wrapper(raw):
    return cuda_linearize.linearize_raw if raw else cuda_linearize.linearize


def _pallas(raw):
    return (pallas_linearize.linearize_raw_pallas if raw
            else pallas_linearize.linearize_pallas)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("raw", [True, False], ids=["raw", "finalized"])
def test_idx_form_plain_matches_pallas(raw, dtype):
    """The idx form (correspondence n reads row ids[n] of the table) against
    the Pallas kernel fed table[ids], the rows the JAX package gathers
    first: err rtol 1e-4; H and b rtol 3e-3, atol 0.5, as the gathered-form
    tests above; aux as _assert_aux_close."""
    P, CA, x, table, valid, ids = _table_and_ids(0, raw, dtype)
    count = table[ids, 0 if raw else 12]
    assert (count == 0).any() and len(np.unique(ids)) < N // 4 + 1 < N
    err_j, H_j, b_j, aux_j = _pallas(raw)(
        _pad8(P), _pad8(CA), jnp.asarray(x), jnp.asarray(table[ids].T),
        _pad8(valid[None]), interpret=True)
    err, H, b, aux = _wrapper(raw)(*(torch.as_tensor(a) for a in (P, CA, x, table, valid)),
                                   idx=torch.as_tensor(ids))
    np.testing.assert_allclose(float(err), float(err_j), rtol=1e-4)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), rtol=3e-3, atol=0.5)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=3e-3, atol=0.5)
    _assert_aux_close(aux, np.asarray(aux_j)[:10], _cancellation(P, CA, x, table[ids], raw))
    # a miss row weighs nothing
    assert not aux[6].numpy()[count == 0].any()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("raw", [True, False], ids=["raw", "finalized"])
def test_idx_form_bit_equal_to_gathered_form(raw, dtype):
    """The plain version's idx form gives the gathered form's bits."""
    P, CA, x, table, valid, ids = (torch.as_tensor(a) for a in _table_and_ids(1, raw, dtype))
    got = _wrapper(raw)(P, CA, x, table, valid, ids)
    want = _wrapper(raw)(P, CA, x, table[ids.long()], valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# `utils.synthetic.linearize_edge_cases` without its 157,696-lane case
EDGE_CASES = ("ragged_L_1001", "below_one_block_L_91", "one_lane", "all_invalid_or_miss",
              "singular", "repeated_ids")


@pytest.fixture(scope="module")
def edge_cases():
    return {c["name"]: c for c in synthetic.linearize_edge_cases(grid_stride=False)}


def _pad_lanes(a, n, axis):
    """a zero-padded to n lanes along `axis` (padded lanes are invalid)."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, n - a.shape[axis])
    return np.pad(a, pad)


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "finalized"])
@pytest.mark.parametrize("name", EDGE_CASES)
def test_edge_cases_match_pallas(edge_cases, name, raw):
    """The plain versions on the kernels' edge cases (the cases chip_smoke.py
    holds the kernels to them on): the idx form with int32 and int64 ids
    bit-equal to the gathered form, H exactly symmetric, err, H and b
    exactly 0 where no lane counts; against the Pallas kernel fed the
    gathered rows, lanes zero-padded to its 2,048 tile, at the tolerances
    of test_idx_form_plain_matches_pallas (the singular case's sums, ~1e20,
    within 1e-5 of their largest entry)."""
    case = edge_cases[name]
    table = case["raw" if raw else "fin"]
    P, CA, x, tbl, valid = (torch.as_tensor(case[k]) for k in ("p", "ca", "x", "raw" if raw
                                                                 else "fin", "valid"))
    outs = [_wrapper(raw)(P, CA, x, tbl, valid, torch.as_tensor(case["ids"]).to(dt))
            for dt in (torch.int32, torch.int64)]
    gathered = _wrapper(raw)(P, CA, x, tbl[torch.as_tensor(case["ids"])], valid)
    for out in outs:
        assert all(torch.equal(g, w) for g, w in zip(out, gathered))
    err, H, b, aux = gathered
    assert torch.equal(H, H.T)
    assert all(bool(torch.isfinite(t).all()) for t in gathered)
    if name == "all_invalid_or_miss":
        assert not (err.any() or H.any() or b.any())

    L = case["p"].shape[1]
    n = -(-L // 2048) * 2048
    err_j, H_j, b_j, aux_j = _pallas(raw)(
        _pad8(_pad_lanes(case["p"], n, 1)), _pad8(_pad_lanes(case["ca"], n, 1)),
        jnp.asarray(case["x"]), jnp.asarray(_pad_lanes(table[case["ids"]], n, 0).T),
        _pad8(_pad_lanes(case["valid"], n, 0)[None]), interpret=True)
    H_j, b_j = np.asarray(H_j), np.asarray(b_j)
    if name == "singular":
        for got, want in ((err.reshape(1), np.reshape(err_j, 1)), (H, H_j), (b, b_j)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(float(err), float(err_j), rtol=1e-4)
        np.testing.assert_allclose(H.numpy(), H_j, rtol=3e-3, atol=0.5)
        np.testing.assert_allclose(b.numpy(), b_j, rtol=3e-3, atol=0.5)
    _assert_aux_close(aux, np.asarray(aux_j)[:10, :L],
                      _cancellation(case["p"], case["ca"], case["x"], table[case["ids"]], raw))
