"""Port vs JAX: nearest-neighbour search.  The candidate-tile ranking
(fast_gicp_tpu_torch.ops.neighbors) and the plain versions of the 1-NN and
fused kNN-moment kernels (ops.cuda_kernels) against
fast_gicp_tpu.ops.neighbors and the Pallas kernel bodies `nn_search_pallas`
and `knn_moments_pallas`, run in interpret mode; the 1-NN plain version
also on the adversarial inputs of `utils.synthetic.nn_search_edge_cases`
against numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.ops import neighbors as jneighbors
from fast_gicp_tpu.ops import pallas_kernels
from fast_gicp_tpu_torch.ops import cuda_kernels, neighbors
from fast_gicp_tpu_torch.utils import synthetic


def _voxel_sorted_cloud(rng, n, extent=10.0, res=0.5):
    """A cloud in voxel-key order, the layout the port's downsampler emits
    and the tile culling relies on."""
    pts = (rng.random((n, 3)) * extent).astype(np.float32)
    keys = np.floor(pts / res).astype(np.int64)
    return pts[np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))]


def _tiles(case):
    rng = np.random.default_rng(3)
    n = 2048
    if case == "sorted":
        pts = _voxel_sorted_cloud(rng, n)
    else:  # "ties": unsorted, so every tile box overlaps every other (gap 0)
        pts = (rng.random((n, 3)) * 10.0).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-100:] = False
    return pts, mask


@pytest.mark.parametrize("case", ["sorted", "ties"])
def test_select_candidate_tiles_matches_jax(case):
    """cidx equal (ties broken toward the lower tile index by both), and
    the excluded tiles' squared gaps within 1e-6."""
    pts, mask = _tiles(case)
    qt, C = pts.reshape(-1, 256, 3), 5
    jt = jneighbors._masked_target(jnp.asarray(pts), jnp.asarray(mask))
    tt = neighbors._masked_target(torch.as_tensor(pts), torch.as_tensor(mask))
    cidx_j, ex_j = jneighbors.select_candidate_tiles(jnp.asarray(qt),
                                                     jt.reshape(-1, 128, 3), C)
    cidx, ex = neighbors.select_candidate_tiles(torch.as_tensor(qt),
                                                tt.reshape(-1, 128, 3), C)
    assert cidx.dtype == torch.int32 and cidx.shape == (8, C)
    np.testing.assert_array_equal(cidx.numpy(), np.asarray(cidx_j))
    np.testing.assert_allclose(ex.numpy(), np.asarray(ex_j), rtol=1e-6, atol=1e-6)
    if case == "ties":
        assert (ex.numpy() == 0.0).all()
    # C >= T: every tile, nothing excluded
    cidx, ex = neighbors.select_candidate_tiles(torch.as_tensor(qt),
                                                tt.reshape(-1, 128, 3), 16)
    np.testing.assert_array_equal(cidx.numpy(), np.tile(np.arange(16), (8, 1)))
    assert np.isinf(ex.numpy()).all()


def _nn_case(case):
    rng = np.random.default_rng(7)
    if case == "random":
        nq, nt = 2048, 4096
        q = (rng.normal(size=(nq, 3)) * 10).astype(np.float32)
        t = (rng.normal(size=(nt, 3)) * 10).astype(np.float32)
        tmask = rng.uniform(size=nt) > 0.1
        return q, t, tmask
    # test_pallas_linearize.py's edge case: two sorted query clusters 200 m
    # apart, a sorted target covering only the first, half of it masked
    nq, nt = 1024, 2048
    a = rng.normal(size=(nq // 2, 3)) * 2.0
    b = rng.normal(size=(nq // 2, 3)) * 2.0 + np.float32([200.0, 0, 0])
    q = np.concatenate([a, b]).astype(np.float32)
    q = q[np.lexsort(q.T[::-1])]
    t = (rng.normal(size=(nt, 3)) * 2.0).astype(np.float32)
    t = t[np.lexsort(t.T[::-1])]
    return q, t, rng.uniform(size=nt) > 0.5


@pytest.mark.parametrize("case", ["random", "two_clusters_masked"])
def test_nn_search_plain_matches_pallas(case):
    """idx equal and d^2 within 1e-6 relative of `nn_search_pallas`
    (interpret mode): both form d^2 as ((q - t)^2) summed in one order."""
    q, t, tmask = _nn_case(case)
    idx_j, sq_j = pallas_kernels.nn_search_pallas(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(tmask), interpret=True)
    idx, sq = neighbors.nn_search(torch.as_tensor(q), torch.as_tensor(t),
                                  torch.as_tensor(tmask))
    assert idx.dtype == torch.int32 and sq.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_j), rtol=1e-6)
    assert tmask[idx.numpy()].all()
    # a query mask only marks rows whose results carry no meaning
    qmask = np.random.default_rng(1).uniform(size=len(q)) > 0.1
    idx_m, sq_m = neighbors.nn_search(torch.as_tensor(q), torch.as_tensor(t),
                                      torch.as_tensor(tmask), torch.as_tensor(qmask))
    np.testing.assert_array_equal(idx_m.numpy()[qmask], idx.numpy()[qmask])
    assert np.isfinite(sq_m.numpy()).all()


def test_nn_search_plain_ties_and_all_masked():
    """Ties go to the lowest target index; with every target masked the
    results stay finite (index 0, the first parked point)."""
    t = np.float32([[1, 0, 0], [0, 0, 0], [0, 0, 0], [2, 0, 0]])
    q = np.float32([[0, 0, 0], [1.5, 0, 0]])
    idx, sq = cuda_kernels.nn_search_plain(torch.as_tensor(q), torch.as_tensor(t),
                                           torch.ones(4, dtype=torch.bool))
    assert idx.tolist() == [1, 0] and sq.tolist() == [0.0, 0.25]
    idx, sq = cuda_kernels.nn_search_plain(torch.as_tensor(q), torch.as_tensor(t),
                                           torch.zeros(4, dtype=torch.bool))
    assert idx.tolist() == [0, 0] and np.isfinite(sq.numpy()).all()


def _packed_key_kth(pts, mask, cidx, k, ct=128):
    """numpy emulation of the packed-key rule with every operation rounded
    on its own (numpy does not fuse a multiply into the add that follows):
    the k-th smallest key & -4096 of each query's slab, as a float."""
    tgt = np.where(mask[:, None], pts, np.float32(cuda_kernels.MASK_COORD))
    out = []
    for i, row in enumerate(np.asarray(cidx)):
        cand = tgt.reshape(-1, ct, 3)[row].reshape(-1, 3)
        q = pts[256 * i:256 * (i + 1)]
        d = np.zeros((256, cand.shape[0]), np.float32)
        for a in range(3):
            dd = q[:, a:a + 1] - cand[None, :, a]
            d = d + dd * dd
        keys = (d.view(np.int32) & np.int32(-4096)) | np.arange(d.shape[1], dtype=np.int32)
        out.append((np.sort(keys, axis=1)[:, k - 1] & np.int32(-4096)).view(np.float32))
    return np.concatenate(out)


@pytest.mark.parametrize("C", [8, 16, 32])
def test_knn_moments_plain_matches_pallas(C):
    """The packed-key selection and moments against `knn_moments_pallas`
    (interpret mode, cand_tile 128) with the same cidx on 2,048 points,
    and at C = 32 on 4,096 points (16 query tiles): the widest slab both
    packages take, 4,096 positions (12 position bits in a key).

    kth: bit-equal to a numpy emulation of the packed-key rule, and within
    rtol 1e-6 of the Pallas kernel on all but at most 0.1% of the queries.
    XLA on the CPU fuses d^2's multiply-adds (FMA), so its d^2 may differ
    by an ulp; where that crosses a 2^-11 quantization step the kth differs
    by exactly one step, and the selected set stays the same.
    mom: rtol 1e-4, atol 1e-4 everywhere (test_ops.py's tolerance: the
    Pallas kernel sums the moments as an f32 matmul, the plain version
    adds the k neighbours in order)."""
    rng = np.random.default_rng(11)
    n, k = max(2048, 128 * C), 20
    pts = _voxel_sorted_cloud(rng, n)
    mask = np.ones(n, bool)
    mask[-70:] = False
    jt = jneighbors._masked_target(jnp.asarray(pts), jnp.asarray(mask))
    cidx_j, _ = jneighbors.select_candidate_tiles(
        jnp.asarray(pts).reshape(-1, 256, 3), jt.reshape(-1, 128, 3), C)
    mom_j, kth_j = pallas_kernels.knn_moments_pallas(
        jnp.asarray(pts), jnp.ones(n, bool), jnp.asarray(pts), jnp.asarray(mask),
        cidx_j, k, cand_tile=128, interpret=True)
    cidx = np.array(cidx_j)
    p = torch.as_tensor(pts)
    mom, kth = cuda_kernels.knn_moments(
        p, torch.ones(n, dtype=torch.bool), p, torch.as_tensor(mask),
        torch.as_tensor(cidx), k)
    assert mom.shape == (10, n) and kth.shape == (n,)
    np.testing.assert_array_equal(kth.numpy(), _packed_key_kth(pts, mask, cidx, k))
    kth_j = np.asarray(kth_j)
    off = np.abs(kth.numpy() - kth_j) > 1e-6 * np.abs(kth_j)
    assert off.mean() <= 1e-3, np.nonzero(off)
    np.testing.assert_allclose(kth.numpy()[off], kth_j[off], rtol=2.0 ** -11)
    np.testing.assert_allclose(mom.numpy(), np.asarray(mom_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(mom[0].numpy(), float(k))


def test_knn_moments_rejects_bad_inputs():
    p = torch.zeros((512, 3))
    m = torch.ones(512, dtype=torch.bool)
    cidx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_kernels.knn_moments(p[:500], m[:500], p, m, cidx, 20)  # not tiled
    with pytest.raises(ValueError):
        cuda_kernels.knn_moments(p, m, p, m, cidx.long(), 20)  # cidx dtype
    with pytest.raises(ValueError):
        cuda_kernels.knn_moments(p, m, p, m, cidx, 513)  # k > slab
    with pytest.raises(ValueError):
        cuda_kernels.knn_moments(p, m, torch.zeros((8192, 3)),
                                 torch.ones(8192, dtype=torch.bool),
                                 torch.zeros((2, 33), dtype=torch.int32), 20)  # slab > 4096


KNN_EDGE_CASES = synthetic.knn_moments_edge_cases()


def _knn_moments_numpy(case):
    """The packed-key selection in numpy, every operation rounded on its
    own: masked points parked at MASK_COORD, tile ids outside [0, T) read as
    masked points, keys (bits of d^2) & -4096 | slab position, the k
    smallest.  Returns (mom (10, nq) f64 about each query tile's first
    query point, kth (nq,) f32, the number of a query's candidates in the
    k-th key's 2^-11 step (nq,), the number of them it selects (nq,))."""
    park = np.float32(cuda_kernels.MASK_COORD)
    q = np.where(case["qmask"][:, None], case["query"], park)
    tgt, tmask, cidx, k, ct = (case[key] for key in ("target", "tmask", "cidx", "k",
                                                     "cand_tile"))
    t = np.where(tmask[:, None], tgt, park).reshape(-1, ct, 3)
    v = tmask.astype(np.float32).reshape(-1, ct)
    T = t.shape[0]
    moms, kths, in_step, taken = [], [], [], []
    for i, row in enumerate(cidx):
        inside = (row >= 0) & (row < T)
        rr = np.clip(row, 0, T - 1)
        cand = np.where(inside[:, None, None], t[rr], park).reshape(-1, 3)
        cv = np.where(inside[:, None], v[rr], 0.0).reshape(-1)
        qq = q[256 * i:256 * (i + 1)]
        d = synthetic._sq_dist_f32(qq, cand)
        keys = (d.view(np.int32) & np.int32(-4096)) | np.arange(d.shape[1], dtype=np.int32)
        order = np.argsort(keys, axis=1)[:, :k]
        kth_key = np.take_along_axis(keys, order[:, k - 1:], 1) & np.int32(-4096)
        kths.append(np.maximum(kth_key[:, 0].view(np.float32), np.float32(0.0)))
        step = (keys & np.int32(-4096)) == kth_key
        in_step.append(step.sum(1))
        taken.append(np.take_along_axis(step, order, 1).sum(1))
        w = cv[order].astype(np.float64)
        y = (cand[order].astype(np.float64) - qq[0].astype(np.float64)) * w[..., None]
        y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
        moms.append(np.stack([w, y0, y1, y2, y0 * y0, y0 * y1, y0 * y2, y1 * y1, y1 * y2,
                              y2 * y2]).sum(-1))
    return (np.concatenate(moms, 1), np.concatenate(kths), np.concatenate(in_step),
            np.concatenate(taken))


def _knn_case_args(case):
    return [torch.as_tensor(case[key]) for key in ("query", "qmask", "target", "tmask",
                                                   "cidx")]


@pytest.mark.parametrize("case", KNN_EDGE_CASES, ids=[c["name"] for c in KNN_EDGE_CASES])
def test_knn_moments_plain_edge_cases_match_numpy(case):
    """The plain version (the card's reference) on the adversarial inputs of
    `knn_moments_edge_cases`: kth bit-equal to the numpy selection on every
    query (masked ones included), the count row equal, and the moment rows
    within 1e-5 of each query's largest |entry| of the f64 sums of the same
    selection.  The key-step case really ties at the k-th place: its
    queries select 10 of the 16 candidates in the k-th key's step."""
    mom, kth = cuda_kernels.knn_moments(*_knn_case_args(case), case["k"], case["cand_tile"])
    want, want_kth, in_step, taken = _knn_moments_numpy(case)
    np.testing.assert_array_equal(kth.numpy(), want_kth)
    np.testing.assert_array_equal(mom[0].numpy(), want[0])
    scale = np.abs(want).max(0, keepdims=True)
    assert (np.abs(mom.numpy() - want) <= 1e-5 * scale).all(), \
        (np.abs(mom.numpy() - want) / scale).max(1)
    if case["name"].startswith("ties_within_key_step"):
        assert (in_step == 16).all() and (taken == 10).all()


JAX_KNN_CASES = [c for c in KNN_EDGE_CASES if c["in_range"]]


@pytest.mark.parametrize("case", JAX_KNN_CASES, ids=[c["name"] for c in JAX_KNN_CASES])
def test_knn_moments_plain_edge_cases_match_pallas(case):
    """Against `knn_moments_pallas` (interpret mode) on the edge cases whose
    tile ids are all in range (it gathers others by its own rules): kth
    bit-equal where every d^2 is exact or rounded once, else as
    `test_knn_moments_plain_matches_pallas` holds it (at most 0.1% of the
    queries one 2^-11 step off: XLA on the CPU contracts d^2's
    multiply-adds); mom within rtol 1e-4, atol 1e-4."""
    q, qm, t, tm, cidx = (jnp.asarray(case[key]) for key in ("query", "qmask", "target",
                                                             "tmask", "cidx"))
    mom_j, kth_j = pallas_kernels.knn_moments_pallas(q, qm, t, tm, cidx, case["k"],
                                                     cand_tile=case["cand_tile"],
                                                     interpret=True)
    mom, kth = cuda_kernels.knn_moments(*_knn_case_args(case), case["k"], case["cand_tile"])
    kth_j = np.asarray(kth_j)
    if case["exact_d2"]:
        np.testing.assert_array_equal(kth.numpy(), kth_j)
    else:
        off = np.abs(kth.numpy() - kth_j) > 1e-6 * np.abs(kth_j)
        assert off.mean() <= 1e-3, np.nonzero(off)
        np.testing.assert_allclose(kth.numpy()[off], kth_j[off], rtol=2.0 ** -11)
    np.testing.assert_allclose(mom.numpy(), np.asarray(mom_j), rtol=1e-4, atol=1e-4)


NN_EDGE_CASES = synthetic.nn_search_edge_cases()


def _nn_numpy(case):
    """Exact 1-NN in numpy: masked targets parked at MASK_COORD, d^2 rounded
    in the kernels' order, the first index among equal minima."""
    t = np.where(case["tmask"][:, None], case["target"], np.float32(cuda_kernels.MASK_COORD))
    d = synthetic._sq_dist_f32(case["query"], t)
    idx = d.argmin(1)
    return idx, np.maximum(d[np.arange(len(d)), idx], np.float32(0.0)), d


@pytest.mark.parametrize("case", NN_EDGE_CASES, ids=[c["name"] for c in NN_EDGE_CASES])
def test_nn_search_plain_edge_cases_match_numpy(case):
    """The plain version (the card's reference) on the adversarial inputs of
    `nn_search_edge_cases`: idx and d^2 bit-equal to the numpy argmin on
    every valid query, ties included (the lowest index wins), and finite
    on every query."""
    idx, d2 = cuda_kernels.nn_search(*(torch.as_tensor(case[k]) for k in
                                       ("query", "target", "tmask", "qmask")))
    want_idx, want_d2, _d = _nn_numpy(case)
    v = case["qmask"]
    np.testing.assert_array_equal(idx.numpy()[v], want_idx[v])
    np.testing.assert_array_equal(d2.numpy()[v], want_d2[v])
    assert np.isfinite(d2.numpy()).all()


JAX_NN_CASES = [c for c in NN_EDGE_CASES if c["jax"]]


@pytest.mark.parametrize("case", JAX_NN_CASES, ids=[c["name"] for c in JAX_NN_CASES])
def test_nn_search_plain_edge_cases_match_pallas(case):
    """Against `nn_search_pallas` (interpret mode) on the edge cases whose
    sizes it takes: d^2 within 1e-6 relative (XLA on the CPU may contract
    d^2's multiply-adds; on the exact grid they are equal) and idx equal
    where the nearest is unique.  The JAX kernel keeps the first minimum it
    meets across its two passes, not the lowest index, so ties are held to
    numpy alone (above)."""
    idx_j, d2_j = pallas_kernels.nn_search_pallas(
        jnp.asarray(case["query"]), jnp.asarray(case["target"]), jnp.asarray(case["tmask"]),
        interpret=True)
    idx, d2 = cuda_kernels.nn_search(*(torch.as_tensor(case[k]) for k in
                                       ("query", "target", "tmask", "qmask")))
    _i, want_d2, d = _nn_numpy(case)
    v = case["qmask"]
    unique = (d <= want_d2[:, None]).sum(1) == 1
    np.testing.assert_array_equal(idx.numpy()[v & unique], np.asarray(idx_j)[v & unique])
    np.testing.assert_allclose(d2.numpy()[v], np.asarray(d2_j)[v], rtol=1e-6, atol=0.0)
    if case["exact_d2"]:
        np.testing.assert_array_equal(d2.numpy()[v], np.asarray(d2_j)[v])
