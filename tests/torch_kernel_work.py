"""The work the `radius_count`, `radius_window`, `knn_slab`,
`knn_moments`, `nn_search` and `rbf_moments` kernels walk on the
full-size synthetic pair (the pair `chip_smoke.py` registers), counted on
the CPU from the same packing, boxes and slabs the kernels get, and the
certificate of the fused kNN moments on that pair.

    python tests/torch_kernel_work.py

Prints, for the adaptive estimator's count on the target cloud: the pairs
within the ladder's largest rung, the pairs the 128-point tile cull visits
(`chip_smoke.culled_tiles`) and the share of (warp of 32 queries, visited
target) steps in which some query of the warp is in range, the share a
warp vote would not skip.  For its window pass at each query's own radius:
the pairs inside the windows, the pairs the first design's 128-query block
cull visited (`chip_smoke.block_window_visited_pairs`) and the pairs the
warp-a-query kernel visits over 32-target chunks
(`chip_smoke.window_visited_pairs`).  For the k-NN slab search (k = 20):
the mean and largest number of candidates a query meets below its running
k-th key in slab order, one warp step of 32 positions at a time, without
and with the kernel's first-pass bound (the k-th smallest of the 32 lane
minima), on the target and the source cloud at C = 16 x 256 (the MIN_EIG
path) and on every 8th query tile of the exact search (C = T x 128, index
order); the same for the fused kNN moments' packed keys at C = 16 x 128
(the GICP path) on every 4th query tile of the target.  For the 1-NN
search at the GICP path's first re-search and the RBF moments of the
target cloud (VGICP): the pairs the first designs' 128 x 128 tile culls
visited, and the pairs the chunked kernels visit
(`chip_smoke.nn_search_emulated`, `chip_smoke.rbf_visited_pairs`).  For
the fused kNN moments of each cloud (k = 20, 16 of the 128-point tiles a
query tile): the share of valid queries not certified (the k-th distance
above the squared gap of the query tile's nearest excluded tile) and the
share whose neighbour set differs from the exact k-NN's.
A few minutes on the CPU."""

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from fast_gicp_tpu_torch import se3  # noqa: E402
from fast_gicp_tpu_torch.ops import cuda_kernels  # noqa: E402
from fast_gicp_tpu_torch.ops import covariance, neighbors  # noqa: E402
from fast_gicp_tpu_torch.ops.covariance import (  # noqa: E402
    default_radius_ladder, masked_mean, window_radii,
)
from fast_gicp_tpu_torch.ops.neighbors import (  # noqa: E402
    _masked_target, select_candidate_tiles,
)
from fast_gicp_tpu_torch.utils.padding import pad_points  # noqa: E402


def count_work(points):
    p, m = (torch.as_tensor(a) for a in pad_points(points))
    q4 = cuda_kernels._pack_masked(p - masked_mean(p, m), m)
    t = q4.reshape(-1, 128, 4)
    valid = (t[..., 3] != 0)[..., None]
    big = torch.finfo(torch.float32).max
    boxes = torch.cat([torch.where(valid, t[..., :3], big).amin(1),
                       torch.where(valid, t[..., :3], -big).amax(1)], 1).reshape(-1)
    r2max = float(default_radius_ladder().max())
    kept = chip_smoke.culled_tiles(q4, boxes, r2max)
    visited = int(kept.sum()) * 128 * 128
    in_range = steps = live = 0
    for blk in range(t.shape[0]):
        tiles = torch.nonzero(kept[blk])[:, 0]
        d = cuda_kernels._sq_dist(t[blk, :, None, :3], t[tiles, :, :3].reshape(1, -1, 3))
        inside = d <= r2max
        in_range += int((inside & valid[blk]).sum())
        warp_any = inside.reshape(4, 32, -1).any(1)
        steps += warp_any.numel()
        live += int(warp_any.sum())
    print(f"radius_count: {in_range} pairs (valid queries) within the largest rung, "
          f"{visited} visited by the cull ({visited / in_range:.2f}x); some query of the "
          f"warp in range on {live / steps:.3f} of {steps} (warp, target) steps")


def window_work(points):
    """Pairs in the adaptive windows of the cloud against itself and the
    pairs both `radius_window` designs visit for them."""
    p, m = (torch.as_tensor(a) for a in pad_points(points))
    c = masked_mean(p, m)
    q4 = cuda_kernels._pack_masked(p - c, m)
    r2 = torch.as_tensor(default_radius_ladder())
    r2q = window_radii(cuda_kernels.radius_count_plain(p, m, p, m, c, r2), r2, 20)
    valid = q4[:, 3] != 0
    boxes = torch.cat(chip_smoke._boxes(q4[:, :3], valid, 128), 1).reshape(-1)
    chunk_boxes = torch.cat(chip_smoke._boxes(q4[:, :3], valid, chip_smoke.CHUNK), 1)
    y = q4[valid, :3]
    in_window = sum(int((cuda_kernels._sq_dist(y[s:s + 1024, None], y[None])
                         <= r2q[valid][s:s + 1024, None]).sum())
                    for s in range(0, y.shape[0], 1024))
    block = chip_smoke.block_window_visited_pairs(q4, boxes, r2q)
    chunked = chip_smoke.window_visited_pairs(q4, chunk_boxes.reshape(-1), r2q, q4.shape[0])
    radii = torch.unique(r2q[valid], return_counts=True)
    print(f"radius_window: {in_window} pairs in the windows; {block} visited by 128-query "
          f"blocks over 128-target tiles ({block / in_window:.1f}x); {chunked} by a warp a "
          f"query over {chip_smoke.CHUNK}-target chunks ({chunked / in_window:.1f}x, "
          f"{chunked / (chip_smoke.CHUNK * int(valid.sum())):.1f} chunks a valid query); "
          "squared window radius -> valid queries: "
          + ", ".join(f"{float(r):.2f} -> {int(n)}" for r, n in zip(*radii)))


def _fused_keys(c, m, k, C=16, ct=128):
    """The fused kNN moments' slabs: (cidx (Q, C), excluded_sq (Q,), and a
    function of a query tile giving its (256, C * ct) packed keys)."""
    n = c.shape[0]
    t = _masked_target(c, m)
    cidx, excluded = select_candidate_tiles(c.reshape(-1, 256, 3), t.reshape(-1, ct, 3), C)
    pos = torch.arange(C * ct, dtype=torch.int32)

    def keys(qt):
        d = cuda_kernels._sq_dist(c[qt * 256:(qt + 1) * 256, None, :],
                                  t.reshape(n // ct, ct, 3)[cidx[qt].long()].reshape(1, -1, 3))
        return (d.view(torch.int32) & -4096) | pos

    return cidx, excluded, keys


def knn_moments_hits(points, k=20, every=4):
    """Mean and largest number of packed keys a query meets below its
    running k-th key, a warp step at a time, without and with the
    lane-minimum bound (the fused kernel's test: key <= bound and below the
    k-th kept key), at C = 16 x 128."""
    p, m = (torch.as_tensor(a) for a in pad_points(points))
    cidx, _excluded, keys = _fused_keys(p, m, k)
    plain, bounded = [], []
    for qt in range(0, cidx.shape[0], every):
        key = keys(qt)
        bound = torch.sort(key.reshape(256, -1, 32).amin(1), dim=1).values[:, k - 1:k]
        top = torch.full((256, k), torch.iinfo(torch.int32).max, dtype=torch.int32)
        h0 = torch.zeros(256)
        h1 = torch.zeros(256)
        for s in range(0, key.shape[1], 32):
            step = key[:, s:s + 32]
            kth = top[:, k - 1:k]
            h0 += (step < kth).sum(1)
            h1 += (step < torch.minimum(kth, bound + 1)).sum(1)
            top = torch.sort(torch.cat([top, step], 1), dim=1).values[:, :k]
        plain.append(h0)
        bounded.append(h1)
    plain, bounded = torch.cat(plain), torch.cat(bounded)
    return (float(plain.mean()), float(plain.max()), float(bounded.mean()),
            float(bounded.max()))


def knn_certificate(points, k=20):
    """Shares of the valid queries whose fused kNN selection (16 of the
    128-point tiles a query tile) is not certified (kth > the squared gap
    of the nearest excluded tile) and whose neighbour set differs from the
    exact k-NN's (`knn_search`, ties to the lower index); and the share of
    differing sets among the certified queries (the 2^-11 key step's
    ties)."""
    p, m = (torch.as_tensor(a) for a in pad_points(points))
    n = p.shape[0]
    _mom, kth, excluded = covariance._knn_moment_cols_fused(p, m, k)
    certified = kth <= excluded.repeat_interleave(256)
    cidx, _excluded, keys = _fused_keys(p, m, k)
    fused = []
    for qt in range(cidx.shape[0]):
        pos = torch.topk(keys(qt), k, dim=1, largest=False).values & 4095
        fused.append(cidx[qt].long()[pos // 128] * 128 + pos % 128)
    fused = torch.sort(torch.cat(fused), dim=1).values
    exact, _sq = neighbors.knn_search(p, p, m, k, device="cpu")
    differs = (fused != torch.sort(exact.long(), dim=1).values).any(1)
    v = m
    return (float((~certified[v]).float().mean()), float(differs[v].float().mean()),
            float(differs[v & certified].float().mean()), int(v.sum()))


def slab_hits(points, k=20, exact=False, every=1):
    """Mean and largest number of candidates below the running k-th key, a
    warp step at a time, without and with the lane-minimum bound."""
    p, m = (torch.as_tensor(a) for a in pad_points(points))
    c = p - masked_mean(p, m)
    n = c.shape[0]
    ct = 128 if exact else 256
    if exact:
        cidx = torch.arange(n // ct, dtype=torch.int32).expand(n // 256, n // ct)
    else:
        cidx, _excluded = select_candidate_tiles(
            c.reshape(-1, 256, 3), _masked_target(c, m).reshape(-1, 256, 3), 16)
    t = _masked_target(c, m).reshape(-1, ct, 3)
    plain, bounded = [], []
    for qt in range(0, cidx.shape[0], every):
        d = cuda_kernels._sq_dist(c[qt * 256:(qt + 1) * 256, None, :],
                                  t[cidx[qt].long()].reshape(1, -1, 3))
        bound = torch.sort(d.reshape(256, -1, 32).amin(1), dim=1).values[:, k - 1:k]
        top = torch.full((256, k), float("inf"))
        h0 = torch.zeros(256)
        h1 = torch.zeros(256)
        for s in range(0, d.shape[1], 32):
            step = d[:, s:s + 32]
            kth = top[:, k - 1:k]
            h0 += (step < kth).sum(1)
            h1 += (step <= torch.minimum(kth, bound)).sum(1)
            top = torch.sort(torch.cat([top, step], 1), dim=1).values[:, :k]
        plain.append(h0)
        bounded.append(h1)
    plain, bounded = torch.cat(plain), torch.cat(bounded)
    return (float(plain.mean()), float(plain.max()), float(bounded.mean()),
            float(bounded.max()))


def tile_nn_visits(q4, t4, tile=128):
    """Pairs the first `nn_search` design visited: blocks of 128 queries
    walk the 128-target tiles whose box (masked targets included) touches
    the box of their valid queries, then those with 0 < gap^2 <= the
    block's worst best d^2, which it lowered after every visited tile."""
    q, t = q4[:, :3], t4[:, :3]
    valid = q4[:, 3] != 0
    nt = t.shape[0]
    qlo, qhi = chip_smoke._boxes(q, valid, tile)
    alo, ahi = chip_smoke._boxes(q, torch.ones_like(valid), tile)
    none = ~valid.reshape(-1, tile).any(1)  # a block of masked rows boxes them all
    qlo, qhi = torch.where(none[:, None], alo, qlo), torch.where(none[:, None], ahi, qhi)
    counts = torch.where(none[:, None], True, valid.reshape(-1, tile)).reshape(-1)
    tlo, thi = chip_smoke._boxes(t, torch.ones(nt, dtype=torch.bool), tile)
    gap = chip_smoke._gap2(qlo, qhi, tlo, thi)
    tmin = torch.stack([cuda_kernels._sq_dist(q[:, None, :], t[None, s:s + tile]).amin(1)
                        for s in range(0, nt, tile)], 1)  # (nq, tiles)
    best = torch.full((q.shape[0],), float("inf"))
    visits = 0
    for pass_ in range(2):
        for tt in range(tlo.shape[0]):
            bound = torch.where(counts, best, 0.0).reshape(-1, tile).amax(1)
            g = gap[:, tt]
            visit = g <= 0 if pass_ == 0 else (g > 0) & (g <= bound)
            visits += int(visit.sum())
            best = torch.where(visit.repeat_interleave(tile), torch.minimum(best, tmin[:, tt]),
                               best)
    return visits * tile * tile


def nn_rbf_work(source, target):
    """Pairs `nn_search` (the GICP path's first re-search, as chip_smoke.py
    checks it) and `rbf_moments` (the target cloud about its mean) visit
    under the first designs' tile culls and the chunked kernels'."""
    sp, sm = (torch.as_tensor(a) for a in pad_points(source))
    tp, tm = (torch.as_tensor(a) for a in pad_points(target))
    c = masked_mean(tp, tm)
    x = se3.se3_exp(torch.tensor([0.002, -0.001, 0.003, 0.02, -0.01, 0.005]))
    q = se3.transform_points(x, sp - c)
    q4 = torch.cat([q, sm.to(q.dtype)[:, None]], 1)
    t4 = cuda_kernels._pack_masked(tp - c, tm)
    _idx, _d2, chunked = chip_smoke.nn_search_emulated(q4, t4)
    print(f"nn_search: {tile_nn_visits(q4, t4)} pairs visited by 128 x 128 tiles in two "
          f"passes; {chunked} by {chip_smoke.NN_GROUPS} groups of {chip_smoke.NN_QUERIES} "
          f"threads over "
          f"{chip_smoke.CHUNK}-target chunks")
    p4 = cuda_kernels._pack(tp, tm, c)
    md2 = cuda_kernels._constants(0.5, 3.0)[1]
    tiles = int(chip_smoke.culled_tiles(p4, torch.cat(chip_smoke._boxes(
        p4[:, :3], tm, 128), 1).reshape(-1), md2).sum()) * 128 * 128
    y = (tp - c)[tm]
    in_range = sum(int((cuda_kernels._sq_dist(y[s:s + 1024, None], y[None]) <= md2).sum())
                   for s in range(0, y.shape[0], 1024))
    print(f"rbf_moments: {in_range} pairs within 3 m; {tiles} visited by 128 x 128 tiles; "
          f"{chip_smoke.rbf_visited_pairs(p4, p4, md2)} by blocks of 32 queries over "
          f"{chip_smoke.CHUNK}-target chunks")


def main():
    source, target, _gt = chip_smoke.synthetic_pair()
    nn_rbf_work(source, target)
    count_work(target)
    window_work(target)
    h = knn_moments_hits(target)
    print(f"knn_moments target, C = 16 x 128 (every 4th query tile): below the running k-th "
          f"key {h[0]:.1f} a query (max {h[1]:.0f}); with the lane-minimum bound {h[2]:.1f} "
          f"(max {h[3]:.0f})")
    for name, pts in (("target", target), ("source", source)):
        miss, differs, certified_differs, nv = knn_certificate(pts)
        print(f"knn_moments {name} ({nv} valid queries, k = 20): not certified {miss:.4%}; "
              f"set differs from the exact k-NN {differs:.4%} (among the certified "
              f"{certified_differs:.4%})")
    for name, pts, exact, every in (("target, C = 16 x 256", target, False, 1),
                                    ("source, C = 16 x 256", source, False, 1),
                                    ("target, exact (every 8th query tile)", target, True, 8)):
        h = slab_hits(pts, exact=exact, every=every)
        print(f"knn_slab {name}: below the running k-th key {h[0]:.1f} a query (max "
              f"{h[1]:.0f}); with the lane-minimum bound {h[2]:.1f} (max {h[3]:.0f})")


if __name__ == "__main__":
    main()
