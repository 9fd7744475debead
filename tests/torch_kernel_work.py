"""The work the `radius_count`, `knn_slab`, `nn_search` and `rbf_moments`
kernels walk on the full-size synthetic pair (the pair `chip_smoke.py`
registers), counted on the CPU from the same packing, boxes and slabs the
kernels get.

    python tests/torch_kernel_work.py

Prints, for the adaptive estimator's count on the target cloud: the pairs
within the ladder's largest rung, the pairs the 128-point tile cull visits
(`chip_smoke.culled_tiles`) and the share of (warp of 32 queries, visited
target) steps in which some query of the warp is in range, the share a
warp vote would not skip.  For the k-NN slab search (k = 20): the mean and
largest number of candidates a query meets below its running k-th key in
slab order, one warp step of 32 positions at a time, without and with the
kernel's first-pass bound (the k-th smallest of the 32 lane minima), on
the target and the source cloud at C = 16 x 256 (the MIN_EIG path) and on
every 8th query tile of the exact search (C = T x 128, index order).
For the 1-NN search at the GICP path's first re-search and the RBF moments
of the target cloud (VGICP): the pairs the first designs' 128 x 128 tile
culls visited, and the pairs the chunked kernels visit
(`chip_smoke.nn_search_emulated`, `chip_smoke.rbf_visited_pairs`).
A few minutes on the CPU."""

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from fast_gicp_tpu_torch import se3  # noqa: E402
from fast_gicp_tpu_torch.ops import cuda_kernels  # noqa: E402
from fast_gicp_tpu_torch.ops.covariance import default_radius_ladder, masked_mean  # noqa: E402
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
    for name, pts, exact, every in (("target, C = 16 x 256", target, False, 1),
                                    ("source, C = 16 x 256", source, False, 1),
                                    ("target, exact (every 8th query tile)", target, True, 8)):
        h = slab_hits(pts, exact=exact, every=every)
        print(f"knn_slab {name}: below the running k-th key {h[0]:.1f} a query (max "
              f"{h[1]:.0f}); with the lane-minimum bound {h[2]:.1f} (max {h[3]:.0f})")


if __name__ == "__main__":
    main()
