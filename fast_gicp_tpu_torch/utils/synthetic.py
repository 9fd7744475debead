"""Synthetic LiDAR drive generation for benchmarks and tests.

No KITTI data ships in this environment (and none exists in the reference
repo either — its KITTI runner expects a user-supplied velodyne directory,
kitti.cpp:71-79), so odometry throughput/accuracy claims are pinned on
synthetic drives with REALISTIC inter-frame motion: a 10 Hz sensor moving
at ~10 m/s around a closed circuit turns ~0.7 deg/frame — far gentler
than toy loops with tens of degrees per frame, and representative of the
KITTI sequences the reference demos (README.md:139-155).

The world is a structured scene (ground plane, building walls, pillars)
sampled densely enough that a 55 m-range scan sees 20-60k points before
downsampling, like a 64-beam LiDAR.
"""

from __future__ import annotations

import numpy as np


def drive_world(rng, half_extent: float = 140.0, n: int = 1_400_000):
    """Structured world covering a [-e, e]^2 area: ground + ring road
    walls + pillar clusters (the geometry VGICP needs to constrain all six
    degrees of freedom).  The default extent EXCEEDS the default drive's
    sensing reach (radius 80 + range 55 = 135): a sensor seeing past the
    world edge gets a void sector whose degenerate geometry is a
    generator artifact, not a property of real scenes."""
    e = half_extent
    ground = np.stack(
        [
            rng.uniform(-e, e, n // 2),
            rng.uniform(-e, e, n // 2),
            0.05 * rng.standard_normal(n // 2),
        ],
        axis=1,
    )
    # four building walls at varying radii/orientations
    walls = []
    for (wx, wy, along_x) in [(-70, 40, True), (55, -35, False),
                              (20, 75, True), (-45, -60, False)]:
        m = n // 12
        u = rng.uniform(-35, 35, m)
        if along_x:
            w = np.stack([wx + u, np.full(m, float(wy))
                          + 0.05 * rng.standard_normal(m),
                          rng.uniform(0, 6, m)], axis=1)
        else:
            w = np.stack([np.full(m, float(wx))
                          + 0.05 * rng.standard_normal(m),
                          wy + u, rng.uniform(0, 6, m)], axis=1)
        walls.append(w)
    n_pil = 100
    pillars = np.stack(
        [
            np.repeat(rng.uniform(-e, e, n_pil), n // (12 * n_pil)),
            np.repeat(rng.uniform(-e, e, n_pil), n // (12 * n_pil)),
            rng.uniform(0, 4, (n // (12 * n_pil)) * n_pil),
        ],
        axis=1,
    )
    # ring-road building fronts: arc wall segments flanking the default
    # drive circle (radius 80), so the sensor always has vertical structure
    # nearby — like buildings lining a street
    arcs = []
    for (r_arc, th0, th1) in [(62, 0.2, 1.3), (98, 1.0, 2.2), (60, 2.4, 3.6),
                              (100, 3.2, 4.4), (63, 4.6, 5.8), (97, 5.4, 6.2)]:
        m = n // 48
        th = rng.uniform(th0, th1, m)
        rr = r_arc + 0.05 * rng.standard_normal(m)
        arcs.append(np.stack(
            [rr * np.cos(th), rr * np.sin(th), rng.uniform(0, 5, m)], axis=1
        ))
    return np.concatenate([ground, *walls, pillars, *arcs]).astype(np.float32)


def drive_scans(
    rng,
    n_frames: int = 512,
    radius: float = 80.0,
    speed: float = 1.0,
    accel_frames: int = 8,
    sensor_range: float = 55.0,
    view_fraction: float = 0.35,
    noise: float = 0.01,
    world: np.ndarray | None = None,
):
    """Circuit drive: scans along a circle of `radius`, cruising at
    `speed` meters/frame after accelerating from REST over the first
    `accel_frames` frames (drives start stationary — this also gives the
    odometry a trackable bootstrap, like any real sequence).

    At the defaults the cruise motion is ~1 m and ~0.7 deg of yaw per
    frame (a 10 Hz sensor at ~10 m/s); 512 frames cover a bit over one
    full revolution, so the end revisits the start — scan-to-scan drift
    shows up as end-point error while scan-to-map re-anchors.

    Returns (scans, gt_poses); scans are sensor-frame (N, 3) float32 with
    per-frame dropout and Gaussian noise, gt_poses world-frame 4x4.
    Motion per frame is INDEPENDENT of n_frames (fewer frames = shorter
    drive, not faster motion).
    """
    if world is None:
        world = drive_world(rng)
    scans, poses = [], []
    arc = 0.0
    for i in range(n_frames):
        th = arc / radius
        # pose on the circle, heading along the tangent
        c, s = np.cos(th), np.sin(th)
        T = np.eye(4)
        T[:3, :3] = np.asarray(
            [[-s, -c, 0.0], [c, -s, 0.0], [0.0, 0.0, 1.0]]
        )
        T[:3, 3] = [radius * c, radius * s, 1.8]
        poses.append(T)
        local = (world - T[:3, 3]) @ T[:3, :3]
        r = np.linalg.norm(local, axis=1)
        # Range-dependent density like a real spinning LiDAR (~1/r^2 point
        # density on surfaces): a HARD range sphere would truncate boundary
        # voxels and bias their means toward the sensor — measured as a
        # systematic ~4 cm/frame forward bias in scan-to-scan VGICP on
        # hard-clipped synthetic scans, an artifact real scans don't have.
        p_keep = view_fraction * np.minimum(
            1.0, (20.0 / np.maximum(r, 20.0)) ** 2
        )
        sel = (r < sensor_range) & (rng.random(len(local)) < p_keep)
        scans.append(
            (local[sel] + noise * rng.standard_normal((int(sel.sum()), 3))
             ).astype(np.float32)
        )
        arc += speed * min(1.0, (i + 1) / max(accel_frames, 1))
    # Normalize so gt[0] == I, matching odometry conventions (pose chains
    # start at identity; ate_rmse compares absolute trajectories).
    inv0 = np.linalg.inv(poses[0])
    poses = [inv0 @ T for T in poses]
    return scans, poses


# --- adversarial inputs for the selection and counting kernels -------------


def _grid_points(rng, n: int, distinct: int):
    """n points drawn with repeats from `distinct` points of a 1/8 m grid in
    [0, 4)^3: every coordinate difference, square and sum of three squares
    is exact in f32, so d^2 ties are exact whatever the rounding order."""
    cells = rng.choice(32 ** 3, size=distinct, replace=False)
    grid = np.stack([cells // 1024, (cells // 32) % 32, cells % 32], axis=1) / 8.0
    return grid[rng.integers(0, distinct, n)].astype(np.float32)


def _street_points(rng, n: int):
    """n points over 120 m x 120 m x 4 m in voxel-key order (0.5 m voxels),
    some repeated: d^2 at ~60 m from the center rounds in the last bits."""
    pts = (rng.random((n, 3)) * np.float32([120, 120, 4])).astype(np.float32)
    pts[rng.choice(n, n // 16, replace=False)] = pts[rng.choice(n, n // 16, replace=False)]
    keys = np.floor(pts / 0.5).astype(np.int64)
    return pts[np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))]


def _mask(rng, n: int, masked: float):
    return rng.random(n) >= masked


def _sq_dist_f32(q, t):
    """(Nq, Nt) f32 d^2 = ((dx^2 + dy^2) + dz^2), each operation rounded."""
    d = np.zeros((len(q), len(t)), np.float32)
    for a in range(3):
        dd = q[:, a:a + 1] - t[None, :, a]
        d = d + dd * dd
    return d


def knn_slab_edge_cases(seed: int = 0):
    """Inputs for the k-NN slab search (`ops.cuda_kernels.knn_slab`) that
    stress its tie rule and its edges, made from `seed`: d^2 tied across
    slab positions and across tiles (repeated points on an exact grid, a
    tile listed twice in a slab), slabs with fewer than k valid targets,
    tile ids -1 and T, masked queries, k in {1, 20, 32}, cand_tile in
    {128, 256}, the exact search (every tile a candidate) and a street-scale
    cloud whose d^2 rounds.  1,024 queries (4 query tiles of 256) against
    2,048 targets.  Returns a list of dicts: name, query, qmask, target,
    tmask (numpy), cidx ((4, C) int32), k, cand_tile, `in_range` (every
    tile id is in [0, T): the JAX package's `knn_slab_pallas` gathers other
    ids by its own rules) and `exact_d2` (grid points: every d^2 is exact)."""
    rng = np.random.default_rng(seed)
    nq, nt = 1024, 2048
    tgt = _grid_points(rng, nt, 400)
    qry = np.concatenate([tgt[rng.integers(0, nt, nq // 2)], _grid_points(rng, nq // 2, 400)])
    street = _street_points(rng, nt)
    cases = []

    def add(name, k, ct, C, query=qry, target=tgt, qmask=None, tmask=None, cidx=None,
            exact_d2=True):
        T = nt // ct
        if cidx is None:
            cidx = np.stack([rng.permutation(T)[:C] for _ in range(nq // 256)])
            cidx[0, -1] = cidx[0, 0]  # a tile listed twice: ties across tiles
        cases.append(dict(
            name=name, query=query, target=target,
            qmask=np.ones(nq, bool) if qmask is None else qmask,
            tmask=_mask(rng, nt, 0.1) if tmask is None else tmask,
            cidx=np.ascontiguousarray(cidx, np.int32), k=k, cand_tile=ct,
            in_range=bool(((cidx >= 0) & (cidx < T)).all()), exact_d2=exact_d2))

    add("ties_k20_ct256", 20, 256, 4)
    add("ties_k32_ct128_masked_queries", 32, 128, 6, qmask=_mask(rng, nq, 0.15))
    few = np.zeros(nt, bool)
    few[rng.choice(nt, 40, replace=False)] = True  # ~2.5 valid a 128-point tile
    add("few_valid_k32_ct128", 32, 128, 3, tmask=few)
    add("k1_ct256_masked_queries", 1, 256, 2, qmask=_mask(rng, nq, 0.3))
    bad = np.stack([rng.permutation(8)[:4] for _ in range(nq // 256)])
    bad[:, 1], bad[1:, 3] = -1, 8  # ids -1 and T read as masked points
    add("tile_ids_out_of_range_k20_ct256", 20, 256, 4, cidx=bad)
    add("exact_k20_ct128", 20, 128, 16, cidx=np.tile(np.arange(16), (nq // 256, 1)))
    add("street_k20_ct256", 20, 256, 4, query=street[:nq], target=street, exact_d2=False)
    return cases


def _key_step_ties(rng, n_queries: int, n_targets: int):
    """(queries, targets): 64 cluster centres 10 m apart on integer
    coordinates, each with 10 targets at d^2 = 0.25 exactly (duplicates) and
    16 at d^2 = (1 + m 2^-16)^2, m = 0..15 (x offsets exact in f32, d^2 one
    rounding in every order), which all fall in one 2^-11 key step; far
    fillers complete the targets, shuffled; each query is a centre."""
    centres = np.stack(np.meshgrid(np.arange(8), np.arange(8), [0], indexing="ij"),
                       -1).reshape(-1, 3).astype(np.float32) * np.float32(10.0)
    near = np.float32([[0.5, 0, 0]] * 3 + [[-0.5, 0, 0]] * 3 + [[0, 0.5, 0]] * 2
                      + [[0, -0.5, 0]] * 2)
    step = np.zeros((16, 3), np.float32)
    step[:, 0] = 1.0 + np.arange(16, dtype=np.float32) * np.float32(2.0 ** -16)
    offsets = np.concatenate([near, step])
    cluster = (centres[:, None, :] + offsets[None]).reshape(-1, 3)
    fill = _grid_points(rng, n_targets - len(cluster), 500) + np.float32([0, 0, 200.0])
    targets = np.concatenate([cluster, fill]).astype(np.float32)
    queries = centres[rng.integers(0, len(centres), n_queries)]
    return queries, targets[rng.permutation(n_targets)]


def knn_moments_edge_cases(seed: int = 0):
    """Inputs for the fused k-NN moments (`ops.cuda_kernels.knn_moments`)
    that stress its packed-key selection and its edges, made from `seed`:
    candidates tied within one 2^-11 key step at the k-th place (the tie
    goes to the lower slab position), exact d^2 ties (repeated points on an
    exact grid), slabs with fewer than k valid targets, a query tile whose
    whole slab is masked, tile ids -1 and T, masked queries, k in {1, 20,
    32, 48} (k > 32 takes the kernel's round-by-round form) and 4,096-wide
    slabs (C = 32 x 128).  1,024 queries (4 query tiles of 256),
    cand_tile 128.  Returns a list of dicts: name, query, qmask, target,
    tmask (numpy), cidx ((4, C) int32), k, cand_tile, `in_range` (every tile
    id is in [0, T): the JAX package's `knn_moments_pallas` gathers other
    ids by its own rules) and `exact_d2` (every d^2 of a valid pair is
    exact, or rounded once, so XLA's contractions cannot move a key)."""
    rng = np.random.default_rng(seed)
    nq, ct = 1024, 128
    cases = []

    def add(name, k, C, query, target, qmask=None, tmask=None, cidx=None, exact_d2=True):
        T = len(target) // ct
        if cidx is None:
            cidx = np.stack([rng.permutation(T)[:C] for _ in range(nq // 256)])
        cases.append(dict(
            name=name, query=query, target=target,
            qmask=np.ones(nq, bool) if qmask is None else qmask,
            tmask=np.ones(len(target), bool) if tmask is None else tmask,
            cidx=np.ascontiguousarray(cidx, np.int32), k=k, cand_tile=ct,
            in_range=bool(((cidx >= 0) & (cidx < T)).all()), exact_d2=exact_d2))

    q_tie, t_tie = _key_step_ties(rng, nq, 2048)
    add("ties_within_key_step_k20", 20, 16, q_tie, t_tie,
        cidx=np.tile(np.arange(16), (nq // 256, 1)))
    grid = _grid_points(rng, 2048, 400)
    qgrid = np.concatenate([grid[rng.integers(0, 2048, nq // 2)],
                            _grid_points(rng, nq // 2, 400)])
    few = np.zeros(2048, bool)
    few[rng.choice(2048, 40, replace=False)] = True  # ~2.5 valid a 128-point tile
    add("few_valid_k20", 20, 4, qgrid, grid, tmask=few)
    tmask = _mask(rng, 2048, 0.1)
    tmask[:4 * ct] = False  # tiles 0-3 wholly masked: query tile 1's slab
    cidx = np.stack([rng.permutation(16)[:4] for _ in range(nq // 256)])
    cidx[1] = np.arange(4)
    add("all_masked_slab_k20", 20, 4, qgrid, grid, tmask=tmask, cidx=cidx)
    bad = np.stack([rng.permutation(16)[:6] for _ in range(nq // 256)])
    bad[:, 2], bad[1:, 4] = -1, 16  # ids -1 and T read as masked points
    add("tile_ids_out_of_range_k20", 20, 6, qgrid, grid, tmask=_mask(rng, 2048, 0.1),
        cidx=bad)
    add("k1_masked_queries", 1, 6, qgrid, grid, qmask=_mask(rng, nq, 0.2),
        tmask=_mask(rng, 2048, 0.1))
    add("k32_masked_queries", 32, 8, qgrid, grid, qmask=_mask(rng, nq, 0.15),
        tmask=_mask(rng, 2048, 0.1))
    add("k48_rounds", 48, 8, qgrid, grid, tmask=_mask(rng, 2048, 0.1))
    street = _street_points(rng, 4096)
    qstreet = street[rng.choice(4096, nq, replace=False)]
    wide = np.tile(np.arange(32), (nq // 256, 1))
    add("slab_4096_k20", 20, 32, qstreet, street, tmask=_mask(rng, 4096, 0.05), cidx=wide,
        exact_d2=False)
    add("slab_4096_k48", 48, 32, qstreet, street, tmask=_mask(rng, 4096, 0.05), cidx=wide,
        exact_d2=False)
    return cases


def _ladder_from_pairs(rng, y, mask, rungs: int, r2_max: float):
    """`rungs` distinct squared radii below r2_max, each the f32 d^2 of a
    pair of valid points of y, ascending: the pairs sit exactly on rungs."""
    d = _sq_dist_f32(y[mask][:256], y[mask])
    vals = np.unique(d[(d > 0) & (d < r2_max)])
    return np.sort(rng.choice(vals, rungs, replace=False)).astype(np.float32)


def radius_count_edge_cases(seed: int = 0):
    """Inputs for the adaptive-radius count (`ops.cuda_kernels.radius_count`)
    that put pairs exactly on rungs, made from `seed`: ladders built from
    chosen pairs' own f32 d^2 (centered coordinates, rounded as the kernels
    round), ascending, non-ascending with repeated rungs, L in {1, 20, 32},
    on a street-scale cloud whose d^2 rounds and on an exact grid, with
    masked targets and queries.  The query cloud is the target cloud
    (2,048 points, as the adaptive estimator calls it).  Returns a list of
    dicts: name, points, mask, center (numpy), r2 ((L,) f32), `ascending`
    (the JAX package's count pass culls by the last rung, so it shares the
    contract only for a non-decreasing ladder) and `exact_d2`."""
    rng = np.random.default_rng(seed)
    n = 2048
    cases = []

    def add(name, pts, mask, center, r2, exact_d2):
        cases.append(dict(name=name, points=pts, mask=mask, center=center,
                          r2=np.asarray(r2, np.float32),
                          ascending=bool((np.diff(r2) >= 0).all()), exact_d2=exact_d2))

    street = _street_points(rng, n)
    mask = _mask(rng, n, 0.05)
    center = street[mask].astype(np.float64).mean(0).astype(np.float32)
    y = street - center
    add("street_on_rungs_L20", street, mask, center, _ladder_from_pairs(rng, y, mask, 20, 36.0),
        exact_d2=False)

    grid = _grid_points(rng, n, 900)
    mask = _mask(rng, n, 0.1)
    center = np.float32([2.0, 2.0, 2.0])  # on the grid: centering stays exact
    y = grid - center
    ladder = _ladder_from_pairs(rng, y, mask, 24, 2.0)
    unsorted = rng.permutation(np.concatenate([ladder, rng.choice(ladder, 8)]))
    add("grid_unsorted_repeats_L32", grid, mask, center, unsorted, exact_d2=True)
    add("grid_repeats_L20", grid, mask, center,
        np.sort(np.concatenate([ladder[:14], rng.choice(ladder[:14], 6)])), exact_d2=True)
    add("grid_on_rung_L1", grid, mask, center, ladder[11:12], exact_d2=True)
    return cases


def radius_window_edge_cases(seed: int = 0):
    """Inputs for the hard-window moments (`ops.cuda_kernels.radius_window`)
    that stress the window test, the chunk cull and the sums, made from
    `seed`: r2q = 0 (exact duplicates only, the query itself included),
    windows exactly on pairs' d^2 among repeated points, the default
    ladder's largest rung beside its smallest in every warp of 32 queries,
    masked queries and targets, a query cloud other than the target with nq
    and nt not multiples of 32 or 128, and nt < 32.  Points on an exact
    1/8 m grid centered on a grid point (every d^2 exact), or street-scale
    ones whose d^2 rounds.  Returns a list of dicts: name, query, qmask,
    target, tmask, center (numpy), r2q ((nq,) f32), `jax` (the sizes the
    JAX package's `_window_kernel` takes: nq a multiple of 512, nt of
    2,048) and `exact_d2`."""
    rng = np.random.default_rng(seed)
    cases = []

    def add(name, query, target, center, r2q, qmask=None, tmask=None, exact_d2=True):
        nq, nt = len(query), len(target)
        cases.append(dict(
            name=name, query=query, target=target, center=np.asarray(center, np.float32),
            qmask=np.ones(nq, bool) if qmask is None else qmask,
            tmask=_mask(rng, nt, 0.1) if tmask is None else tmask,
            r2q=np.asarray(r2q, np.float32), jax=nq % 512 == 0 and nt % 2048 == 0,
            exact_d2=exact_d2))

    ladder = (0.04 * 1.3 ** np.arange(20)) ** 2  # the default ladder's rungs
    grid = _grid_points(rng, 2048, 300)
    on = np.float32([2.0, 2.0, 2.0])  # a grid point: centering stays exact
    add("r2q_zero_duplicates", grid, grid, on, np.zeros(2048))
    # squared distances of grid pairs: exact multiples of 1/64
    on_pair = np.float32([1, 2, 3, 5, 8, 13, 25, 41]) / np.float32(64.0)
    add("windows_on_pairs_duplicates", grid, grid, on, rng.choice(on_pair, 2048))
    street = _street_points(rng, 2048)
    center = street.astype(np.float64).mean(0).astype(np.float32)
    mixed = np.where(np.arange(2048) % 2 == 0, ladder[-1], ladder[0])
    add("largest_beside_smallest_in_warp", street, street, center, mixed, exact_d2=False)
    add("masked_queries_and_targets", grid, grid, on, rng.choice(ladder[:12], 2048),
        qmask=_mask(rng, 2048, 0.2), tmask=_mask(rng, 2048, 0.3))
    add("nq_nt_not_multiples_of_32", street[rng.choice(2048, 1000, replace=False)],
        street[:1500], center, rng.choice(ladder, 1000), exact_d2=False)
    add("nt_below_32", street[rng.choice(2048, 300, replace=False)], street[:20], center,
        np.full(300, ladder[-1]), exact_d2=False)
    return cases


def _far_points(rng, n: int, center, spread: float = 1.0):
    """n points in a 2 * spread cube about `center`, sorted along x."""
    pts = (np.asarray(center, np.float32)
           + (rng.random((n, 3)) * 2.0 - 1.0) * np.float32(spread)).astype(np.float32)
    return pts[np.argsort(pts[:, 0], kind="stable")]


def nn_search_edge_cases(seed: int = 0):
    """Inputs for the exact 1-NN search (`ops.cuda_kernels.nn_search`) that
    stress its tie rule, its cull and its edges, made from `seed`: d^2 tied
    across chunks and tiles (repeated points on an exact grid, queries at
    half-grid positions), every target masked, nt < 128 and nq, nt not
    multiples of 128 (or of 32), a block of 128 queries whose box touches no
    target chunk (its first pass lists nothing and its bound starts at
    +inf), a block of padding queries only, and street-scale queries 50 m
    from the cloud, whose d^2 rounds.  Returns a list of dicts: name, query,
    qmask, target, tmask (numpy), `jax` (the sizes the JAX package's
    `nn_search_pallas` takes: nq a multiple of 512, nt of 2,048, at least
    one valid target) and `exact_d2` (grid points: every d^2 is exact)."""
    rng = np.random.default_rng(seed)
    cases = []

    def add(name, query, target, qmask=None, tmask=None, exact_d2=False):
        nq, nt = len(query), len(target)
        qmask = np.ones(nq, bool) if qmask is None else qmask
        tmask = _mask(rng, nt, 0.1) if tmask is None else tmask
        cases.append(dict(name=name, query=query, qmask=qmask, target=target, tmask=tmask,
                          jax=nq % 512 == 0 and nt % 2048 == 0 and bool(tmask.any()),
                          exact_d2=exact_d2))

    grid = _grid_points(rng, 2048, 300)
    half = (_grid_points(rng, 2048, 600) + np.float32(1.0 / 16.0)).astype(np.float32)
    add("grid_ties_across_chunks", np.concatenate([grid[rng.permutation(2048)[:1024]],
                                                   half[:1024]]), grid, exact_d2=True)
    add("all_targets_masked", _grid_points(rng, 512, 200), grid,
        tmask=np.zeros(2048, bool), exact_d2=True)
    street = _street_points(rng, 2048)
    add("nt_below_128_ragged", street[rng.choice(2048, 300, replace=False)], street[:100])
    add("nq_nt_not_multiples_of_128", street[rng.choice(2048, 1000, replace=False)],
        street[:1500])
    far = np.concatenate([_far_points(rng, 128, [140.0, 60.0, 2.0]),
                          street[rng.choice(2048, 896, replace=False)]])
    add("block_touching_no_chunk", far, street)
    qmask = _mask(rng, 1024, 0.05)
    qmask[256:384] = False
    pad = street[rng.choice(2048, 1024, replace=False)].copy()
    pad[256:384] = 0.0  # padding rows, as `pad_points` leaves them
    add("padding_block", pad, street, qmask=qmask)
    add("street_queries_50m_off", (street[rng.choice(2048, 1024, replace=False)]
                                   + np.float32([170.0, 0.0, 0.0])).astype(np.float32), street)
    return cases


def rbf_moments_edge_cases(seed: int = 0):
    """Inputs for the RBF moments (`ops.cuda_kernels.rbf_moments`) that stress
    the range test and the cull, made from `seed`: pairs exactly at
    d^2 = max_dist^2 in f32 (points on an exact grid, centered on a grid
    point), masked targets inside the radius, a query cloud other than the
    target with nq != nt, nt < 128, a block of queries with nothing in
    range, and kernel width 0.  Returns a list of dicts: name, query, qmask,
    target, tmask, center (numpy), kernel_width, max_dist, `jax` (the sizes
    the JAX package's `rbf_cross_moments_centered_T` takes: nq a multiple of
    512, nt of 2,048) and `exact_d2`."""
    rng = np.random.default_rng(seed)
    cases = []

    def add(name, query, target, center, kernel_width, max_dist, qmask=None, tmask=None,
            exact_d2=True):
        nq, nt = len(query), len(target)
        cases.append(dict(
            name=name, query=query, target=target, center=np.asarray(center, np.float32),
            qmask=np.ones(nq, bool) if qmask is None else qmask,
            tmask=_mask(rng, nt, 0.1) if tmask is None else tmask,
            kernel_width=float(kernel_width), max_dist=float(max_dist),
            jax=nq % 512 == 0 and nt % 2048 == 0, exact_d2=exact_d2))

    grid = _grid_points(rng, 2048, 900)
    on = np.float32([2.0, 2.0, 2.0])  # a grid point: centering stays exact
    add("on_radius_1.5", grid, grid, on, 0.5, 1.5)  # d^2 = 2.25, e.g. (1.5, 0, 0)
    add("masked_targets_in_radius", grid, grid, on, 0.5, 3.0, tmask=_mask(rng, 2048, 0.4))
    add("cross_nq_ne_nt", _grid_points(rng, 1024, 500), grid, on, 0.5, 1.0,
        qmask=_mask(rng, 1024, 0.1))
    street = _street_points(rng, 2048)
    center = street.astype(np.float64).mean(0).astype(np.float32)
    add("nt_below_128", street[rng.choice(2048, 300, replace=False)], street[:100], center,
        0.5, 3.0, exact_d2=False)
    far = np.concatenate([_far_points(rng, 128, [150.0, 60.0, 2.0]), street[:896]])
    add("block_nothing_in_range", far, street, center, 0.5, 3.0, exact_d2=False)
    add("kernel_width_0", grid, grid, on, 0.0, 1.5)
    return cases


_DIRECT7 = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                     [0, 0, -1]], np.float32)


def _raw_ndt_rows(rng, corners, kinds, counts):
    """Raw NDT rows (L, 16) [corner (3), count, sum d (3), sum d d^T (6),
    valid 0, pad (2)] about each 1 m voxel's corner: `kinds` 0 a blob filling
    the voxel, 1 near-planar (z spread 1e-3 m), 2 coincident points (C = 0);
    count 0 leaves the voxel empty.  Sums in float64, stored as float32."""
    L, cap = len(kinds), int(max(counts.max(), 1))
    d = rng.random((L, cap, 3))
    d[kinds == 1, :, 2] = 0.5 + 1e-3 * rng.standard_normal((int((kinds == 1).sum()), cap))
    d[kinds == 2] = d[kinds == 2, :1]
    d *= (np.arange(cap)[None, :] < counts[:, None])[..., None]
    dd = np.einsum("lni,lnj->lij", d, d)
    rows = np.zeros((L, 16))
    rows[:, 0:3] = corners
    rows[:, 3] = counts
    rows[:, 4:7] = d.sum(1)
    rows[:, 7:13] = dd[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    return rows.astype(np.float32)


def ndt_kernel_edge_cases(seed: int = 0):
    """Inputs for the NDT linearize and error kernels (`ops.cuda_ndt`) that
    stress their edges, made from `seed`: L = K N not a multiple of 4 (the
    error kernel's vector width) nor of a block, L below one block, L = 1,
    every lane invalid, and a raw pack of near-planar voxels (an eigenvalue
    ~1e-6 below MIN_EIG), voxels of coincident points (C = 0) and empty
    voxels.  1 m voxels about the source points' DIRECT7 neighbours.
    Returns a list of dicts: name, p (3, N) source columns, ca (6, N)
    sym-6 source covariance columns, pack (K N, 16) raw rows with `valid`
    set where count > 6 and the source is valid, and offsets K."""
    rng = np.random.default_rng(seed)
    cases = []

    def add(name, n, k, kinds_p, valid_share=0.9, min_count=0):
        src = (rng.random((n, 3)) * 10.0 - 5.0).astype(np.float32)
        A = rng.normal(size=(n, 3, 3))
        covs = A @ np.swapaxes(A, 1, 2) * 0.01 + 0.01 * np.eye(3)
        ca = covs[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T.astype(np.float32)
        L = n * k
        corners = np.floor(np.tile(src, (k, 1)) + np.repeat(_DIRECT7[:k], n, axis=0))
        kinds = rng.choice(4, size=L, p=kinds_p)  # 3: empty
        counts = np.where(kinds == 3, 0, rng.integers(max(min_count, 1), 41, L))
        pack = _raw_ndt_rows(rng, corners, np.minimum(kinds, 2), counts)
        src_valid = np.tile(rng.random(n) < valid_share, k)
        pack[:, 13] = (src_valid & (counts > 6)).astype(np.float32)
        cases.append(dict(name=name, p=np.ascontiguousarray(src.T), ca=ca, pack=pack,
                          offsets=k))

    add("ragged_L_7007", 1001, 7, [0.5, 0.3, 0.1, 0.1])
    add("below_one_block_L_91", 13, 7, [0.6, 0.4, 0.0, 0.0])
    add("one_lane", 1, 1, [1.0, 0.0, 0.0, 0.0], valid_share=1.0, min_count=7)
    add("all_lanes_invalid", 512, 7, [0.5, 0.3, 0.1, 0.1], valid_share=0.0)
    add("near_planar_coincident_empty", 2048, 7, [0.2, 0.4, 0.2, 0.2])
    return cases


NDT_LOOKUP_CELL_MIN = (-6, -5, -4)  # ndt_lookup_edge_cases' grid: its first cell
NDT_LOOKUP_CELL_MAX = (5, 4, 3)  # ... and its last index on each axis


def _cell_points(rng, cell, count, res, planar=False):
    """`count` points strictly inside voxel `cell` (voxel_coord
    floor(p / res - 0.5) = cell), 5% of a voxel away from its faces; near-
    planar (z spread 1e-3 voxels) with `planar`."""
    u = 0.55 + 0.9 * rng.random((count, 3))
    if planar:
        u[:, 2] = 1.0 + 1e-3 * rng.standard_normal(count)
    return ((np.asarray(cell, np.float64) + u) * res).astype(np.float32)


def _split_faces(res, lo, hi):
    """Coordinates within a few float32 steps of a voxel face in cells
    lo..hi whose voxel_coord floor(p / res - 0.5) differs between the true
    float32 division and the product with f32(1 / res) (how ATen divides a
    CUDA tensor by a Python float)."""
    res32, inv = np.float32(res), np.float32(1.0 / res)
    base = ((np.arange(lo, hi + 1) + 0.5) * res).astype(np.float32)
    out = []
    for step in range(-4, 5):
        q = base.copy()
        for _ in range(abs(step)):
            q = np.nextafter(q, np.float32(np.inf if step > 0 else -np.inf))
        div = np.floor(q / res32 - np.float32(0.5))
        prod = np.floor(q * inv - np.float32(0.5))
        out.extend(q[div != prod].tolist())
    return np.asarray(out, np.float32)


def ndt_lookup_edge_cases(seed: int = 0):
    """Scenes for the NDT linearize's voxel lookup (`ops.cuda_ndt`'s lookup
    form) that stress its edges, made from `seed`: a target whose
    dense grid is exactly NDT_LOOKUP_CELL_MIN .. NDT_LOOKUP_CELL_MAX (dims
    given, negative coordinates), with occupied voxels on the grid's first
    cell and on its last index on each axis, voxels of exactly 6 points
    (below the > 6 gate) and 7 (just above it), a near-planar voxel and a
    spread of others; sources near those voxels (so the DIRECT7 offsets
    reach beyond the last index), in empty cells inside the grid, far
    outside it, masked ones and a zero-padded masked tail.  Two scenes: 1 m
    voxels, the paths' resolution, and 0.3 m with sources exactly on voxel
    faces, among them faces where the float32 division and the product with
    the reciprocal bin differently (`_split_faces`).  Returns a list of dicts: name, resolution, dims, target
    (M, 3), tmask (M,), source (N, 3), smask (N,), covs (N, 3, 3) source
    covariances for D2D; float32 points."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(NDT_LOOKUP_CELL_MIN), np.array(NDT_LOOKUP_CELL_MAX)
    dims = tuple(int(d) for d in hi - lo + 1)
    cases = []

    def add(name, res, on_faces):
        cells = [(lo, 20), (hi, 20), ((hi[0], 0, 0), 10), ((0, hi[1], 0), 10),
                 ((0, 0, hi[2]), 10), ((1, 1, 1), 6), ((2, 1, 1), 7)]
        special = np.array([c for c, _ in cells] + [(-2, 0, 0)])
        others = np.unique(lo + rng.integers(0, hi - lo + 1, (24, 3)), axis=0)
        others = others[~(others[:, None] == special[None]).all(-1).any(1)]
        cells += [(c, int(m)) for c, m in zip(others, rng.integers(1, 31, len(others)))]
        target = np.concatenate([_cell_points(rng, c, m, res) for c, m in cells]
                                + [_cell_points(rng, (-2, 0, 0), 15, res, planar=True)])
        tmask = np.ones(len(target), bool)
        occupied = np.array([c for c, _ in cells] + [(-2, 0, 0)])
        near = np.concatenate([_cell_points(rng, c, 6, res) for c in occupied])
        empty = np.array([c for c in lo + rng.integers(0, hi - lo + 1, (200, 3))
                          if not (c == occupied).all(1).any()][:40])
        inside_empty = np.concatenate([_cell_points(rng, c, 2, res) for c in empty])
        far = ((rng.random((40, 3)) - 0.5) * 80.0 * res
               + np.where(rng.random((40, 1)) < 0.5, 60.0, -60.0) * res).astype(np.float32)
        parts = [near, inside_empty, far]
        if on_faces:
            # sources exactly on the lower face of a voxel along one axis
            faces = near[:60].copy()
            axis = rng.integers(0, 3, 60)
            cell = np.floor(faces[np.arange(60), axis] / res - 0.5)
            faces[np.arange(60), axis] = ((cell + 0.5) * res).astype(np.float32)
            split = np.concatenate([_split_faces(res, lo[a], hi[a]) for a in range(3)])
            axes = np.concatenate([np.full(len(_split_faces(res, lo[a], hi[a])), a)
                                   for a in range(3)])
            on_split = near[rng.integers(0, len(near), len(split))].copy()
            on_split[np.arange(len(split)), axes] = split
            parts += [faces, on_split]
        src = np.concatenate(parts).astype(np.float32)
        smask = rng.random(len(src)) < 0.9
        pad = (-len(src)) % 64 + 64
        source = np.concatenate([src, np.zeros((pad, 3), np.float32)])
        smask = np.concatenate([smask, np.zeros(pad, bool)])
        A = rng.normal(size=(len(source), 3, 3))
        covs = (A @ np.swapaxes(A, 1, 2) * 0.01 * res * res
                + 0.01 * res * res * np.eye(3)).astype(np.float32)
        cases.append(dict(name=name, resolution=res, dims=dims, target=target, tmask=tmask,
                          source=source, smask=smask, covs=covs))

    add("unit_voxels", 1.0, on_faces=False)
    add("res_0.3_on_faces", 0.3, on_faces=True)
    return cases


def _small_pose(rng, angle: float = 0.05, shift: float = 0.2):
    """A 4x4 float32 pose: a rotation by up to `angle` rad about a random
    axis (Rodrigues, in float64) and a shift of up to `shift` m an axis."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    a = rng.uniform(-angle, angle)
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(a) * K + (1.0 - np.cos(a)) * K @ K
    T[:3, 3] = rng.uniform(-shift, shift, 3)
    return T.astype(np.float32)


LINEARIZE_GRID_STRIDE_LANES = 157_696  # 7 x 22,528: beyond one wave of every design


def linearize_edge_cases(seed: int = 0, grid_stride: bool = True):
    """Inputs for the GICP/VGICP linearize kernels (`ops.cuda_linearize`)
    that stress their edges, made from `seed`: L = 1,001 (not a multiple of
    4, 128 or 256), L = 91 (below one block) and L = 1; L = 157,696, a
    grid-stride loop on every design's grid (left out with
    `grid_stride=False`); every lane invalid or on a miss row; a singular
    C_B + R C_A R^T (C_B = diag(1, 1, 0), C_A = 0: the determinant clamp);
    and repeated ids (4,096 lanes on 3 rows).  Each case is a dict: name,
    p (3, L) source columns, ca (6, L) sym-6 source covariance columns,
    x (4, 4), raw (T, 16) raw voxel rows [count, sum mu (3), sum cov9, pad]
    with about a tenth misses (count 0), fin (T, 16) the same statistics as
    finalized rows [mu (3), cov9, count > 0, pad] (zeros on a miss), ids
    (L,) int64 in [0, T) and valid (L,) float32."""
    rng = np.random.default_rng(seed)
    cases = []

    def add(name, L, T, valid_share=0.9, singular=False, only_misses_valid=False):
        p = (rng.normal(size=(3, L)) * 5.0).astype(np.float32)
        A = rng.normal(size=(L, 3, 3))
        covs_a = A @ np.swapaxes(A, 1, 2) * 0.01 + 0.01 * np.eye(3)
        mu = rng.normal(size=(T, 3)) * 5.0
        B = rng.normal(size=(T, 3, 3))
        covs_b = B @ np.swapaxes(B, 1, 2) * 0.01 + 0.01 * np.eye(3)
        if singular:
            covs_a[:] = 0.0
            covs_b[:] = np.diag([1.0, 1.0, 0.0])
        count = rng.integers(1, 20, T).astype(np.float64)
        count[rng.random(T) < 0.1] = 0.0
        hit = (count > 0)[:, None]
        raw = np.concatenate([count[:, None], mu * count[:, None],
                              covs_b.reshape(T, 9) * count[:, None], np.zeros((T, 3))], axis=1)
        fin = np.concatenate([mu * hit, covs_b.reshape(T, 9) * hit, hit, np.zeros((T, 3))],
                             axis=1)
        ids = rng.integers(0, T, L)
        valid = rng.random(L) < valid_share
        if only_misses_valid:
            valid &= count[ids] == 0
        ca = covs_a[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T
        cases.append(dict(name=name, p=p, ca=np.ascontiguousarray(ca, np.float32),
                          x=_small_pose(rng), raw=raw.astype(np.float32),
                          fin=fin.astype(np.float32), ids=ids.astype(np.int64),
                          valid=valid.astype(np.float32)))

    add("ragged_L_1001", 1001, 500)
    add("below_one_block_L_91", 91, 40)
    add("one_lane", 1, 1, valid_share=1.0)
    if grid_stride:
        add("grid_stride_L_157696", LINEARIZE_GRID_STRIDE_LANES, 22_528)
    add("all_invalid_or_miss", 2048, 700, valid_share=0.5, only_misses_valid=True)
    add("singular", 2048, 700, singular=True)
    add("repeated_ids", 4096, 3)
    return cases
