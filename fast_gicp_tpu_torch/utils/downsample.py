"""Voxel-grid downsampling (host-side numpy).

Equivalent of pcl::ApproximateVoxelGrid / pcl::VoxelGrid as used by the
reference apps and tests (align.cpp:30-36 res 0.1, kitti.cpp:79-84 res 0.25,
gicp_test.cpp:36-44 res 0.2, python main.cpp:46-62): one output point per
occupied voxel at the centroid of its members.  Exact (hash-collision-free),
which the "Approximate" PCL variant is not — point counts can differ by a
few points; registration results are insensitive to this.

A copy of `fast_gicp_tpu.utils.downsample` (the port never imports the
JAX package).  `voxel_downsample` takes the native library's filter when
it is built (`native.voxel_downsample`, bit-equal), else numpy; its output
is voxel-key sorted, the order the RBF kernel's tile culling relies on.
"""

from __future__ import annotations

import numpy as np


def approximate_voxel_downsample(
    points: np.ndarray, resolution: float, histsize: int = 1536
) -> np.ndarray:
    """PCL `ApproximateVoxelGrid`-compatible downsample (vectorized).

    The reference's apps and Python bindings filter through
    pcl::ApproximateVoxelGrid (align.cpp:30-36, python/main.cpp:46-62),
    whose output differs from an exact per-voxel centroid: it streams
    points through a FIXED-SIZE hash of `histsize` accumulators with no
    collision resolution — whenever a point maps to a bucket currently
    holding a DIFFERENT voxel, the bucket's running centroid is flushed to
    the output and restarted.  One output point per maximal run of
    same-voxel hits per bucket (order-dependent), plus the final flush.

    Emulated vectorized: group points by (bucket, file order), split runs
    where the voxel id changes between consecutive hits of the same
    bucket, and take run centroids.  PCL semantics: coords =
    floor(p * 1/leaf), bucket = ((ix * 7171 + iy) * 3079 + iz) cast to
    unsigned, modulo histsize.  With histsize=1536 this reproduces the
    reference benchmark's post-filter counts on the bundled pair to
    within 0.5% (17338/17570 vs the published 17249/17518,
    README.md:116).

    The residual +89/+52 point delta is characterized (not just waved
    at).  Output count = exact voxel count (15772/15949 on this pair) +
    collision splits (runs broken by a different voxel evicting the
    bucket).  Sweeping the free parameters of the emulation brackets the
    published counts but never hits them:

      histsize   512    1024   1536   2048   3072   4096   exact
      target    20823  20353  17338  16803  17190  15916  15772
      source    21435  20885  17570  16789  17372  16166  15949
      published: 17249 / 17518 (between our 1536 and 3072 rows)

    Why exact reproduction is impossible offline, measured on the
    bundled pair (no PCL checkout ships in this environment):

    * float32-multiply (PCL computes floor(p * (1/leaf)) with the f32
      reciprocal 9.99999985) vs our float64-divide coords shifts counts
      by at most 1 point — not the explanation.
    * the bundled PCDs contain no non-finite points after the
      near-origin strip, so PCL's NaN-cast behavior is moot here.
    * adding a constant to the hash permutes bucket ids without changing
      any collision: counts are INVARIANT (emulation structure check).
    * but perturbing the hash multipliers at the SAME histsize=1536
      (7171->7177: 17463/17610; 3079->3083: 16829/17062; 7187/3109:
      16207/16266) scatters counts over a +-1300 range.  The -88/-52
      residual to the published counts is therefore deep inside the
      sensitivity to hash details (constants, promotion width, table
      size) of the exact 2019 PCL build — unrecoverable without that
      binary, and an order of magnitude smaller than the count changes
      any neighboring hash variant produces.

    The impact is bounded by tests: fitness at the ground-truth pose and
    the converged-optimality check (tests/test_registration.py
    test_fitness_parity_on_pcl_compatible_downsample) pin that
    registration quality is insensitive to this count-level divergence,
    test_fitness_sensitivity_to_collision_splits shows the published
    0.204067 is within the spread produced by collision-split variation
    alone, and tests/test_io.py test_approximate_downsample_counts_pinned
    freezes this emulation's exact counts on the bundled pair.
    """
    if resolution is None or resolution <= 0:
        return np.ascontiguousarray(points[:, :3], dtype=np.float32)
    pts = np.asarray(points[:, :3], dtype=np.float64)
    pts = pts[np.isfinite(pts).all(axis=1)]
    n = len(pts)
    if n == 0:
        return np.zeros((0, 3), np.float32)
    c = np.floor(pts / resolution).astype(np.int64)
    ix, iy, iz = c[:, 0], c[:, 1], c[:, 2]
    # int32 wraparound like the C++ expression, then unsigned modulo
    h = ((ix * 7171 + iy) * 3079 + iz).astype(np.int32).astype(np.int64)
    bucket = np.mod(h.astype(np.uint64), np.uint64(histsize)).astype(np.int64)

    order = np.lexsort((np.arange(n), bucket))  # by bucket, stable in time
    b_s = bucket[order]
    same_bucket = np.concatenate([[False], b_s[1:] == b_s[:-1]])
    same_voxel = np.concatenate(
        [[False], np.all(c[order][1:] == c[order][:-1], axis=1)]
    )
    new_run = ~(same_bucket & same_voxel)
    run_id = np.cumsum(new_run) - 1
    n_runs = run_id[-1] + 1
    sums = np.zeros((n_runs, 3), np.float64)
    np.add.at(sums, run_id, pts[order])
    counts = np.bincount(run_id, minlength=n_runs).astype(np.float64)
    out = (sums / counts[:, None]).astype(np.float32)
    # Normalize the OUTPUT ORDER to voxel-key sorted: PCL emits centroids
    # in hash-flush order (spatially scrambled), but order carries no
    # semantics downstream, and the TPU RBF kernel's tile-pair culling
    # depends on spatial locality within tiles (sorted clouds skip 70-85%
    # of distance tiles).
    oc = np.floor(out.astype(np.float64) / resolution).astype(np.int64)
    oc -= oc.min(axis=0)
    key = (oc[:, 0] << 42) | (oc[:, 1] << 21) | oc[:, 2]
    return out[np.argsort(key, kind="stable")]


def voxel_downsample(points: np.ndarray, resolution: float,
                     channels: np.ndarray = None):
    """Centroid-per-voxel downsample of (N, 3) points; resolution <= 0 is a
    passthrough (align_points' downsample_resolution=-1 convention,
    python/main.cpp:70-76).

    channels: optional (N, C) per-point payload (intensity/RGB/normals —
    the reference's PointXYZI/PointXYZRGB/PointNormal instantiations,
    fast_gicp.cpp:1-6); averaged per voxel and returned as a second
    array."""
    if resolution is None or resolution <= 0:
        out = np.ascontiguousarray(points[:, :3], dtype=np.float32)
        if channels is not None:
            return out, np.asarray(channels, np.float32)
        return out
    if channels is None:
        # the native filter computes the same floor(p / res), float64 sums
        # in point order and key-sorted output, bit for bit, about twice as
        # fast: host work on every frame of the odometry drivers
        from .. import native

        if native.available():
            p32 = np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)
            finite = np.isfinite(p32).all(axis=1)
            if not finite.all():  # NaN/inf would poison the voxel keys
                p32 = np.ascontiguousarray(p32[finite])
            if len(p32) == 0:
                return np.zeros((0, 3), np.float32)
            return native.voxel_downsample(p32, resolution)
    pts = np.asarray(points[:, :3], dtype=np.float64)
    finite = np.isfinite(pts).all(axis=1)  # NaN/inf returns poison keys
    pts = pts[finite]
    if channels is not None:
        ch = np.asarray(channels, np.float64)[finite]
    if len(pts) == 0:
        empty = np.zeros((0, 3), np.float32)
        if channels is not None:
            return empty, np.zeros((0, channels.shape[1]), np.float32)
        return empty
    coords = np.floor(pts / resolution).astype(np.int64)
    cmin = coords.min(axis=0)
    c = coords - cmin
    if int(c.max(initial=0)) < (1 << 21):
        # Pack 3x21-bit (re-based) coords into one int64 key for np.unique.
        key = (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
    else:
        # span exceeds 21 bits/axis: exact (slower) row-wise unique
        uniq, inv = np.unique(c, axis=0, return_inverse=True)
        # numpy 2.0.x returns a 2-D inverse from axis-unique; flatten so
        # add.at/bincount index correctly on every numpy version.
        inv = np.asarray(inv).reshape(-1)
        uniq = np.arange(len(uniq))
    sums = np.zeros((uniq.shape[0], 3), dtype=np.float64)
    np.add.at(sums, inv, pts)
    counts = np.bincount(inv, minlength=uniq.shape[0]).astype(np.float64)
    out = (sums / counts[:, None]).astype(np.float32)
    if channels is not None:
        csums = np.zeros((uniq.shape[0], ch.shape[1]), np.float64)
        np.add.at(csums, inv, ch)
        return out, (csums / counts[:, None]).astype(np.float32)
    return out
