"""Static-shape padding for point clouds.

XLA compiles one executable per shape; clouds are padded up to bucket
multiples so repeated aligns of similar-size scans hit the jit cache.  The
mask rides along everywhere; masked lanes contribute exact zeros in every
kernel (the fixed-shape replacement for the reference's `remove_if`
compaction, find_voxel_correspondences.cu:109-110).
"""

from __future__ import annotations

import numpy as np

DEFAULT_BUCKET = 2048


def bucket_size(n: int, bucket: int = DEFAULT_BUCKET) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def pad_points(points: np.ndarray, bucket: int = DEFAULT_BUCKET):
    """Pad (N, 3) float array to a bucket multiple; returns (padded, mask).

    Padded coordinates are zero; every consumer must honor the mask.
    """
    points = np.ascontiguousarray(points[:, :3], dtype=np.float32)
    n = points.shape[0]
    m = bucket_size(n, bucket)
    out = np.zeros((m, 3), dtype=np.float32)
    out[:n] = points
    mask = np.zeros(m, dtype=bool)
    mask[:n] = True
    return out, mask
