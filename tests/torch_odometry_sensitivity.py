"""How far the odometry paths' poses move when their covariance moments
are rounded differently.

The covariance kernels sum moments about a centre (RBF: the cloud's mean;
kNN: each query tile's first point) and the finalize E[y y^T] - mean
mean^T cancels most of their digits, so two devices that add the same
terms in another order reach other covariances.  This script runs the
first 8 frames of the small odometry drive (`drive_world(n=400_000)` of
seed 11, `drive_scans`, 0.5 m host downsample: the drive `chip_smoke.py`
holds the card against the CPU on) through each path with
`device` ("cpu" by default), once as it is and once for each `eps` with
every moment the covariance kernel returns multiplied by (1 + eps u), u
uniform in [-1, 1] from a seeded generator, and prints the largest
per-frame pose difference (max |T - T_ref| over the 4x4 entries) a path
and eps.  RBF paths: odometry_stream, odometry_scan, scan_to_map; kNN:
odometry_serial.

    python tests/torch_odometry_sensitivity.py [--device cuda] [--eps 1e-7 1e-6 1e-5]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from fast_gicp_tpu_torch.models.scan_to_map import ScanToMapConfig, ScanToMapOdometry
from fast_gicp_tpu_torch.models.vgicp import FastVGICP, VGICPConfig
from fast_gicp_tpu_torch.ops import cuda_kernels
from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims_multi
from fast_gicp_tpu_torch.utils import kitti
from fast_gicp_tpu_torch.utils.downsample import voxel_downsample
from fast_gicp_tpu_torch.utils.synthetic import drive_scans, drive_world

PATHS = {"odometry_stream": "rbf_moments", "odometry_scan": "rbf_moments",
         "scan_to_map": "rbf_moments", "odometry_serial": "knn_moments"}


def small_drive(frames=8):
    """The clouds and the dense grid of chip_smoke.py's small drive."""
    rng = np.random.default_rng(11)
    scans, _gt = drive_scans(rng, n_frames=frames, world=drive_world(rng, n=400_000))
    return [voxel_downsample(s, 0.5) for s in scans], auto_grid_dims_multi(scans, 1.0)


def run(path, clouds, dims, device):
    """The path's poses over `clouds`, built as chip_smoke.py builds it."""
    cfg = VGICPConfig(resolution=1.0, grid_dims=dims)
    if path == "odometry_serial":
        return kitti.run_odometry(clouds, FastVGICP(resolution=1.0, device=device), -1.0)
    if path == "odometry_stream":
        return kitti.run_odometry_stream(clouds, -1.0, config=cfg, device=device)
    if path == "odometry_scan":
        return kitti.run_odometry_scan(clouds, -1.0, config=cfg, device=device)
    odo = ScanToMapOdometry(ScanToMapConfig(), device=device)
    odo.process_chunk(clouds)
    return odo.poses


def perturbed(name, eps, seed=0):
    """The covariance kernel `name` with its moments multiplied by
    (1 + eps u)."""
    real = getattr(cuda_kernels, name)
    gen = {}

    @functools.wraps(real)
    def kernel(*args, **kwargs):
        out = real(*args, **kwargs)
        mom = out[0] if isinstance(out, tuple) else out
        g = gen.setdefault(mom.device, torch.Generator(device=mom.device).manual_seed(seed))
        u = 2 * torch.rand(mom.shape, generator=g, device=mom.device) - 1
        mom = mom * (1 + eps * u)
        return (mom,) + tuple(out[1:]) if isinstance(out, tuple) else mom

    return kernel


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-6, 1e-5])
    args = ap.parse_args()
    clouds, dims = small_drive()
    out = {}
    for path, name in PATHS.items():
        ref = run(path, clouds, dims, args.device)
        real = getattr(cuda_kernels, name)
        out[path] = {}
        for eps in args.eps:
            setattr(cuda_kernels, name, perturbed(name, eps))
            try:
                got = run(path, clouds, dims, args.device)
            finally:
                setattr(cuda_kernels, name, real)
            out[path][eps] = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    print(json.dumps({"device": args.device, "points": [len(c) for c in clouds],
                      "max_pose_diff": out}))


if __name__ == "__main__":
    main()
