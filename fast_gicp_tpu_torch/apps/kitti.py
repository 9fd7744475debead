"""KITTI odometry app on the port: frame-by-frame registration over a
velodyne sequence (the twin of the JAX package's `apps/kitti.py`, the
reference's `gicp_kitti`, src/kitti.cpp:71-156).

Loads %06d.bin scans, downsamples them (0.25 m), runs odometry, reports
FPS and writes the trajectory as KITTI 3x4 row-major lines.  Modes:
  --mode serial   the reference's loop with covariance reuse by the swap
                  (`FastVGICP`, kNN covariances, the auto dense grid)
  --mode stream   device-chained serial: every align enqueued with the
                  previous delta as its warm start, one read at the end
                  (the default)
  --mode scan     the whole sequence from one int16 upload
  --mode map      scan-to-map odometry on a persistent world voxel map
--device selects the device (CUDA unless `--device cpu`).

Usage: python -m fast_gicp_tpu_torch.apps.kitti /path/to/sequences/00/velodyne [--limit N]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("data_dir", help="directory of KITTI .bin scans")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--mode", choices=("serial", "stream", "scan", "map"),
                        default="stream")
    parser.add_argument("--downsample", type=float, default=0.25)
    parser.add_argument("--resolution", type=float, default=1.0)
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "traj.txt"),
                        help="trajectory file (default: traj.txt in the temp directory)")
    parser.add_argument(
        "--eviction-radius", type=float, default=None, metavar="M",
        help="(--mode map) bound map memory on long drives: every --evict-every "
        "frames drop voxels farther than this many meters from the current pose "
        "(default: keep full history)")
    parser.add_argument("--evict-every", type=int, default=64)
    parser.add_argument("--plot", default=None, metavar="PNG",
                        help="save a top-down trajectory plot (matplotlib)")
    parser.add_argument("--device", default="cuda",
                        help="device to run on (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)

    from fast_gicp_tpu_torch.models.vgicp import FastVGICP, VGICPConfig
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims_multi
    from fast_gicp_tpu_torch.utils.downsample import voxel_downsample
    from fast_gicp_tpu_torch.utils.io import load_kitti_bin
    from fast_gicp_tpu_torch.utils.kitti import (
        kitti_scan_paths, run_odometry, run_odometry_scan, run_odometry_stream,
        save_poses_kitti,
    )

    paths = kitti_scan_paths(args.data_dir, args.limit)
    if len(paths) < 2:
        print(f"no scans found under {args.data_dir}", file=sys.stderr)
        return 1
    print(f"{len(paths)} scans", flush=True)
    scans = [load_kitti_bin(p) for p in paths]

    t0 = time.perf_counter()
    if args.mode == "serial":
        reg = FastVGICP(resolution=args.resolution, device=args.device)

        def progress(i, pose, fps):
            if i % 30 == 0:
                print(f"frame {i}: fps={fps:.1f}", flush=True)

        poses = run_odometry(scans, reg, args.downsample, progress)
    elif args.mode == "map":
        from fast_gicp_tpu_torch.models.scan_to_map import ScanToMapConfig, ScanToMapOdometry

        odo = ScanToMapOdometry(
            ScanToMapConfig(resolution=args.resolution, eviction_radius=args.eviction_radius,
                            evict_every=args.evict_every),
            device=args.device)
        clouds = [voxel_downsample(s, args.downsample) for s in scans]
        for lo in range(0, len(clouds), 32):  # chunks of 32 frames
            odo.process_chunk(clouds[lo:lo + 32])
        poses = odo.poses  # the one read
    else:
        # a dense grid over the union of every frame's extent (a sequence that
        # opens up later must not be clipped)
        config = VGICPConfig(resolution=args.resolution,
                             grid_dims=auto_grid_dims_multi(scans, args.resolution))
        run = run_odometry_scan if args.mode == "scan" else run_odometry_stream
        poses = run(scans, args.downsample, config=config, device=args.device)
    dt = time.perf_counter() - t0
    print(f"{len(poses)} poses in {dt:.1f}s = {len(poses) / dt:.1f} FPS "
          f"(incl. I/O and downsampling)", flush=True)
    save_poses_kitti(args.out, poses)
    print(f"trajectory written to {args.out}")
    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available; skipping plot", file=sys.stderr)
            return 0
        import numpy as np

        xy = np.asarray([[T[0, 3], T[1, 3]] for T in poses])
        plt.figure(figsize=(6, 6))
        plt.plot(xy[:, 0], xy[:, 1], lw=1)
        plt.axis("equal")
        plt.grid(True, alpha=0.3)
        plt.title(f"trajectory ({len(poses)} frames)")
        plt.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"plot written to {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
