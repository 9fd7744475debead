#!/usr/bin/env python3
"""Benchmark/demo app on the port: align two PCD files with every
algorithm (the twin of the JAX package's `apps/align.py`, the reference's
`gicp_align`, src/align.cpp:22-215).

Loads two clouds, strips near-origin points, downsamples at 0.1 m, then
benchmarks each method three ways -- a single align, N repeated aligns
(fresh covariances each time) and N aligns reusing covariances through
swap_source_and_target -- printing milliseconds and fitness like the
reference README's table.  --device selects the device (CUDA unless
`--device cpu`, which runs the kernels' plain versions).

--device-loop adds the N aligns as device-resident rows: on CUDA each
row's trip (jitter, covariances, map build and the whole LM solve) is
captured once as a CUDA graph whose loops are conditional WHILE nodes
(`graphs`), and replayed N times with the jitter copied in on the device
and nothing read back until the row's end -- the counterpart of the JAX
package's one `lax.scan` a row.  On the CPU the same bodies run in a host
loop.

Usage:
  python -m fast_gicp_tpu_torch.apps.align [target.pcd source.pcd] [--n 100]
      [--methods ...] [--device cpu]
Defaults to the bundled reference pair's paths.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_methods(args):
    """name -> a factory of the method's class-API instance on args.device:
    fgicp, vgicp, vgicp_rbf, ndt_d2d, ndt_p2d (the root app's five);
    `args.methods` keeps a subset and an unknown name raises SystemExit
    with the available list."""
    from fast_gicp_tpu_torch import FastGICP, FastVGICP, NDTCuda

    device = getattr(args, "device", "cuda")
    methods = {}
    methods["fgicp"] = lambda: FastGICP(device=device)
    methods["vgicp"] = lambda: FastVGICP(device=device)

    def vgicp_rbf():
        reg = FastVGICP(device=device)
        reg.set_nearest_neighbor_method("rbf")
        return reg

    methods["vgicp_rbf"] = vgicp_rbf

    def ndt_d2d():
        reg = NDTCuda(device=device)
        reg.set_resolution(1.0)
        return reg

    methods["ndt_d2d"] = ndt_d2d

    def ndt_p2d():
        reg = NDTCuda(device=device)
        reg.set_distance_mode("p2d")
        reg.set_resolution(1.0)
        return reg

    methods["ndt_p2d"] = ndt_p2d
    if args.methods:
        unknown = set(args.methods) - set(methods)
        if unknown:
            raise SystemExit(
                f"unknown methods {sorted(unknown)}; available: {sorted(methods)}"
            )
        methods = {k: v for k, v in methods.items() if k in args.methods}
    return methods


def jitters(n):
    """(n, 4, 4) float32 rigid jitters: se3_exp of 1e-5 times standard
    normal twists from `default_rng(0)` (the root app's)."""
    import torch

    from fast_gicp_tpu_torch import se3

    rng = np.random.default_rng(0)
    twists = 1e-5 * rng.standard_normal((n, 6)).astype(np.float32)
    return np.stack([se3.se3_exp(torch.as_tensor(t)).numpy() for t in twists])


def device_bodies(source, target, device="cuda", max_source_voxels=2048):
    """The device-loop rows' bodies, name -> (fresh, reuse): each a function
    of a (4, 4) float32 jitter J on `device` returning the align's
    `LsqResult`, composed from the port's public functions with the root
    app's configs (apps/align.py:97-228).  Fresh re-estimates the
    covariances every trip; reuse rotates precomputed ones (kNN, RBF), and
    NDT's reuse builds the target once (`ndt_prepare_cloud`) and each trip
    only the source's compact statistics.  `max_source_voxels`: the NDT
    source budget (the root app's 2,048)."""
    import torch

    from fast_gicp_tpu_torch import device as _device
    from fast_gicp_tpu_torch.models.gicp import GICPConfig, gicp_align
    from fast_gicp_tpu_torch.models.ndt import (
        NDTConfig, ndt_align, ndt_align_prebuilt, ndt_prepare_cloud,
    )
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig, vgicp_align, vgicp_register
    from fast_gicp_tpu_torch.ops.covariance import (
        adaptive_radius_covariance_cols, knn_covariance_cols, knn_covariances, rbf_covariances,
    )
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims, build_ndt_grid_compact
    from fast_gicp_tpu_torch.utils.padding import pad_points

    dev = _device.resolve(device)
    sp, sm = (torch.as_tensor(a, device=dev) for a in pad_points(source))
    tp, tm = (torch.as_tensor(a, device=dev) for a in pad_points(target))
    dims = auto_grid_dims(target, 1.0)
    # NDT D2D builds a source voxel map too: the grid spans both extents
    ndims = auto_grid_dims(np.concatenate([source, target]), 1.0)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    vcfg = VGICPConfig(grid_dims=dims, refresh_iterations=2)
    gcfg = GICPConfig(refresh_iterations=2)
    ncfg_d2d = NDTConfig(resolution=1.0, grid_dims=ndims, refresh_iterations=3,
                         max_source_voxels=max_source_voxels)
    ncfg_p2d = ncfg_d2d._replace(distance_mode="p2d", refresh_iterations=3)

    scovs_rbf = rbf_covariances(sp, sm, device=dev)
    tcovs_rbf = rbf_covariances(tp, tm, device=dev)
    scovs_knn = knn_covariances(sp, sm, device=dev)
    tcovs_knn = knn_covariances(tp, tm, device=dev)

    def moved(J):
        R, t = J[:3, :3], J[:3, 3]
        return sp @ R.T + t, tp @ R.T + t

    def rot_covs(J, covs):
        R = J[:3, :3]
        return torch.einsum("ij,njk,lk->nil", R, covs, R)

    def fgicp_fresh(J):
        sj, tj = moved(J)
        return gicp_align(sj, sm, knn_covariance_cols(sj, sm), tj, tm,
                          knn_covariance_cols(tj, tm), eye, gcfg, device=dev)

    def fgicp_reuse(J):
        sj, tj = moved(J)
        return gicp_align(sj, sm, rot_covs(J, scovs_knn), tj, tm, rot_covs(J, tcovs_knn),
                          eye, gcfg, device=dev)

    def vgicp_fresh(J):
        sj, tj = moved(J)
        return vgicp_align(sj, sm, knn_covariance_cols(sj, sm), tj, tm,
                           knn_covariance_cols(tj, tm), eye, vcfg, device=dev)

    def vgicp_reuse(J):
        sj, tj = moved(J)
        return vgicp_align(sj, sm, rot_covs(J, scovs_knn), tj, tm, rot_covs(J, tcovs_knn),
                           eye, vcfg, device=dev)

    def vgicp_rbf_fresh(J):
        sj, tj = moved(J)
        return vgicp_register(sj, sm, tj, tm, eye, vcfg, device=dev)

    def vgicp_rbf_reuse(J):
        sj, tj = moved(J)
        return vgicp_align(sj, sm, rot_covs(J, scovs_rbf), tj, tm, rot_covs(J, tcovs_rbf),
                           eye, vcfg, device=dev)

    def ndt_body(cfg):
        def body(J):
            sj, tj = moved(J)
            return ndt_align(sj, sm, tj, tm, eye, cfg, device=dev)
        return body

    def ndt_reuse_body(cfg):
        # the reference's per-cloud map cache (ndt_cuda.cu:70-93): the
        # target's map is built once; a trip re-observes only the source
        tvm, _, tcen = ndt_prepare_cloud(tp, tm, cfg, device=dev)

        def body(J):
            sj = sp @ J[:3, :3].T + J[:3, 3]
            if cfg.distance_mode == "d2d":
                w = sm.to(sj.dtype)
                scen = torch.sum(sj * w[:, None], 0) / torch.clamp(torch.sum(w), min=1.0)
                _, stats = build_ndt_grid_compact(
                    sj - scen, sm, cfg.resolution, cfg.grid_dims,
                    budget=cfg.max_source_voxels, with_map=False, with_stats=True)
            else:
                stats, scen = None, tcen
            return ndt_align_prebuilt(sj, sm, stats, scen, tvm, tcen, eye, cfg, device=dev)
        return body

    # the k-th-NN windowed (adaptive-radius) covariances, rows of their own
    # beside the reference-parity kNN rows
    def fgicp_adaptive(J):
        sj, tj = moved(J)
        return gicp_align(sj, sm, adaptive_radius_covariance_cols(sj, sm), tj, tm,
                          adaptive_radius_covariance_cols(tj, tm), eye, gcfg, device=dev)

    def vgicp_adaptive(J):
        sj, tj = moved(J)
        return vgicp_align(sj, sm, adaptive_radius_covariance_cols(sj, sm), tj, tm,
                           adaptive_radius_covariance_cols(tj, tm), eye, vcfg, device=dev)

    return {
        "fgicp": (fgicp_fresh, fgicp_reuse),
        "fgicp_adaptive": (fgicp_adaptive, fgicp_reuse),
        "vgicp": (vgicp_fresh, vgicp_reuse),
        "vgicp_adaptive": (vgicp_adaptive, vgicp_reuse),
        "vgicp_rbf": (vgicp_rbf_fresh, vgicp_rbf_reuse),
        "ndt_d2d": (ndt_body(ncfg_d2d), ndt_reuse_body(ncfg_d2d)),
        "ndt_p2d": (ndt_body(ncfg_p2d), ndt_reuse_body(ncfg_p2d)),
    }


class DeviceRow:
    """One device-loop row: `body(J)` over the jitters `jit` (n, 4, 4) on
    the body's device.  On CUDA the trip -- the body on a static jitter
    buffer -- is one `graphs.DeviceGraph`, captured at construction (after
    its eager warm-up) and replayed once a jitter; a trip's pose and
    iterations are copied into the row's (n, 4, 4) and (n,) buffers on the
    device.  `run()` enqueues the n trips and reads nothing."""

    def __init__(self, body, jit):
        import torch

        from fast_gicp_tpu_torch import graphs

        self.jit = jit
        self.J = jit[0].clone()
        self.poses = torch.empty_like(jit)
        self.iterations = torch.empty(jit.shape[0], dtype=torch.int32, device=jit.device)
        self.graph = graphs.DeviceGraph(lambda: body(self.J), jit.device)

    def run(self):
        """Enqueue the n trips (on the CPU: run them); returns (poses,
        iterations), written when the device gets there."""
        for k in range(self.jit.shape[0]):
            self.J.copy_(self.jit[k])
            res = self.graph.replay()
            self.poses[k].copy_(res.transformation)
            self.iterations[k].copy_(res.iterations)
        return self.poses, self.iterations


def run_device_rows(methods, source, target, n, device="cuda", reps=5,
                    max_source_voxels=2048, rows_out=None):
    """Device-loop protocol: each row runs its n aligns as n replays of one
    captured trip (module docstring), fresh and reuse; timed as the root
    app times its scans -- a first run (capture and warm-up) read, then
    `reps` runs enqueued and one read -- in ms an align.  `rows_out`, a
    dict, receives each row's `DeviceRow`s by (name, "fresh" | "reuse")."""
    import torch

    dev = torch.device(device)
    bodies = device_bodies(source, target, dev, max_source_voxels)
    jit = torch.as_tensor(jitters(n), device=dev)

    def timed(body, key):
        row = DeviceRow(body, jit)
        out = row.run()
        out[0].cpu()  # the warm-up's read
        t0 = time.perf_counter()
        for _ in range(reps):
            out = row.run()
        out[0].cpu()  # the one read
        if rows_out is not None:
            rows_out[key] = row
        return (time.perf_counter() - t0) * 1e3 / (n * reps)

    rows = {}
    print(f"\ndevice-loop protocol ({n} aligns a row, each trip one graph replay):")
    print(f"{'method':<16} {'fresh':>14} {'reuse':>14}")
    # the *_adaptive rows ride along whenever their base method is selected
    names = [b for b in bodies if b in methods or b.removesuffix("_adaptive") in methods]
    for name in names:
        fresh = timed(bodies[name][0], (name, "fresh"))
        reuse = timed(bodies[name][1], (name, "reuse"))
        rows[name] = {"fresh_ms_per_align": round(fresh, 3),
                      "reuse_ms_per_align": round(reuse, 3)}
        print(f"{name:<16} {fresh:>11.2f}ms {reuse:>11.2f}ms", flush=True)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("target", nargs="?", default="/root/reference/data/251370668.pcd")
    parser.add_argument("source", nargs="?", default="/root/reference/data/251371071.pcd")
    parser.add_argument("--n", type=int, default=100,
                        help="iterations for the repeated benchmarks")
    parser.add_argument("--downsample", type=float, default=0.1)
    parser.add_argument("--methods", nargs="*", default=None)
    parser.add_argument(
        "--exact-downsample", action="store_true",
        help="use the exact centroid voxel grid instead of the "
        "PCL-ApproximateVoxelGrid-compatible filter the reference benchmark "
        "uses (align.cpp:30-36)")
    parser.add_argument("--json", default=None,
                        help="also write the table as JSON to this path")
    parser.add_argument(
        "--device-loop", action="store_true",
        help="additionally run the Nx protocols as device-resident rows: each trip "
        "one replay of a captured CUDA graph whose solve loops on the device")
    parser.add_argument(
        "--pipelined", action="store_true",
        help="run the Nx rows through align_async (enqueue every align, read once "
        "at the end)")
    parser.add_argument("--device", default="cuda",
                        help="device to run on (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)

    from fast_gicp_tpu_torch.utils.downsample import (
        approximate_voxel_downsample, voxel_downsample,
    )
    from fast_gicp_tpu_torch.utils.io import load_pcd, strip_near_origin

    # the reference benchmark filters through pcl::ApproximateVoxelGrid
    # (align.cpp:30-36): its compatible filter by default, so point counts
    # and fitness compare with its README table
    filt = voxel_downsample if args.exact_downsample else approximate_voxel_downsample
    target = filt(strip_near_origin(load_pcd(args.target)), args.downsample)
    source = filt(strip_near_origin(load_pcd(args.source)), args.downsample)
    print(f"target: {len(target)} pts, source: {len(source)} pts", flush=True)
    print(f"{'method':<12} {'single':>10} {f'{args.n}x':>12} "
          f"{f'{args.n}x_reuse':>12} {'fitness':>10}")

    rows = {}
    for name, make in build_methods(args).items():
        # warm a throwaway instance first (every kernel built, both
        # directions and the cached-covariance align run once), as the
        # reference warms its GPU at construction (fast_vgicp_cuda.cu:20)
        warm = make()
        warm.set_input_target(target)
        warm.set_input_source(source)
        warm.align()
        warm.swap_source_and_target()
        warm.align()
        warm.swap_source_and_target()
        warm.align()

        reg = make()
        t0 = time.perf_counter()
        reg.set_input_target(target)
        reg.set_input_source(source)
        reg.align()
        single_ms = (time.perf_counter() - t0) * 1e3

        if args.pipelined:
            # fresh covariances each round on the uploaded clouds, one read
            # after the last enqueue
            reg = make()
            reg.set_input_target(target)
            reg.set_input_source(source)
            t0 = time.perf_counter()
            for _ in range(args.n):
                reg.clear_covariances()
                reg.align_async()
            reg.get_final_transformation()  # the one read
            multi_ms = (time.perf_counter() - t0) * 1e3

            t0 = time.perf_counter()
            reg = make()
            reg.set_input_target(target)
            reg.set_input_source(source)
            for _ in range(args.n):
                reg.align_async()
                reg.swap_source_and_target()
            reg.get_final_transformation()
            reuse_ms = (time.perf_counter() - t0) * 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(args.n):
                reg = make()
                reg.set_input_target(target)
                reg.set_input_source(source)
                reg.align()
            multi_ms = (time.perf_counter() - t0) * 1e3

            t0 = time.perf_counter()
            reg = make()
            reg.set_input_target(target)
            reg.set_input_source(source)
            for _ in range(args.n):
                reg.align()
                reg.swap_source_and_target()
            reuse_ms = (time.perf_counter() - t0) * 1e3

        reg = make()
        reg.set_input_target(target)
        reg.set_input_source(source)
        reg.align()
        fitness = reg.get_fitness_score()
        print(f"{name:<12} {single_ms:>8.2f}ms {multi_ms:>10.1f}ms "
              f"{reuse_ms:>10.1f}ms {fitness:>10.5f}", flush=True)
        rows[name] = {
            "single_ms": round(single_ms, 2),
            f"{args.n}x_ms": round(multi_ms, 1),
            f"{args.n}x_reuse_ms": round(reuse_ms, 1),
            "fitness": round(float(fitness), 6),
        }
    device_rows = None
    if args.device_loop:
        device_rows = run_device_rows(list(build_methods(args)), source, target, args.n,
                                      device=args.device)
    if args.json:
        import json

        payload = {
            "n": args.n,
            "pipelined": bool(args.pipelined),
            "downsample": args.downsample,
            "n_target": int(len(target)),
            "n_source": int(len(source)),
            "methods": rows,
        }
        if device_rows is not None:
            payload["device_loop"] = device_rows
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
