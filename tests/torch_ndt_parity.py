"""NDT parity of the PyTorch port against the JAX package on the CPU.

Prints, for the synthetic drive's frames 30/31 (seed 0):
  * the 0.3 m pair of a 400k-point world (the GICP/VGICP tests' small
    pair) and the full-size 0.1 m pair of the default world: occupied 1 m
    voxels, those holding more than the 6 points NDT's gate needs, and the
    JAX package's own NDT error against the ground truth (its CPU path);
  * on the full-size pair, for each NDT configuration of `chip_smoke.py`
    and `tests/test_torch_ndt.py`: iterations, t_err and r_err of the port
    (device="cpu") and of the JAX package (its CPU path), and the largest
    pose difference;
  * the target centroids the two packages sum, the source points that they
    then bin into different voxels, and the D2D objective's relative
    difference at the ground truth that follows.

Usage: JAX_PLATFORMS=cpu python tests/torch_ndt_parity.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fast_gicp_tpu.models import ndt as jndt  # noqa: E402
from fast_gicp_tpu_torch import convert  # noqa: E402
from fast_gicp_tpu_torch.models import ndt  # noqa: E402
from fast_gicp_tpu_torch.ops.covariance import masked_mean  # noqa: E402
from fast_gicp_tpu_torch.ops.voxelmap import (  # noqa: E402
    auto_grid_dims_from_extent, voxel_coord,
)
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic  # noqa: E402


def pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return np.linalg.norm(d[:3, 3]), np.degrees(np.arccos(cos))


def make_pair(n_world, voxel):
    rng = np.random.default_rng(0)
    world = (synthetic.drive_world(rng) if n_world is None
             else synthetic.drive_world(rng, n=n_world))
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    target = downsample.voxel_downsample(scans[30], voxel)
    source = downsample.voxel_downsample(scans[31], voxel)
    sp, sm = padding.pad_points(source)
    tp, tm = padding.pad_points(target)
    dims = auto_grid_dims_from_extent(np.minimum(source.min(0), target.min(0)),
                                      np.maximum(source.max(0), target.max(0)), 1.0)
    return (sp, sm, tp, tm), dims, np.linalg.inv(gt[30]) @ gt[31]


def occupancy(points):
    c = points.astype(np.float64).mean(0)
    _, counts = np.unique(np.floor(points - c - 0.5).astype(np.int64), axis=0,
                          return_counts=True)
    return len(counts), int((counts > 6).sum())


def main():
    eye = np.eye(4, dtype=np.float32)
    for label, n_world, voxel in (("0.3 m pair, 400k world", 400_000, 0.3),
                                  ("0.1 m pair, default world", None, 0.1)):
        args, dims, T_gt = make_pair(n_world, voxel)
        sp, sm, tp, tm = args
        occ_t, occ_s = occupancy(tp[tm]), occupancy(sp[sm])
        print(f"{label}: {sm.sum()} / {tm.sum()} points; occupied 1 m voxels (gate-passing) "
              f"source {occ_s[0]} ({occ_s[1]}), target {occ_t[0]} ({occ_t[1]})")
        for mode in ("d2d", "p2d"):
            cfg = jndt.NDTConfig(distance_mode=mode, grid_dims=dims)
            jres = jndt.ndt_register_fresh(*(jnp.asarray(a) for a in args), jnp.asarray(eye),
                                           cfg)[0]
            t_err, r_err = pose_errors(jres.transformation, T_gt)
            print(f"  JAX ndt_register_fresh {mode}: t_err {t_err * 1e3:.2f} mm, "
                  f"r_err {r_err:.4f} deg")

    args, dims, T_gt = make_pair(None, 0.1)
    sp, sm, tp, tm = args
    cases = [("ndt_register_fresh", "d2d", None, 4096),
             ("ndt_register_fresh", "p2d", None, 4096),
             ("ndt_align", "d2d", None, 4096), ("ndt_align", "d2d", 3, 8192),
             ("ndt_align", "p2d", None, 4096), ("ndt_align", "p2d", 3, 2048),
             ("ndt_align", "d2d", 3, 2048)]
    for fn, mode, refresh, budget in cases:
        cfg = jndt.NDTConfig(distance_mode=mode, grid_dims=dims, refresh_iterations=refresh,
                             max_source_voxels=budget)
        port_fn, jax_fn = getattr(ndt, fn), getattr(jndt, fn)
        res = port_fn(*args, eye, convert.config_from_jax(cfg), device="cpu")
        jres = jax_fn(*(jnp.asarray(a) for a in args), jnp.asarray(eye), cfg)
        if fn == "ndt_register_fresh":
            res, jres = res[0], jres[0]
        T, T_j = res.transformation.numpy(), np.asarray(jres.transformation)
        line = f"{fn} {mode} refresh={refresh} max_source_voxels={budget}:"
        for name, r, pose in (("port", res, T), ("jax", jres, T_j)):
            t_err, r_err = pose_errors(pose, T_gt)
            line += (f" {name} {int(r.iterations)} it, t_err {t_err * 1e3:.2f} mm,"
                     f" r_err {r_err:.4f} deg;")
        print(f"{line} pose difference {np.abs(T - T_j).max():.2e}")

    c_t = masked_mean(torch.as_tensor(tp), torch.as_tensor(tm))
    w = jnp.asarray(tm).astype(jnp.float32)
    c_j = jnp.sum(jnp.asarray(tp) * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    c_j = torch.as_tensor(np.array(c_j))
    moved = (voxel_coord(torch.as_tensor(sp) - c_t, 1.0)
             != voxel_coord(torch.as_tensor(sp) - c_j, 1.0)).any(1) & torch.as_tensor(sm)
    print(f"target centroid: port {c_t.numpy()}, jax {c_j.numpy()}; source points binned "
          f"into another voxel: {int(moved.sum())} of {int(sm.sum())}")
    cfg = jndt.NDTConfig(distance_mode="d2d", grid_dims=dims)
    pose = T_gt.astype(np.float32)
    e, H, b = ndt.ndt_evaluate(*args, pose, convert.config_from_jax(cfg), device="cpu")
    e_j, H_j, b_j = (np.asarray(a) for a in jndt.ndt_evaluate(
        *(jnp.asarray(a) for a in (*args, pose)), cfg))
    rel = [float(np.abs(g.numpy() - w).max() / np.abs(w).max()) for g, w in ((H, H_j), (b, b_j))]
    print(f"ndt_evaluate d2d at the ground truth: err port {float(e):.3f}, jax {float(e_j):.3f}, "
          f"relative {(float(e) - float(e_j)) / float(e_j):.2e}; H, b within {rel[0]:.1e}, "
          f"{rel[1]:.1e} of their largest entry")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
