"""Parity of the port's kNN slab search and adaptive-radius covariances
against the JAX package on the CPU.

On the small synthetic pair (frames 30/31 of the seed-0 drive, a 400k-point
world, 0.3 m downsample, 6,144 padded points) this prints:
  * for each cloud, the share of valid points that `knn_search_culled`
    certifies exact (16 of 24 tiles of 256 points searched), the share
    whose certificate equals JAX's, and the share of certified points with
    the same neighbour set as JAX's CPU path;
  * for each cloud, the share of valid points whose adaptive-radius
    covariances (plane) agree within 1e-4 and 1e-3 with the JAX package's
    CPU path, and the largest difference;
  * `gicp_register_fresh` of both packages with the adaptive estimator and
    with kNN covariances under MIN_EIG: iterations, t_err, r_err and the
    largest pose difference.
With --full it runs only the adaptive registration (plane), on the
full-size pair `chip_smoke.py` registers (the default 1.4M-point world,
0.1 m downsample, 22,528 padded points), and prints the same four figures
(about a minute and a half on the CPU).

Usage: JAX_PLATFORMS=cpu python tests/torch_knn_adaptive_parity.py [--full]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from fast_gicp_tpu.models import gicp as jgicp  # noqa: E402
from fast_gicp_tpu.ops import covariance as jcov  # noqa: E402
from fast_gicp_tpu.ops import neighbors as jneighbors  # noqa: E402
from fast_gicp_tpu_torch.models import gicp  # noqa: E402
from fast_gicp_tpu_torch.ops import covariance, neighbors  # noqa: E402
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic  # noqa: E402


def pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return np.linalg.norm(d[:3, 3]), np.degrees(np.arccos(cos))


def compare_registrations(sp, sm, tp, tm, T_gt, method, reg):
    """`gicp_register_fresh` of both packages from the identity: iterations,
    t_err and r_err of each, and the largest pose difference."""
    eye = np.eye(4, dtype=np.float32)
    kw = dict(method=method, regularization=reg)
    res = gicp.gicp_register_fresh(sp, sm, tp, tm, eye, device="cpu", **kw)[0]
    jres = jgicp.gicp_register_fresh(*(jnp.asarray(a) for a in (sp, sm, tp, tm, eye)), **kw)[0]
    T, T_j = res.transformation.numpy(), np.asarray(jres.transformation)
    for name, r, pose in (("port", res, T), ("jax cpu", jres, T_j)):
        t_err, r_err = pose_errors(pose, T_gt)
        print(f"gicp_register_fresh {method}/{reg} {name}: {int(r.iterations)} "
              f"iterations, t_err {t_err * 1e3:.3f} mm, r_err {r_err:.6f} deg")
    print(f"gicp_register_fresh {method}/{reg} pose difference (max abs): "
          f"{np.abs(T - T_j).max():.3e}")


def pair(n_world, voxel):
    """Frames 31 (source) and 30 (target) of the seed-0 drive, downsampled
    and padded, with the ground-truth target <- source pose."""
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=n_world)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    T_gt = np.linalg.inv(gt[30]) @ gt[31]
    sp, sm = padding.pad_points(downsample.voxel_downsample(scans[31], voxel))
    tp, tm = padding.pad_points(downsample.voxel_downsample(scans[30], voxel))
    return sp, sm, tp, tm, T_gt


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="adaptive registration on the full-size pair only")
    if ap.parse_args().full:
        compare_registrations(*pair(1_400_000, 0.1), "adaptive", "plane")
        return
    sp, sm, tp, tm, T_gt = pair(400_000, 0.3)

    for name, p, m in (("source", sp, sm), ("target", tp, tm)):
        idx, _sq, cert = (a.numpy() for a in neighbors.knn_search_culled(p, p, m, 20,
                                                                         device="cpu"))
        idx_j, _sq_j, cert_j = (np.asarray(a) for a in jneighbors.knn_search_culled(
            jnp.asarray(p), jnp.asarray(p), jnp.asarray(m), k=20))
        ok = cert & m
        same = (np.sort(idx, 1) == np.sort(idx_j, 1)).all(1)
        print(f"{name}: knn_search_culled certified {ok.sum() / m.sum():.4f} of valid, "
              f"certificate equal to JAX's on {(cert == cert_j)[m].mean():.4f}, "
              f"neighbour set equal on {same[ok].mean():.4f} of certified")
        want = np.asarray(jcov.adaptive_radius_covariance_cols(jnp.asarray(p), jnp.asarray(m)))
        got = covariance.adaptive_radius_covariances(p, m, device="cpu")
        got = got.reshape(-1, 9)[:, [0, 1, 2, 4, 5, 8]].T.numpy()
        diff = np.abs(got - want).max(0)[m]
        print(f"{name}: adaptive covariances (plane) within 1e-4 of JAX CPU on "
              f"{(diff <= 1e-4).mean():.4f}, within 1e-3 on {(diff <= 1e-3).mean():.4f} "
              f"of valid; max {diff.max():.3e}")

    for method, reg in (("adaptive", "plane"), ("knn", "min_eig")):
        compare_registrations(sp, sm, tp, tm, T_gt, method, reg)


if __name__ == "__main__":
    main()
