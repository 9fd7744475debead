"""GICP parity of the PyTorch port against the JAX package on the CPU.

On the small synthetic pair (frames 30/31 of the seed-0 drive, a 400k-point
world, 0.3 m downsample, 6,144 padded points) this prints:
  * for each cloud, the share of valid points whose kNN covariances
    (plane) from the port (fused contract: 16 candidate tiles of 128
    points) agree within 1e-3 with the JAX package's CPU path (16 tiles
    of 256 points), overall and on the points the port's search
    certifies exact, and the certified share;
  * `gicp_register_fresh` of both packages: iterations, t_err, r_err and
    the largest pose difference;
  * `fitness_score` of both at the identity pose, without and with a
    0.5 m max_range.

Usage: JAX_PLATFORMS=cpu python tests/torch_gicp_parity.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from fast_gicp_tpu.models import gicp as jgicp  # noqa: E402
from fast_gicp_tpu.models import metrics as jmetrics  # noqa: E402
from fast_gicp_tpu.ops import covariance as jcov  # noqa: E402
from fast_gicp_tpu_torch.models import gicp, metrics  # noqa: E402
from fast_gicp_tpu_torch.ops import covariance  # noqa: E402
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic  # noqa: E402


def pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return np.linalg.norm(d[:3, 3]), np.degrees(np.arccos(cos))


def main():
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=400_000)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    T_gt = np.linalg.inv(gt[30]) @ gt[31]
    sp, sm = padding.pad_points(downsample.voxel_downsample(scans[31], 0.3))
    tp, tm = padding.pad_points(downsample.voxel_downsample(scans[30], 0.3))

    for name, p, m in (("source", sp, sm), ("target", tp, tm)):
        want = np.asarray(jcov.knn_covariance_cols(jnp.asarray(p), jnp.asarray(m)))
        pts, mask = torch.as_tensor(p), torch.as_tensor(m)
        got = covariance.knn_covariance_cols(pts, mask).numpy()
        _mom, kth, excluded = covariance._knn_moment_cols_fused(pts, mask, 20)
        cert = (kth.reshape(-1, 256) <= excluded[:, None]).reshape(-1).numpy() & m
        ok = np.abs(got - want).max(0) <= 1e-3
        print(f"{name}: covariances within 1e-3 of JAX CPU: {ok[m].mean():.4f} of valid, "
              f"{ok[cert].mean():.4f} of certified; certified {cert.sum() / m.sum():.4f}")

    eye = np.eye(4, dtype=np.float32)
    res = gicp.gicp_register_fresh(sp, sm, tp, tm, eye, device="cpu")[0]
    jres = jgicp.gicp_register_fresh(*(jnp.asarray(a) for a in (sp, sm, tp, tm, eye)))[0]
    T, T_j = res.transformation.numpy(), np.asarray(jres.transformation)
    for name, r, pose in (("port", res, T), ("jax cpu", jres, T_j)):
        t_err, r_err = pose_errors(pose, T_gt)
        print(f"gicp_register_fresh {name}: {int(r.iterations)} iterations, "
              f"t_err {t_err * 1e3:.2f} mm, r_err {r_err:.4f} deg")
    print(f"pose difference (max abs): {np.abs(T - T_j).max():.3e}")

    for max_range in (np.inf, 0.5):
        f = float(metrics.fitness_score(eye, sp, sm, tp, tm, max_range=max_range,
                                        device="cpu"))
        f_j = float(jmetrics.fitness_score(*(jnp.asarray(a) for a in (eye, sp, sm, tp, tm)),
                                           max_range=max_range))
        print(f"fitness at identity, max_range {max_range}: port {f:.7f}, "
              f"jax cpu {f_j:.7f}, relative {(f_j - f) / f:.2e}")


if __name__ == "__main__":
    main()
