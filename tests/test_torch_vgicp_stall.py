"""Why FastVGICP's default solve stalls on seed 0's small pair in the JAX
package and on the card but converges on the port's CPU: stage by stage,
the port's CPU against JAX's CPU (`python tests/torch_vgicp_convergence.py
--stages` prints every stage).

FastVGICP's class defaults (kNN covariances k 20 plane, DIRECT1, 1 m,
additive, the hash map), frames 30/31 of the seed-0 drive at 0.3 m, the
forward align in the target-centroid frame.  JAX's covariances come from its
TPU path's fused kernel in interpret mode, as `tests/test_torch_classes.py`
takes them.

1. The kNN search and moments agree: the same k-th distances and excluded
   tile gaps bit for bit, the raw moment rows within 1e-6 of each point's
   largest entry (3.0e-7 measured).  The finalize E[y y^T] - mean mean^T
   about each query tile's first point (the reference's contract) cancels
   up to ~1e4-fold on far points, so the covariances part by up to 5e-3 of
   their scale, and the plane projection turns ~5.5% of them by more than
   1e-4: f32 summation order, not a port fault.
2. On the same covariances the hash maps' integer fields are equal and
   their `packed` rows bit-equal.
3, 4. At the same pose the voxel ids are equal and [err, H, b] agree within
   1e-6 of their largest entry (2.1e-7 measured).
5. So the port's CPU solve on JAX's covariances follows JAX: 64 iterations,
   unconverged, in the same period-2 cycle (2.1e-6 apart over JAX's first 55
   linearizations, measured), within 1e-3 of JAX's pose.  On its own
   covariances it parts at the second iteration, where 6 lanes sit on
   another side of a voxel face, and converges in 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.models import vgicp as jvgicp
from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu.ops import voxelmap as jvm
from fast_gicp_tpu_torch.models import vgicp
from fast_gicp_tpu_torch.ops import covariance, voxelmap
from fast_gicp_tpu_torch.ops.covariance import masked_mean
from fast_gicp_tpu_torch.utils.padding import pad_points
from tests.torch_vgicp_convergence import Recorder, _jax_cov_cols, small_pair, summarize

INTS = ("counts", "coords", "table", "lut", "num_voxels")


@pytest.fixture(scope="module")
def seed0():
    """The padded seed-0 pair, JAX's fused-kernel covariances of both
    clouds and the target-centred clouds."""
    target, source, gt = small_pair(0)
    (sp, sm), (tp, tm) = pad_points(source), pad_points(target)
    jcovs = [_jax_cov_cols(jnp.asarray(p), jnp.asarray(m)) for p, m in ((sp, sm), (tp, tm))]
    c = masked_mean(torch.as_tensor(tp), torch.as_tensor(tm))
    return dict(sp=sp, sm=sm, tp=tp, tm=tm, gt=gt, jcovs=jcovs,
                src_c=torch.as_tensor(sp) - c, tgt_c=torch.as_tensor(tp) - c)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("cloud", ["source", "target"])
def test_stage1_knn_moments_agree(seed0, cloud):
    """Stage 1: kth and excluded gaps equal, raw moments within 1e-6 of
    each point's largest entry."""
    pts, m = (seed0["sp"], seed0["sm"]) if cloud == "source" else (seed0["tp"], seed0["tm"])
    pm, pk, pe = covariance._knn_moment_cols_fused(torch.as_tensor(pts), torch.as_tensor(m), 20)
    jm, jk, je = jcov._knn_moment_cols_fused(jnp.asarray(pts), jnp.asarray(m), 20,
                                             interpret=True)
    np.testing.assert_array_equal(pk.numpy()[m], np.asarray(jk)[m])
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    got, want = pm.numpy()[:, m].astype(np.float64), np.asarray(jm)[:, m].astype(np.float64)
    assert (np.abs(got - want).max(0) / np.abs(want).max(0)).max() <= 1e-6


@pytest.fixture(scope="module")
def same_maps(seed0):
    """Both packages' target hash maps on JAX's target covariances."""
    jc = seed0["jcovs"][1]
    pmap = voxelmap.build_voxelmap(seed0["tgt_c"], torch.as_tensor(seed0["tm"]), 1.0,
                                   covs=torch.as_tensor(jc), device="cpu")
    jmap = jvm.build_voxelmap(jnp.asarray(seed0["tgt_c"].numpy()), jnp.asarray(seed0["tm"]),
                              1.0, covs=jnp.asarray(jc))
    return pmap, jmap


def test_stage2_hash_map_agrees_on_the_same_covariances(same_maps):
    """Stage 2: integer fields equal, `packed` bit-equal."""
    pmap, jmap = same_maps
    for f in INTS:
        np.testing.assert_array_equal(np.asarray(getattr(pmap, f)), np.asarray(getattr(jmap, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(pmap.packed.numpy(), np.asarray(jmap.packed))


@pytest.mark.parametrize("pose", ["identity", "perturbed"])
def test_stages3_4_ids_and_normal_equations_agree(seed0, same_maps, pose):
    """Stages 3-4 at one pose: the voxel ids equal, [err, H, b] within 1e-6
    of their largest entry, on the same covariances and maps."""
    pmap, jmap = same_maps
    x = np.eye(4, dtype=np.float32)
    if pose == "perturbed":
        a = 0.01
        x[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        x[:3, 3] = [0.31, -0.12, 0.05]
    offsets = voxelmap.neighbor_offsets("direct1")
    plin, _e, pfreeze, _lf = vgicp.make_vgicp_objective(
        seed0["src_c"], torch.as_tensor(seed0["sm"]), torch.as_tensor(seed0["jcovs"][0]), pmap,
        offsets, vgicp.VGICPConfig())
    jlin, _je = jvgicp.make_vgicp_objective(
        jnp.asarray(seed0["src_c"].numpy()), jnp.asarray(seed0["sm"]),
        jnp.asarray(seed0["jcovs"][0]), jmap, jnp.asarray(offsets), jvgicp.VGICPConfig())
    p_t = jnp.asarray(x[:3, :3]) @ jnp.asarray(seed0["src_c"].numpy()).T + jnp.asarray(x[:3, 3:])
    q = jnp.floor(p_t / 1.0 - 0.5).astype(jnp.int32)
    jids = np.asarray(jvm.lookup_voxels_cols(jmap, q[0], q[1], q[2]))
    ids, valid = pfreeze(torch.as_tensor(x))
    pids = np.where(valid.numpy() > 0, ids.numpy(), -1)
    np.testing.assert_array_equal(pids, np.where(seed0["sm"], jids, -1))
    pe, pH, pb, _ = plin(torch.as_tensor(x))
    je, jH, jb, _ = jlin(jnp.asarray(x))
    got = np.concatenate([[float(pe)], pH.numpy().ravel(), pb.numpy()])
    want = np.concatenate([[float(je)], np.asarray(jH).ravel(), np.asarray(jb)])
    assert _rel(got, want) <= 1e-6


def test_stage5_port_on_jax_covariances_stalls_as_jax(seed0):
    """Stage 5: on JAX's covariances the port's CPU solve runs the 64
    iterations unconverged, ending in a period-2 cycle, within 1e-3 of
    JAX's pose, both within 0.05 m of the ground truth."""
    args = (seed0["sp"], seed0["sm"], seed0["jcovs"][0], seed0["tp"], seed0["tm"],
            seed0["jcovs"][1])
    with Recorder() as rec:
        got = vgicp.vgicp_align(*(torch.as_tensor(a) for a in args), torch.eye(4),
                                vgicp.VGICPConfig(), device="cpu")
    want = jvgicp.vgicp_align(*(jnp.asarray(a) for a in args), jnp.eye(4),
                              jvgicp.VGICPConfig())
    assert int(got.iterations) == 64 and not bool(got.converged)
    assert summarize(rec.solves[0])["cycle"] == 2
    T, Tj = got.transformation.numpy(), np.asarray(want.transformation)
    np.testing.assert_allclose(T, Tj, atol=1e-3)
    for pose in (T, Tj):
        assert np.linalg.norm((np.linalg.inv(seed0["gt"]) @ pose.astype(np.float64))[:3, 3]) < 0.05
