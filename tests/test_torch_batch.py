"""The batch aligns (`models/batch.py`): `gicp_align_batch`,
`vgicp_align_batch` and `ndt_align_batch` with device="cpu".

Each pair of a batch runs through its own target-centroid frame, objective
and LM solve, so each result equals the single-pair call of the same
objective bit for bit: `gicp_align`, `vgicp_align` on the hash map
(grid_dims None: `build_voxelmap`, as the batch builds it) and `ndt_align`
on the hash map (`_ndt_voxelmap`), all with refresh_iterations None.  The
GICP and VGICP batches are also held to the JAX package's (its `vmap` of
the same objective) on two consecutive pairs of the small synthetic drive
(frames 30/31 and 31/32 of the seed-0 400k-point world, 0.3 m downsample,
one padded size); the NDT batch runs on the full-size pairs (the small
pairs are too sparse for NDT's > 6 points gate, tests/test_torch_ndt.py),
whose single-pair hash-map align tests/test_torch_ndt_hash.py holds to
JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.models import batch as jbatch
from fast_gicp_tpu.models import gicp as jgicp
from fast_gicp_tpu.models import vgicp as jvgicp
from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch.models import batch, gicp, ndt, vgicp
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch ops: the suite runs six
    test processes on the host's cores, and torch's default of one thread
    a core in each slows every process."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pairs(n_world, voxel, frames=(30, 31, 32)):
    """Consecutive pairs (frame f -> target, f + 1 -> source) padded to one
    size: (sp, sm, tp, tm) each (B, M, ...) and the ground truths (B, 4, 4)."""
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, **({} if n_world is None else {"n": n_world}))
    scans, gt = synthetic.drive_scans(rng, n_frames=frames[-1] + 1, world=world)
    clouds = [downsample.voxel_downsample(scans[f], voxel) for f in frames]
    m = padding.bucket_size(max(len(c) for c in clouds))
    padded = [padding.pad_points(np.concatenate([c, np.zeros((m - len(c), 3), np.float32)]))[0]
              for c in clouds]
    masks = [np.arange(m) < len(c) for c in clouds]
    t, s = slice(0, -1), slice(1, None)
    return dict(sp=np.stack(padded[s]), sm=np.stack(masks[s]), tp=np.stack(padded[t]),
                tm=np.stack(masks[t]),
                gt=np.stack([np.linalg.inv(gt[f]) @ gt[f + 1] for f in frames[:-1]]))


@pytest.fixture(scope="module")
def small():
    b = _pairs(400_000, 0.3)
    b["sc"], b["tc"] = (np.stack([np.asarray(jcov.knn_covariance_cols(jnp.asarray(p),
                                                                       jnp.asarray(m)))
                                  for p, m in zip(b[pk], b[mk])])
                        for pk, mk in (("sp", "sm"), ("tp", "tm")))
    return b


def _t_err(T, T_gt):
    return float(np.linalg.norm((np.linalg.inv(T_gt) @ np.asarray(T, np.float64))[:3, 3]))


def _check_stacked(res, B):
    assert res.transformation.shape == (B, 4, 4) and res.hessian.shape == (B, 6, 6)
    assert res.error.shape == res.converged.shape == res.iterations.shape == (B,)


def _assert_same_bits(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)


@pytest.mark.parametrize("kind", ["gicp", "vgicp"])
def test_gicp_and_vgicp_batches_match_pairs_and_jax(small, kind):
    """Each pair's result bit-equal to the single-pair align; poses within
    1e-3 of the JAX batch's, iterations within 1, both within 0.05 m."""
    args = tuple(small[k] for k in ("sp", "sm", "sc", "tp", "tm", "tc"))
    B = args[0].shape[0]
    guesses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    if kind == "gicp":
        cfg, single, jfn = jgicp.GICPConfig(), gicp.gicp_align, jbatch.gicp_align_batch
        got = batch.gicp_align_batch(*args, guesses, convert.config_from_jax(cfg), device="cpu")
    else:
        cfg, single, jfn = jvgicp.VGICPConfig(), vgicp.vgicp_align, jbatch.vgicp_align_batch
        got = batch.vgicp_align_batch(*args, guesses, convert.config_from_jax(cfg), device="cpu")
    _check_stacked(got, B)
    for i in range(B):
        one = single(*(a[i] for a in args), guesses[i], convert.config_from_jax(cfg),
                     device="cpu")
        _assert_same_bits([f[i] for f in got], one)
    want = jfn(*(jnp.asarray(a) for a in args), jnp.asarray(guesses), cfg)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=1e-3)
    assert np.abs(got.iterations.numpy() - np.asarray(want.iterations)).max() <= 1
    for i in range(B):
        assert _t_err(np.asarray(want.transformation[i]), small["gt"][i]) < 0.05
        assert _t_err(got.transformation[i].numpy(), small["gt"][i]) < 0.05


@pytest.fixture(scope="module")
def full():
    return _pairs(None, 0.1)


@pytest.mark.parametrize("mode, B", [("d2d", 2), ("p2d", 1)])
def test_ndt_align_batch_matches_pairs(full, mode, B):
    """Consecutive full-size pairs (D2D two, P2D one: 157,696 lanes): each
    result bit-equal to `ndt_align` on the hash map, within the accuracy
    limits (P2D at twice the reference's, as tests/test_registration.py
    holds it)."""
    b = full
    args = tuple(b[k][:B] for k in ("sp", "sm", "tp", "tm"))
    guesses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    cfg = ndt.NDTConfig(distance_mode=mode)
    got = batch.ndt_align_batch(*args, guesses, cfg, device="cpu")
    _check_stacked(got, B)
    for i in range(B):
        _assert_same_bits([f[i] for f in got],
                          ndt.ndt_align(*(a[i] for a in args), guesses[i], cfg, device="cpu"))
        assert _t_err(got.transformation[i].numpy(), b["gt"][i]) < (0.05 if mode == "d2d"
                                                                    else 0.10)
    with pytest.raises(ValueError, match="distance mode"):
        batch.ndt_align_batch(*args, guesses, cfg._replace(distance_mode="p2p"), device="cpu")
