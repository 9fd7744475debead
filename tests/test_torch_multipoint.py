"""Port vs JAX: `FastGICPMultiPoints` (`models/experimental.py`): the
multi-correspondence objective and its align with device="cpu" against the
JAX package's on the CPU, on the small synthetic pair (frames 30/31 of the
seed-0 drive, a 400k-point world, 0.3 m downsample, padded to 6,144).

Both packages get the same covariances (the JAX package's CPU kNN
covariances), so what is compared is the objective: the exact k = 32
neighbour search of the transformed source (the port's `knn_search`, the
`knn_slab` kernel's plain version), the weights w = max(0, 1 - d / r), the
weighted averages and the linearize.  JAX's CPU `knn_search` forms the
distances as |q|^2 - 2 q.t + |t|^2, up to ~1e-3 m^2 off at the drive's
50 m ranges, and d enters the weights: at the ground-truth pose that moves
err by 3.3e-4 of itself.  The objective test therefore gives JAX's
objective the (q - t)^2 distances of the port's search (`_exact_knn`); the
align keeps JAX's own search.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.models import experimental as jexp
from fast_gicp_tpu.ops import covariance as jcov
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch.models import experimental
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


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=400_000)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    target = downsample.voxel_downsample(scans[30], 0.3)
    source = downsample.voxel_downsample(scans[31], 0.3)
    sp, sm = padding.pad_points(source)
    tp, tm = padding.pad_points(target)
    covs = [np.asarray(jcov.knn_covariance_cols(jnp.asarray(p), jnp.asarray(m)))
            for p, m in ((sp, sm), (tp, tm))]
    return dict(sp=sp, sm=sm, tp=tp, tm=tm, covs=covs, source=source, target=target,
                gt=np.linalg.inv(gt[30]) @ gt[31])


def _args(pair):
    return (pair["sp"], pair["sm"], pair["covs"][0], pair["tp"], pair["tm"], pair["covs"][1])


def _pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return np.linalg.norm(d[:3, 3]), np.degrees(np.arccos(cos))


def _exact_knn(query, target, target_mask, k, approx=True):
    """JAX's k-NN with (q - t)^2 distances, ties to the lower index, in
    1,024-query chunks."""
    del approx
    out = []
    for i in range(0, query.shape[0], 1024):
        d2 = jnp.sum((query[i:i + 1024, None, :] - target[None, :, :]) ** 2, axis=-1)
        neg, idx = jax.lax.top_k(-jnp.where(target_mask[None, :], d2, jnp.inf), k)
        out.append((idx, -neg))
    return tuple(jnp.concatenate(a) for a in zip(*out))


@pytest.mark.parametrize("pose", ["identity", "ground_truth"])
def test_multipoint_objective_matches_jax(pair, pose, monkeypatch):
    """[err, H, b] of the objective at a pose: err rtol 1e-4, H and b within
    1e-4 of their largest entry; the error at that pose from the
    linearization's aux equals its err."""
    monkeypatch.setattr(jexp, "knn_search", _exact_knn)
    x = np.eye(4, dtype=np.float32) if pose == "identity" else pair["gt"].astype(np.float32)
    cfg = jexp.MultiPointConfig()
    lin, err_fn = experimental.make_multipoint_objective(
        *(torch.as_tensor(a) for a in _args(pair)), convert.config_from_jax(cfg))
    jlin, _jerr = jexp.make_multipoint_objective(*(jnp.asarray(a) for a in _args(pair)), cfg)
    err, H, b, aux = lin(torch.as_tensor(x))
    e_j, H_j, b_j, _ = jlin(jnp.asarray(x))
    np.testing.assert_allclose(float(err), float(e_j), rtol=1e-4)
    for g, w in ((H, H_j), (b, b_j)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(float(err_fn(torch.as_tensor(x), aux)), float(err), rtol=1e-5)


def test_multipoint_align_matches_jax(pair):
    """`multipoint_align` from the identity: JAX within the reference's
    accuracy (t < 0.05 m, r < 1 deg), the port within 1e-3 of JAX's pose,
    iterations within 1."""
    cfg = jexp.MultiPointConfig()
    eye = np.eye(4, dtype=np.float32)
    got = experimental.multipoint_align(*_args(pair), eye, convert.config_from_jax(cfg),
                                        device="cpu")
    want = jexp.multipoint_align(*(jnp.asarray(a) for a in _args(pair)), jnp.asarray(eye), cfg)
    for T in (np.asarray(want.transformation), got.transformation.numpy()):
        t_err, r_err = _pose_errors(T, pair["gt"])
        assert t_err < 0.05 and r_err < 1.0, (t_err, r_err)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=1e-3)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1


def test_multipoint_class_runs_the_align_on_its_covariances(monkeypatch):
    """FastGICPMultiPoints: its setters, kNN covariances of both clouds
    cached on the clouds, and `_compute` is `multipoint_align` with the
    class's config on them (a floor and two walls of 2,048 points, and a
    shifted copy)."""
    rng = np.random.default_rng(4)
    u = rng.random((3, 683, 2)) * 6.0
    z = np.zeros((683, 1))
    pts = np.concatenate([np.hstack([u[0], z]), np.hstack([u[1][:, :1], z, u[1][:, 1:]]),
                          np.hstack([z, u[2]])]).astype(np.float32)[:2048]
    reg = experimental.FastGICPMultiPoints(device="cpu")
    reg.set_search_radius(1.5)
    reg.set_correspondence_randomness(10)
    reg.set_regularization_method("plane")
    reg.set_num_threads(4)
    seen = {}
    align = experimental.multipoint_align

    def spy(*args, **kw):
        seen["config"] = args[7]
        return align(*args, **kw)

    monkeypatch.setattr(experimental, "multipoint_align", spy)
    reg.set_input_target(pts)
    reg.set_input_source(pts + np.float32([0.05, -0.03, 0.0]))
    T = reg.align()
    assert seen["config"]._replace(lsq=None) == (1.5, 32, 10, "plane", None)
    assert reg._source.covs is not None and reg._target.covs is not None
    assert np.isfinite(T).all() and np.abs(T[:3, 3] + [0.05, -0.03, 0.0]).max() < 0.02


def test_multipoint_config_from_jax():
    cfg = jexp.MultiPointConfig(search_radius=2.0, k_neighbors=16)
    got = convert.config_from_jax(cfg)
    assert isinstance(got, experimental.MultiPointConfig)
    assert got._replace(lsq=None) == tuple(cfg._replace(lsq=None))
    assert tuple(got.lsq) == tuple(cfg.lsq)
