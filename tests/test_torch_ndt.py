"""Port vs JAX: the NDT slice end to end.  `ndt_register_fresh`, `ndt_align`
(with and without refresh_iterations), `ndt_prepare_cloud`,
`ndt_align_prebuilt` and `ndt_evaluate` of fast_gicp_tpu_torch with
device="cpu" against fast_gicp_tpu's, whose fused objective is reached by
patching `pallas_linearize.supported` and running the Pallas kernels in
interpret mode.

The pair is the full-size synthetic one (frames 30/31 of the seed-0 drive,
the default 1.4M-point world, 0.1 m downsample: 20,985 and 21,062 points,
padded to 22,528).  The CPU tests' usual 0.3 m pair of a 400k-point world
is too sparse for NDT: 63 of its ~3.3k occupied 1 m voxels a cloud hold
more than the 6 points the gate needs, and the JAX package's own
`ndt_register_fresh` lands 53.5 mm (D2D) and 210.7 mm (P2D) from the
ground truth there (tests/torch_ndt_parity.py).  On this pair every JAX
result the tests compare with is first held to the accuracy limits itself:
D2D within 0.05 m / 1 deg (gicp_test.cpp:148-149), P2D within twice that, as
tests/test_registration.py holds P2D."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu import se3 as jse3
from fast_gicp_tpu.models import ndt as jndt
from fast_gicp_tpu.ops import pallas_linearize
from fast_gicp_tpu_torch import convert, se3
from fast_gicp_tpu_torch.models import ndt
from fast_gicp_tpu_torch.ops import cuda_ndt
from fast_gicp_tpu_torch.ops.voxelmap import NdtGridMap, auto_grid_dims_from_extent
from fast_gicp_tpu_torch.solver import lsq_solve
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic
from tests.torch_cpu import warm_intra_op_threads

LIMITS = {"d2d": (0.05, 1.0), "p2d": (0.10, 2.0)}


@pytest.fixture(autouse=True, scope="module")
def _warm_threads():
    warm_intra_op_threads()


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    target = downsample.voxel_downsample(scans[30], 0.1)
    source = downsample.voxel_downsample(scans[31], 0.1)
    sp, sm = padding.pad_points(source)
    tp, tm = padding.pad_points(target)
    # grid dims over both clouds, as NDTCuda sizes them
    dims = auto_grid_dims_from_extent(np.minimum(source.min(0), target.min(0)),
                                      np.maximum(source.max(0), target.max(0)), 1.0)
    return dict(sp=sp, sm=sm, tp=tp, tm=tm, dims=dims, gt=np.linalg.inv(gt[30]) @ gt[31])


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package's NDT objective on its fused Pallas path, the kernels
    in interpret mode (its CPU default is the SoA path)."""
    monkeypatch.setattr(pallas_linearize, "supported",
                        lambda m: m % pallas_linearize._NT == 0)
    for name in ("ndt_linearize_pallas", "ndt_error_pallas"):
        orig = getattr(pallas_linearize, name)
        monkeypatch.setattr(pallas_linearize, name,
                            (lambda o: lambda *a, interpret=False: o(*a, interpret=True))(orig))
    jax.clear_caches()  # no trace of the SoA path is reused
    yield
    jax.clear_caches()


def _pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return np.linalg.norm(d[:3, 3]), np.degrees(np.arccos(cos))


def _translation(c):
    T = np.eye(4)
    T[:3, 3] = c
    return T


def _args(pair):
    return tuple(pair[k] for k in ("sp", "sm", "tp", "tm")) + (np.eye(4, dtype=np.float32),)


def _compare(got, want, pair, mode, pinned=True, tol=1e-3):
    """Pose elementwise within `tol` of JAX's, iterations within 1, both
    converged; with `pinned`, both within the accuracy limits."""
    got, want = convert.lsq_result_to_numpy(got), convert.lsq_result_to_numpy(want)
    assert np.isfinite(got.transformation).all()
    errs = [_pose_errors(T, pair["gt"]) for T in (want.transformation, got.transformation)]
    if pinned:
        t_lim, r_lim = LIMITS[mode]
        for t_err, r_err in errs:  # the JAX result first: the reference is pinned
            assert t_err < t_lim and r_err < r_lim, errs
    np.testing.assert_allclose(got.transformation, want.transformation, atol=tol)
    assert abs(got.iterations - want.iterations) <= 1
    assert got.converged and want.converged
    return errs


@pytest.mark.parametrize("mode", ["d2d", "p2d"])
def test_ndt_register_fresh_matches_jax(pair, jax_fused, mode):
    """NDTCuda's fresh align (defaults, each cloud's map prepared in its own
    centroid frame).  The two packages sum the centroids in different
    orders, so a point on a voxel boundary may bin differently; 1e-3 on the
    pose covers it."""
    cfg = jndt.NDTConfig(distance_mode=mode, grid_dims=pair["dims"])
    res, tstate, sstate = ndt.ndt_register_fresh(*_args(pair), convert.config_from_jax(cfg),
                                                 device="cpu")
    jres = jndt.ndt_register_fresh(*(jnp.asarray(a) for a in _args(pair)), cfg)[0]
    _compare(res, jres, pair, mode)
    assert isinstance(tstate[0], NdtGridMap)
    assert (sstate is None) == (mode == "p2d")


@pytest.mark.parametrize("mode, refresh, budget", [
    ("d2d", None, 4096), ("d2d", 3, 8192), ("p2d", None, 4096), ("p2d", 3, 2048),
])
def test_ndt_align_matches_jax(pair, jax_fused, mode, refresh, budget):
    """`ndt_align` on the raw target grid, one-phase and two-phase (P2D's
    frozen phase seeded from the refresh aux, D2D's re-frozen)."""
    cfg = jndt.NDTConfig(distance_mode=mode, grid_dims=pair["dims"],
                         refresh_iterations=refresh, max_source_voxels=budget)
    res = ndt.ndt_align(*_args(pair), convert.config_from_jax(cfg), device="cpu")
    jres = jndt.ndt_align(*(jnp.asarray(a) for a in _args(pair)), cfg)
    _compare(res, jres, pair, mode)


def test_ndt_align_source_budget_overflow_matches_jax(pair, jax_fused):
    """apps/align.py's D2D row (refresh_iterations=3, 2,048 source voxels)
    on this pair, which occupies 6,660 source voxels: the compaction keeps
    the lowest 2,048 representative ids (about a third of the scene) in
    both packages, and both land about 0.17 m off; the port keeps the
    overflow as the JAX package has it."""
    cfg = jndt.NDTConfig(grid_dims=pair["dims"], refresh_iterations=3,
                         max_source_voxels=2048)
    res = ndt.ndt_align(*_args(pair), convert.config_from_jax(cfg), device="cpu")
    jres = jndt.ndt_align(*(jnp.asarray(a) for a in _args(pair)), cfg)
    # with a third of the scene left the solve is weakly constrained along z,
    # and the two summation orders end 2.1e-3 apart there
    errs = _compare(res, jres, pair, "d2d", pinned=False, tol=5e-3)
    assert all(0.1 < t_err < 0.3 for t_err, _ in errs), errs


@pytest.mark.parametrize("mode", ["d2d", "p2d"])
def test_ndt_prepare_cloud_and_align_prebuilt_match_jax(pair, jax_fused, mode):
    """`ndt_prepare_cloud` of both packages: centroids within 1e-5 and maps
    and stats within 1e-5 on all but the voxels a centroid's last bit can
    move points between; then `ndt_align_prebuilt` of the port on the JAX
    package's prepared state (carried across by `convert`) against the JAX
    function on the same state, with a guess off the identity."""
    cfg = jndt.NDTConfig(distance_mode=mode, grid_dims=pair["dims"], refresh_iterations=2)
    pcfg = convert.config_from_jax(cfg)
    sp, sm, tp, tm, _eye = _args(pair)
    jt = jndt.ndt_prepare_cloud(jnp.asarray(tp), jnp.asarray(tm), cfg)
    js = jndt.ndt_prepare_cloud(jnp.asarray(sp), jnp.asarray(sm), cfg)
    tvm, tstats, tc = ndt.ndt_prepare_cloud(tp, tm, pcfg, device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jt[2]), atol=1e-5)
    rows_ok = np.abs(tvm.packed.numpy() - np.asarray(jt[0].packed)).max(1) <= 1e-5
    assert rows_ok.mean() > 0.999, rows_ok.mean()
    assert (tstats is None) == (mode == "p2d")
    if mode == "d2d":
        assert tstats[0].shape == (cfg.max_source_voxels, 3)  # trimmed to the source budget
        stats_ok = np.abs(tstats[0].numpy() - np.asarray(jt[1][0])).max(1) <= 1e-5
        assert stats_ok.mean() > 0.999, stats_ok.mean()

    guess = np.asarray(jse3.se3_exp(jnp.float32([0.002, -0.003, 0.01, 0.3, 0.1, -0.05])))
    tmap = convert.ndt_grid_map_from_numpy(jt[0].packed, jt[0].grid8, jt[0].origin,
                                           jt[0].resolution, jt[0].grid.shape,
                                           device="cpu")
    compact = None if js[1] is None else convert.ndt_stats_from_numpy(*js[1], device="cpu")
    res = ndt.ndt_align_prebuilt(sp, sm, compact, torch.as_tensor(np.asarray(js[2])), tmap,
                                 torch.as_tensor(np.asarray(jt[2])), guess, pcfg, device="cpu")
    jres = jndt.ndt_align_prebuilt(jnp.asarray(sp), jnp.asarray(sm), js[1], js[2], jt[0],
                                   jt[2], jnp.asarray(guess), cfg)
    _compare(res, jres, pair, mode)
    # the world-frame Hessian A^T H' A within 1% of its largest entry: it is
    # taken at the last linearization, which differs as the poses do
    want_H = np.asarray(jres.hessian)
    np.testing.assert_allclose(res.hessian.numpy(), want_H, atol=1e-2 * np.abs(want_H).max())


@pytest.mark.parametrize("mode", ["d2d", "p2d"])
def test_ndt_evaluate_matches_jax(pair, jax_fused, mode):
    """(error, H, b) at the ground-truth pose, world-frame: err rtol 1e-4,
    H and b within 1e-4 of their largest entry (157k lanes summed in two
    orders; XLA:CPU fuses multiply-adds in interpret mode).

    The pair is first moved so that the target's centroid is at the origin.
    The packages sum the centroid in different orders; at the drive's
    ~9 m offset the two centroids differ in the last bit and one source
    point of 20,985 then falls into another voxel, which moves D2D's err by
    1.2e-4 and b by 5.5e-3 of its largest entry.  The aligns above allow for
    that through their pose tolerance."""
    cfg = jndt.NDTConfig(distance_mode=mode, grid_dims=pair["dims"])
    sp, sm, tp, tm, _eye = _args(pair)
    c = tp[tm].astype(np.float64).mean(0)
    sp, tp = (sp - c).astype(np.float32), (tp - c).astype(np.float32)
    pose = (np.linalg.inv(_translation(c)) @ pair["gt"] @ _translation(c)).astype(np.float32)
    e, H, b = ndt.ndt_evaluate(sp, sm, tp, tm, pose, convert.config_from_jax(cfg), device="cpu")
    e_j, H_j, b_j = jndt.ndt_evaluate(*(jnp.asarray(a) for a in (sp, sm, tp, tm, pose)), cfg)
    np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)
    for got, want in ((H, H_j), (b, b_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("mode", ["d2d", "p2d"])
def test_ndt_path_objective_is_what_the_entry_point_solves(pair, fresh, mode):
    """`ndt_path_objective` prepares the state as `ndt_register_fresh`
    (fresh) or `ndt_align` does: an LM solve on it, from the guess in the
    target-centroid frame and back to world, gives the entry point's pose
    and iterations."""
    cfg = ndt.NDTConfig(distance_mode=mode, grid_dims=pair["dims"])
    sp, sm, tp, tm, eye = _args(pair)
    obj, c = ndt.ndt_path_objective(sp, sm, tp, tm, cfg, fresh=fresh, device="cpu")
    assert obj.mode == mode + ("" if fresh else "_raw")
    assert (obj.ca is None) == (mode == "p2d")
    x0 = se3.conjugate_to_centered(torch.as_tensor(eye), c)
    res = lsq_solve(obj.linearize, obj.error, x0, cfg.lsq)
    T = se3.conjugate_from_centered(res.transformation, c)
    if fresh:
        want = ndt.ndt_register_fresh(sp, sm, tp, tm, eye, cfg, device="cpu")[0]
    else:
        want = ndt.ndt_align(sp, sm, tp, tm, eye, cfg, device="cpu")
    torch.testing.assert_close(T, want.transformation, rtol=0, atol=1e-6)
    assert int(res.iterations) == int(want.iterations)


@pytest.mark.parametrize("fresh", [True, False])
def test_ndt_two_phase_ids_form_keeps_the_pack_semantics(pair, fresh):
    """D2D's two-phase solve (refresh_iterations=3) with the lookup form and
    the frozen phase looking its voxels up at the phase-1 pose, against the
    same solve with the eager freeze into a pack and the pack form
    everywhere (the JAX package's freeze): the same pose and iterations,
    bit for bit.  D2D re-freezes M from cov_B at every frozen linearization
    in both (the lookup form reads the rows again)."""
    cfg = ndt.NDTConfig(grid_dims=pair["dims"], refresh_iterations=3)
    sp, sm, tp, tm, eye = _args(pair)
    obj, c = ndt.ndt_path_objective(sp, sm, tp, tm, cfg, fresh=fresh, device="cpu")

    def freeze(x):
        return cuda_ndt.ndt_freeze_pack(obj.p, obj.mask, x, obj.vmap, obj.offsets, obj.mode)

    def frozen(x, pack):
        return cuda_ndt.ndt_linearize(obj.p, obj.ca, x, pack, obj.vmap.resolution, obj.mode)

    eager = obj._replace(linearize=lambda x: frozen(x, freeze(x)), freeze=freeze,
                         linearize_frozen=frozen)
    x0 = se3.conjugate_to_centered(torch.as_tensor(eye), c)
    got, want = (ndt._two_phase_solve(o, x0, cfg) for o in (obj, eager))
    assert torch.equal(got.transformation, want.transformation)
    assert int(got.iterations) == int(want.iterations) > 3


def test_ndt_hash_map_and_unknown_mode_raise(pair):
    """An unknown distance mode is a ValueError at every entry point, on the
    hash map (grid_dims=None, tests/test_torch_ndt_hash.py holds its
    results to JAX's) and on the dense grids."""
    sp, sm, tp, tm, eye = _args(pair)
    cfg = ndt.NDTConfig(distance_mode="p2p")
    calls = [
        lambda c: ndt.ndt_align(sp, sm, tp, tm, eye, c, device="cpu"),
        lambda c: ndt.ndt_register_fresh(sp, sm, tp, tm, eye, c, device="cpu"),
        lambda c: ndt.ndt_prepare_cloud(tp, tm, c, device="cpu"),
        lambda c: ndt.ndt_evaluate(sp, sm, tp, tm, eye, c, device="cpu"),
        lambda c: ndt.ndt_align_prebuilt(sp, sm, None, torch.zeros(3), None, torch.zeros(3),
                                         eye, c, device="cpu"),
        lambda c: ndt.ndt_path_objective(sp, sm, tp, tm, c, fresh=True, device="cpu"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="distance mode"):
            call(cfg)
        with pytest.raises(ValueError, match="distance mode"):
            call(cfg._replace(grid_dims=pair["dims"]))


def test_ndt_config_from_jax():
    cfg = jndt.NDTConfig(distance_mode="p2d", grid_dims=(64, 64, 32), refresh_iterations=3,
                         max_source_voxels=2048)
    got = convert.config_from_jax(cfg)
    assert isinstance(got, ndt.NDTConfig)
    assert got._asdict().keys() == cfg._asdict().keys()
    for name in ndt.NDTConfig._fields:
        if name != "lsq":
            assert getattr(got, name) == getattr(cfg, name), name
    assert tuple(got.lsq) == tuple(cfg.lsq)
    assert ndt.NDTConfig() == convert.config_from_jax(jndt.NDTConfig())
