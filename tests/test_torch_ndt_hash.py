"""Port vs JAX: NDT on the hash map and the sparse grid (`_ndt_voxelmap`,
`_compact_source_voxels`, the objective's eager freeze and pack form) and
the `NDTCuda` class, with device="cpu" against the JAX package on the CPU
(its NDT objective's XLA path: the maps here are not the dense grids its
fused Pallas objective takes).

The pair is the full-size synthetic one (frames 30/31 of the seed-0 drive,
0.1 m downsample, padded to 22,528): the CPU tests' 0.3 m pair is too
sparse for NDT's > 6 points gate (tests/test_torch_ndt.py).  Each cloud is
first moved so that its own centroid is at the origin (the ground truth
moved with it): the packages sum centroids in different orders, and at the
drive's ~9 m offset one point of 20,985 then falls into another voxel
(tests/test_torch_ndt.py, `test_ndt_evaluate_matches_jax`); about the
origin no point sits on a voxel face, so the maps' integer fields are equal
and the aligns run the same iterations.  Every JAX align the tests compare
with is first held to the accuracy limits itself: D2D within 0.05 m / 1 deg
(gicp_test.cpp:148-149), P2D within twice that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu.models import ndt as jndt
from fast_gicp_tpu.ops import voxelmap as jvm
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch.models import ndt
from fast_gicp_tpu_torch.ops import voxelmap
from fast_gicp_tpu_torch.ops.voxelmap import GridVoxelMap, VoxelMap
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic
from tests.torch_cpu import warm_intra_op_threads

LIMITS = {"d2d": (0.05, 1.0), "p2d": (0.10, 2.0)}
INTS = {"hash": ("counts", "coords", "table", "lut", "num_voxels"),
        "grid": ("counts", "coords", "grid", "origin", "num_voxels")}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch ops: the suite runs six
    test processes on the host's cores, and torch's default of one thread
    a core in each slows every process."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def _warm_threads():
    warm_intra_op_threads()


def _translation(c):
    T = np.eye(4)
    T[:3, 3] = c
    return T


@pytest.fixture(scope="module")
def pair():
    """The full-size pair, each cloud about its own centroid; `dims` are
    grid dims over both clouds, as NDTCuda sizes them."""
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    target = downsample.voxel_downsample(scans[30], 0.1).astype(np.float64)
    source = downsample.voxel_downsample(scans[31], 0.1).astype(np.float64)
    ct, cs = target.mean(0), source.mean(0)
    target, source = (target - ct).astype(np.float32), (source - cs).astype(np.float32)
    sp, sm = padding.pad_points(source)
    tp, tm = padding.pad_points(target)
    dims = voxelmap.auto_grid_dims_from_extent(np.minimum(source.min(0), target.min(0)),
                                               np.maximum(source.max(0), target.max(0)), 1.0)
    gt = np.linalg.inv(_translation(ct)) @ np.linalg.inv(gt[30]) @ gt[31] @ _translation(cs)
    return dict(sp=sp, sm=sm, tp=tp, tm=tm, dims=dims, gt=gt, source=source, target=target)


def _dims(pair, kind):
    return None if kind == "hash" else pair["dims"]


@pytest.fixture(scope="module")
def maps(pair):
    """{kind: (port map, JAX map)} of the target by `_ndt_voxelmap`."""
    out = {}
    for kind in ("hash", "grid"):
        got = ndt._ndt_voxelmap(torch.as_tensor(pair["tp"]), torch.as_tensor(pair["tm"]), 1.0,
                                _dims(pair, kind))
        want = jndt._ndt_voxelmap(jnp.asarray(pair["tp"]), jnp.asarray(pair["tm"]), 1.0,
                                  _dims(pair, kind))
        out[kind] = (got, want)
    return out


@pytest.mark.parametrize("kind", ["hash", "grid"])
def test_ndt_voxelmap_matches_jax(maps, kind):
    """The integer fields equal JAX's; `packed` (the MIN_EIG-clamped
    rows) and `covs` within 1e-5 of each occupied row's largest entry."""
    got, want = maps[kind]
    assert isinstance(got, VoxelMap if kind == "hash" else GridVoxelMap)
    for f in INTS[kind]:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    occ = np.asarray(want.counts) > 0
    for g, w in ((got.packed.numpy(), np.asarray(want.packed)),
                 (got.covs.numpy().reshape(-1, 9), np.asarray(want.covs).reshape(-1, 9))):
        scale = np.abs(w[occ]).max(1)
        assert (np.abs(g[occ] - w[occ]).max(1) <= 1e-5 * scale).all()
        np.testing.assert_array_equal(g[~occ], w[~occ])
    assert got.packed.is_contiguous()


@pytest.mark.parametrize("kind", ["hash", "grid"])
def test_compact_source_voxels_matches_jax(maps, kind):
    """The occupied voxels in ascending id, filled with voxel 0 past the
    count, at a budget below the occupied count (overflow) and above it."""
    got_map, want_map = maps[kind]
    n_occ = int(want_map.num_voxels)
    for budget in (n_occ // 2, n_occ + 1000):
        got = ndt._compact_source_voxels(got_map, budget)
        want = jndt._compact_source_voxels(want_map, budget)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[1].sum()) == min(budget, n_occ)
        for g, w in ((got[0], want[0]), (got[2], want[2])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["d2d", "p2d"])
@pytest.mark.parametrize("kind", ["hash", "grid"])
def test_ndt_objective_on_voxel_maps_matches_jax(pair, maps, kind, mode):
    """[err, H, b] of `make_ndt_objective` on the maps at the ground-truth
    pose (the eager freeze, then the pack form): err rtol 1e-4, H and b
    within 1e-4 of their largest entry; the frozen pack's validity equal to
    JAX's freeze, misses never valid."""
    got_map, want_map = maps[kind]
    offsets = voxelmap.neighbor_offsets("direct7")
    sp, sm = torch.as_tensor(pair["sp"]), torch.as_tensor(pair["sm"])
    if mode == "d2d":
        src = ndt._compact_source_voxels(ndt._ndt_voxelmap(sp, sm, 1.0, _dims(pair, kind)), 4096)
        jsrc = jndt._compact_source_voxels(
            jndt._ndt_voxelmap(jnp.asarray(pair["sp"]), jnp.asarray(pair["sm"]), 1.0,
                               _dims(pair, kind)), 4096)
    else:
        src, jsrc = (sp, sm, None), (jnp.asarray(pair["sp"]), jnp.asarray(pair["sm"]), None)
    obj = ndt.make_ndt_objective(*src, got_map, offsets)
    jlin, _jerr, jfreeze, _jlf, _jpa = jndt.make_ndt_objective(
        *jsrc, want_map, jnp.asarray(offsets), jndt.NDTConfig(distance_mode=mode),
        with_freeze=True)
    x = pair["gt"].astype(np.float32)
    err, H, b, aux = obj.linearize(torch.as_tensor(x))
    e_j, H_j, b_j, _aux_j = jlin(jnp.asarray(x))
    np.testing.assert_allclose(float(err), float(e_j), rtol=1e-4)
    for g, w in ((H, H_j), (b, b_j)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())
    valid_j = np.asarray(jfreeze(jnp.asarray(x))[2]).reshape(-1)
    pack = obj.freeze(torch.as_tensor(x))
    np.testing.assert_array_equal(pack[:, 9].numpy() > 0, valid_j)
    np.testing.assert_array_equal(aux[6].numpy() > 0, valid_j)


def _t_err(T, pair):
    return float(np.linalg.norm((np.linalg.inv(pair["gt"]) @ T.astype(np.float64))[:3, 3]))


def _compare(got, want, pair, mode):
    """Both within the limits (JAX first); poses within 1e-3, the same
    iterations, both converged."""
    got, want = convert.lsq_result_to_numpy(got), convert.lsq_result_to_numpy(want)
    t_lim, r_lim = LIMITS[mode]
    for T in (want.transformation, got.transformation):
        d = np.linalg.inv(pair["gt"]) @ T.astype(np.float64)
        r = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
        assert _t_err(T, pair) < t_lim and r < r_lim
    np.testing.assert_allclose(got.transformation, want.transformation, atol=1e-3)
    assert got.iterations == want.iterations
    assert got.converged and want.converged


def _args(pair):
    return tuple(pair[k] for k in ("sp", "sm", "tp", "tm")) + (np.eye(4, dtype=np.float32),)


@pytest.mark.parametrize("entry, mode", [("ndt_align", "d2d"), ("ndt_register_fresh", "d2d"),
                                         ("ndt_register_fresh", "p2d")])
def test_ndt_hash_aligns_match_jax(pair, entry, mode):
    """`ndt_align` and `ndt_register_fresh` with grid_dims=None (the hash
    map; `ndt_register_fresh` prepares each cloud's map and, for D2D, its
    compact statistics in the cloud's own frame).  P2D on the hash map
    (157,696 lanes) runs once, through the fresh align: `ndt_align` builds
    the same target map in the target's frame."""
    cfg = jndt.NDTConfig(distance_mode=mode)
    res = getattr(ndt, entry)(*_args(pair), convert.config_from_jax(cfg), device="cpu")
    jres = getattr(jndt, entry)(*(jnp.asarray(a) for a in _args(pair)), cfg)
    if entry == "ndt_register_fresh":
        res, tstate, sstate = res
        jres = jres[0]
        assert isinstance(tstate[0], VoxelMap) and (sstate is None) == (mode == "p2d")
    _compare(res, jres, pair, mode)


@pytest.mark.parametrize("grid", ["auto", None])
def test_ndt_cuda_class_cache_moves_on_swap(pair, grid):
    """NDTCuda (D2D, the dense "auto" grid and the hash map): the fresh
    align fills both clouds' caches, the swap moves them with the clouds
    (tests/test_registration.py asks the same of JAX), an align after the
    swap builds no map and equals `ndt_align_prebuilt` on the cached
    state, an align again equals the fresh one bit for bit, and
    clear_covariances drops the caches.  The fresh pose agrees with JAX's
    NDTCuda within 1e-3."""
    reg = ndt.NDTCuda(device="cpu", grid_dims=grid)
    reg.set_input_target(pair["target"])
    reg.set_input_source(pair["source"])
    T1 = reg.align()
    src, tgt = reg._source, reg._target
    assert src.ndt_cache is not None and tgt.ndt_cache is not None
    key = src.ndt_cache[0]
    assert key == tgt.ndt_cache[0] and key[1] == (None if grid is None else reg._grid_dims(src, tgt))
    T1_again = reg.align()
    np.testing.assert_array_equal(T1_again, T1)  # the cached align is the fresh one
    reg.swap_source_and_target()
    assert reg._source is tgt and reg._target is src
    caches = (src.ndt_cache, tgt.ndt_cache)
    T2 = reg.align()
    assert (src.ndt_cache, tgt.ndt_cache) == caches  # no map was built again
    assert np.linalg.norm((pair["gt"] @ T2)[:3, 3]) < 0.05  # the inverse pose
    reg.clear_covariances()
    assert src.ndt_cache is None and tgt.ndt_cache is None
    jreg = jndt.NDTCuda(grid_dims=grid)
    jreg.set_input_target(pair["target"])
    jreg.set_input_source(pair["source"])
    np.testing.assert_allclose(T1, np.asarray(jreg.align()), atol=1e-3)


def test_ndt_cuda_setters_and_p2d_cache():
    """The setters take the reference's spellings; P2D's fresh align caches
    the target only, and a later D2D align does not reuse that entry."""
    reg = ndt.NDT(device="cpu")
    reg.set_distance_mode("P2D")
    reg.set_neighbor_search_method("DIRECT1", 2.0)
    reg.set_resolution(2)
    reg.set_grid_dims(None)
    assert (reg.distance_mode, reg.neighbor_search_method, reg.neighbor_search_radius,
            reg.resolution, reg.grid_dims) == ("p2d", "direct1", 2.0, 2.0, None)
    reg.set_grid_dims([8, 8, 8])
    assert reg.grid_dims == (8, 8, 8)
    with pytest.raises(ValueError, match="distance mode"):
        reg.set_distance_mode("p2p")
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(3000, 3)) * [4.0, 4.0, 1.0]).astype(np.float32)
    reg = ndt.NDTCuda(device="cpu", grid_dims=None, distance_mode="p2d", max_iterations=2)
    reg.set_input_target(pts)
    reg.set_input_source(pts + np.float32(0.05))
    reg.align()
    assert reg._target.ndt_cache is not None and reg._source.ndt_cache is None
    reg.set_distance_mode("d2d")
    reg.align()
    assert reg._source.ndt_cache[0][3] == reg._target.ndt_cache[0][3] == "d2d"
    assert np.isfinite(reg.evaluate_cost(np.eye(4)))
