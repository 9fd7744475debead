"""The class API's and the batch aligns' device programs (`device_loop=True`,
the default: on the card one CUDA graph replay a signature,
`graphs.replay_cached`; here on the CPU the device form's plain version)
against their eager forms (`device_loop=False`) bit for bit.

Every class kind runs the swap workflow (set_input_target /
set_input_source, align, swap_source_and_target, align on the cached
state) in both forms; poses, Hessians, errors, converged, iterations and
every tensor the clouds cache (covariances, NDT maps) must have the same
bits.  The kinds: FastGICP, FastVGICP on the dense raw grid, the hash map
and the grid map (multiplicative, DIRECT7), NDTCuda D2D and P2D on the
dense grid and the hash map, FastGICPMultiPoints.  The pair is
tests/test_torch_classes.py's small pair (frames 30/31 of the seed-0
400k-point drive, 0.3 m downsample) cut to the points within 20 m of the
sensor (~1,600 a cloud), so that the whole file runs in about a minute;
NDTCuda runs at 2 m voxels, where the cut pair's voxels hold the > 6 points
NDT's gate asks for.  The three batch functions run B = 2 pairs of the same
drive in both forms.

The signature (`Registration.signature`, the key a program is cached
under) must change with every setter of every class, the bucket, the
covariances' layout, the states the clouds hold and torch's deterministic
mode, and be equal for two instances with equal settings and padded sizes.
`set_debug_print(True)` takes the eager form.
"""

import inspect

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from fast_gicp_tpu_torch import graphs
from fast_gicp_tpu_torch.models import batch, experimental, gicp, ndt, vgicp
from fast_gicp_tpu_torch.ops import tally
from fast_gicp_tpu_torch.ops.covariance import knn_covariance_cols
from fast_gicp_tpu_torch.utils import downsample, padding, synthetic


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


RADIUS = 20.0  # m: the cut of the small pair


@pytest.fixture(scope="module")
def drive():
    """Frames 30-32 of the seed-0 400k-point drive at 0.3 m, each cut to
    the points within RADIUS of its sensor, and the ground truths."""
    rng = np.random.default_rng(0)
    scans, gt = synthetic.drive_scans(rng, n_frames=33,
                                      world=synthetic.drive_world(rng, n=400_000))
    clouds = []
    for f in (30, 31, 32):
        c = downsample.voxel_downsample(scans[f], 0.3)
        clouds.append(c[np.linalg.norm(c[:, :2], axis=1) < RADIUS])
    return clouds, gt


@pytest.fixture(scope="module")
def pair(drive):
    clouds, _gt = drive
    return dict(target=clouds[0], source=clouds[1])


NDT_RES = {"resolution": 2.0}
KINDS = {
    "fast_gicp": (gicp.FastGICP, {}),
    "fast_vgicp_raw": (vgicp.FastVGICP, {}),
    "fast_vgicp_hash": (vgicp.FastVGICP, {"grid_dims": None}),
    "fast_vgicp_grid_mult": (vgicp.FastVGICP, {"voxel_accumulation": "multiplicative",
                                               "neighbor_search_method": "direct7"}),
    "ndt_d2d_dense": (ndt.NDTCuda, NDT_RES),
    "ndt_p2d_dense": (ndt.NDTCuda, {"distance_mode": "p2d", **NDT_RES}),
    "ndt_d2d_hash": (ndt.NDTCuda, {"grid_dims": None, **NDT_RES}),
    "ndt_p2d_hash": (ndt.NDTCuda, {"distance_mode": "p2d", "grid_dims": None, **NDT_RES}),
    "fast_gicp_multipoints": (experimental.FastGICPMultiPoints, {}),
}


def _bits(t):
    """A tensor's bits (float32 as int32, so NaNs compare too)."""
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _leaves(tree):
    """The tensors of a nested state, in order (None and static values
    dropped)."""
    return [v for v in pytree.tree_leaves(tree) if isinstance(v, torch.Tensor)]


def _same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def _cached(reg):
    """What the clouds cache: NDTCuda's map entries, else the covariances."""
    attr = "ndt_cache" if isinstance(reg, ndt.NDTCuda) else "covs"
    return [getattr(c, attr) for c in (reg._source, reg._target)]


def _workflow(reg, pair):
    """The swap workflow: each align's result and the states cached after
    it (the second align builds P2D's new target map, which the fresh P2D
    align leaves unbuilt)."""
    reg.set_input_target(pair["target"])
    reg.set_input_source(pair["source"])
    out = [reg.align_async()]
    states = [_cached(reg)]
    reg.swap_source_and_target()
    out.append(reg.align_async())
    states.append(_cached(reg))
    return out, states


@pytest.mark.parametrize("kind", list(KINDS))
def test_class_program_bit_for_bit_eager(kind, pair, monkeypatch):
    cls, kw = KINDS[kind]
    programs = []
    real = graphs.replay_cached

    def counted(key, inputs, fn, device):
        programs.append(key)
        return real(key, inputs, fn, device)

    monkeypatch.setattr(graphs, "replay_cached", counted)
    runs = tally.counts("cpu")
    runs.zero_()
    got, got_states = _workflow(cls(device="cpu", **kw), pair)
    assert len(programs) == 2  # one program an align
    got_runs = tally.read("cpu")
    runs.zero_()
    want, want_states = _workflow(cls(device="cpu", device_loop=False, **kw), pair)
    assert len(programs) == 2  # the eager form replays nothing
    # the program runs the eager form's kernels, each as many times
    assert got_runs == tally.read("cpu") and got_runs["lm_step"] > 0
    for g, w in zip(got, want):
        _same_bits(g, w)
    for g, w in zip(got_states, want_states):
        # None where nothing is cached: P2D's source before the swap
        assert [s is None for s in g] == [s is None for s in w]
        _same_bits([s for s in g if s is not None], [s for s in w if s is not None])
    # the swap moved the cached states with their clouds: the second align
    # rebuilt none (P2D built the new target's map)
    assert got_states[1][0] is got_states[0][1]
    assert got_states[0][0] is None or got_states[1][1] is got_states[0][0]
    iters = [int(r.iterations) for r in got]
    assert all(1 <= i <= 64 for i in iters), iters


def _batch_arrays(drive):
    """B = 2 pairs (frames 30/31, 31/32) padded to one size, kNN
    covariances and identity guesses, as tensors."""
    clouds, _gt = drive
    m = padding.bucket_size(max(len(c) for c in clouds))
    pts = np.zeros((3, m, 3), np.float32)
    mask = np.zeros((3, m), bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)], mask[i, :len(c)] = c, True
    p, msk = torch.as_tensor(pts), torch.as_tensor(mask)
    covs = torch.stack([knn_covariance_cols(a, b) for a, b in zip(p, msk)])
    return dict(sp=p[1:], sm=msk[1:], sc=covs[1:], tp=p[:-1], tm=msk[:-1], tc=covs[:-1],
                g=torch.eye(4).repeat(2, 1, 1))


def _batch_call(fn, a, device_loop):
    if fn == "ndt_align_batch":
        return batch.ndt_align_batch(a["sp"], a["sm"], a["tp"], a["tm"], a["g"],
                                     ndt.NDTConfig(resolution=2.0), device="cpu",
                                     device_loop=device_loop)
    if fn == "vgicp_align_batch":
        return batch.vgicp_align_batch(a["sp"], a["sm"], a["sc"], a["tp"], a["tm"], a["tc"],
                                       a["g"], device="cpu", device_loop=device_loop)
    return batch.gicp_align_batch(a["sp"], a["sm"], a["sc"], a["tp"], a["tm"], a["tc"],
                                  a["g"], device="cpu", device_loop=device_loop)


@pytest.mark.parametrize("fn", ["gicp_align_batch", "vgicp_align_batch", "ndt_align_batch"])
def test_batch_program_bit_for_bit_eager(fn, drive, monkeypatch):
    a = _batch_arrays(drive)
    programs = []
    real = graphs.replay_cached

    def counted(key, inputs, body, device):
        programs.append(key)
        return real(key, inputs, body, device)

    monkeypatch.setattr(graphs, "replay_cached", counted)
    got = _batch_call(fn, a, True)
    assert len(programs) == 1  # one program for the B pairs
    want = _batch_call(fn, a, False)
    assert len(programs) == 1
    _same_bits(got, want)
    assert got.transformation.shape == (2, 4, 4)
    assert (got.iterations >= 1).all()


# every setter of each class, with a value other than the default; setters
# that store nothing (set_num_threads, the API-parity no-op) and the ones
# that set the inputs (set_input_*, set_*_covariances) are left out here
COMMON = {
    "set_max_correspondence_distance": (2.0,),
    "set_max_iterations": (32,),
    "set_rotation_epsilon": (1e-3,),
    "set_transformation_epsilon": (1e-4,),
    "set_initial_lambda_factor": (1e-6,),
    "set_optimizer_type": ("gn",),
    "set_debug_print": (True,),
}
COVARIANCE = {
    "set_correspondence_randomness": (10,),
    "set_regularization_method": ("frobenius",),
    "set_nearest_neighbor_method": ("rbf",),
    "set_kernel_params": (0.7,),
}
SETTERS = {
    gicp.FastGICP: {**COMMON, **COVARIANCE},
    vgicp.FastVGICP: {**COMMON, **COVARIANCE, "set_resolution": (0.5,),
                      "set_neighbor_search_method": ("DIRECT27",),
                      "set_voxel_accumulation_mode": ("multiplicative",),
                      "set_grid_dims": (None,)},
    ndt.NDTCuda: {**COMMON, "set_resolution": (0.5,), "set_grid_dims": (None,),
                  "set_distance_mode": ("P2D",),
                  "set_neighbor_search_method": ("DIRECT1",)},
    experimental.FastGICPMultiPoints: {**COMMON, "set_search_radius": (2.0,),
                                       "set_correspondence_randomness": (10,),
                                       "set_regularization_method": ("frobenius",)},
}
EXEMPT = {"set_num_threads", "set_input_source", "set_input_target",
          "set_source_covariances", "set_target_covariances"}
# a second change of the setters whose first value leaves part of them
SETTER_EXTRA = {
    (vgicp.FastVGICP, "set_neighbor_search_method"): ("direct_radius", 2.5),
    (ndt.NDTCuda, "set_neighbor_search_method"): ("direct_radius", 2.5),
    (gicp.FastGICP, "set_kernel_params"): (0.5, 4.0),
    (vgicp.FastVGICP, "set_kernel_params"): (0.5, 4.0),
}


def _holding(cls, pts, **kw):
    reg = cls(device="cpu", **kw)
    reg.set_input_target(pts[0])
    reg.set_input_source(pts[1])
    return reg


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(3)
    return [rng.normal(scale=5.0, size=(300, 3)).astype(np.float32) for _ in range(2)]


def test_setters_enumerated():
    """SETTERS lists every setter of every class (a setter added later
    must join the key test)."""
    for cls, setters in SETTERS.items():
        names = {n for n, _ in inspect.getmembers(cls, inspect.isfunction)
                 if n.startswith("set_")}
        assert names - EXEMPT == set(setters), cls


@pytest.mark.parametrize("cls,setter,args", [
    (cls, name, args) for cls, setters in SETTERS.items() for name, args in setters.items()
] + [(cls, name, args) for (cls, name), args in SETTER_EXTRA.items()],
    ids=lambda v: v.__name__ if isinstance(v, type) else None)
def test_signature_changes_with_every_setter(cls, setter, args, clouds):
    base = _holding(cls, clouds)
    reg = _holding(cls, clouds)
    assert reg.signature() == base.signature()
    getattr(reg, setter)(*args)
    assert reg.signature() != base.signature()


@pytest.mark.parametrize("cls", list(SETTERS), ids=lambda c: c.__name__)
def test_signature_of_sizes_states_and_modes(cls, clouds):
    a, b = _holding(cls, clouds), _holding(cls, clouds)
    assert a.signature() == b.signature() and hash(a.signature()) == hash(b.signature())
    # another bucket pads to another size; another cloud of the same padded
    # size and extent ("auto" grid dims follow the extents) keeps the key
    assert _holding(cls, clouds, bucket=512).signature() != a.signature()
    c = _holding(cls, clouds)
    c.set_input_source(clouds[1][::-1])
    assert c.signature() == a.signature()
    # the form and the deterministic mode
    assert _holding(cls, clouds, device_loop=False).signature() != a.signature()
    torch.use_deterministic_algorithms(True)
    try:
        det = b.signature()
    finally:
        torch.use_deterministic_algorithms(False)
    assert det != a.signature()
    # a cloud that caches its covariances is a path of its own (NDTCuda's
    # maps: test_ndt_cached_states_change_the_signature)
    if cls is not ndt.NDTCuda:
        n = a._source.points.shape[0]
        a._source.covs = torch.zeros(6, n)
        sig_cached = a.signature()
        assert sig_cached != b.signature()
        # the covariances' layout: user-set (N, 3, 3) against (6, N)
        a.set_source_covariances(np.zeros((n, 3, 3), np.float32))
        assert a.signature() not in (sig_cached, b.signature())


def test_ndt_cached_states_change_the_signature(pair):
    reg = ndt.NDTCuda(device="cpu", device_loop=False, **NDT_RES)
    reg.set_input_target(pair["target"])
    reg.set_input_source(pair["source"])
    fresh = reg.signature()
    reg.align()
    assert reg.signature() != fresh  # both maps cached
    reg.swap_source_and_target()
    swapped = reg.signature()
    reg.set_input_source(pair["source"])
    assert reg.signature() not in (fresh, swapped)  # the target's map alone


def test_debug_print_takes_the_eager_form(pair, monkeypatch, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("the program ran with set_debug_print(True)")

    reg = gicp.FastGICP(device="cpu", max_iterations=2)
    reg.set_input_target(pair["target"])
    reg.set_input_source(pair["source"])
    reg.set_debug_print(True)
    monkeypatch.setattr(graphs, "replay_cached", refuse)
    reg.align()
    assert "lm trial 0" in capsys.readouterr().out


def test_nested_program_inputs_round_trip():
    """`replay_cached`'s inputs: tensors nested in tuples, lists, dicts and
    NamedTuples with static fields and None, keyed by a hashable
    `program_key` that names the structure, shapes, dtypes, devices, static
    values and the deterministic mode; `owned` clones every tensor and keeps
    the rest."""
    from fast_gicp_tpu_torch.ops.voxelmap import DenseRawGridMap

    vm = DenseRawGridMap(rows=torch.ones(4, 16), grid=torch.arange(5), origin=torch.zeros(3),
                         resolution=0.5)
    tree = dict(a=torch.zeros(2, 3), state=(vm, None, [torch.ones(1, dtype=torch.bool)]),
                cfg=ndt.NDTConfig())
    key = graphs.program_key("k", tree)
    assert len(_leaves(tree)) == 5 and hash(key) == hash(graphs.program_key("k", tree))
    copy = graphs.owned(tree)
    assert copy["a"] is not tree["a"] and torch.equal(copy["a"], tree["a"])
    assert copy["state"][0].rows is not vm.rows and copy["state"][0].resolution == 0.5
    assert copy["state"][1] is None and copy["cfg"] == ndt.NDTConfig()
    assert graphs.program_key("j", tree) != key
    assert graphs.program_key("k", dict(tree, a=torch.zeros(3, 3))) != key
    assert graphs.program_key("k", dict(tree, a=torch.zeros(2, 3, dtype=torch.float64))) != key
    assert graphs.program_key("k", dict(tree, cfg=ndt.NDTConfig(resolution=2.0))) != key
    assert graphs.program_key("k", dict(tree, state=(vm, torch.zeros(1), []))) != key
    torch.use_deterministic_algorithms(True)
    try:
        assert graphs.program_key("k", tree) != key
    finally:
        torch.use_deterministic_algorithms(False)
