"""The port stands alone: `fast_gicp_tpu_torch` (and chip_smoke.py) import
neither JAX nor the JAX package, the entry points default to CUDA and
raise without it, and a kernel wrapper given CPU tensors takes its plain
version without counting a launch."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "fast_gicp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "fast_gicp_tpu")


def test_import_leaves_no_jax_in_sys_modules():
    code = (
        "import sys, fast_gicp_tpu_torch, fast_gicp_tpu_torch.convert\n"
        "import fast_gicp_tpu_torch.ops.cuda_kernels, fast_gicp_tpu_torch.ops.cuda_linearize\n"
        "import fast_gicp_tpu_torch.ops.cuda_solver, fast_gicp_tpu_torch.utils.io\n"
        "import fast_gicp_tpu_torch.utils.synthetic, fast_gicp_tpu_torch.utils.downsample\n"
        "import fast_gicp_tpu_torch.models.gicp, fast_gicp_tpu_torch.models.metrics\n"
        "import fast_gicp_tpu_torch.ops.neighbors, fast_gicp_tpu_torch.ops.covariance\n"
        "import fast_gicp_tpu_torch.ops.cuda_ndt, fast_gicp_tpu_torch.models.ndt\n"
        "import fast_gicp_tpu_torch.native, fast_gicp_tpu_torch.models.base\n"
        "import fast_gicp_tpu_torch.models.vgicp, fast_gicp_tpu_torch.ops.voxelmap\n"
        "import fast_gicp_tpu_torch.models.experimental, fast_gicp_tpu_torch.models.batch\n"
        "import fast_gicp_tpu_torch.pygicp, fast_gicp_tpu_torch.models.scan_to_map\n"
        "import fast_gicp_tpu_torch.utils.kitti, fast_gicp_tpu_torch.apps.kitti\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from fast_gicp_tpu_torch.models.gicp import gicp_align, gicp_register_fresh
    from fast_gicp_tpu_torch.models.metrics import fitness_score
    from fast_gicp_tpu_torch.models.vgicp import (
        VGICPConfig, vgicp_align, vgicp_register,
    )
    from fast_gicp_tpu_torch.ops.covariance import knn_covariances, rbf_covariances

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((2048, 3), np.float32)
    mask = np.ones(2048, bool)
    eye = np.eye(4, dtype=np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32), (2048, 1, 1))
    cfg = VGICPConfig(grid_dims=(32, 32, 32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vgicp_register(pts, mask, pts, mask, eye, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vgicp_align(pts, mask, covs, pts, mask, covs, eye, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rbf_covariances(pts, mask)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gicp_register_fresh(pts, mask, pts, mask, eye)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gicp_align(pts, mask, covs, pts, mask, covs, eye)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        knn_covariances(pts, mask)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fitness_score(eye, pts, mask, pts, mask)


def test_classes_and_map_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """The class API and the VGICP and voxel-map entry points of the hash
    and grid maps run on the card unless the caller asks for the CPU."""
    from fast_gicp_tpu_torch.models.gicp import FastGICP, FastGICPSingleThread
    from fast_gicp_tpu_torch.models.vgicp import (
        FastVGICP, FastVGICPCuda, VGICPConfig, vgicp_evaluate, vgicp_mahalanobis,
        vgicp_register_fresh,
    )
    from fast_gicp_tpu_torch.ops.voxelmap import build_voxelmap

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((2048, 3), np.float32)
    mask = np.ones(2048, bool)
    eye = np.eye(4, dtype=np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32), (2048, 1, 1))
    cfg = VGICPConfig()
    calls = [
        lambda **kw: FastGICP(**kw), lambda **kw: FastGICPSingleThread(**kw),
        lambda **kw: FastVGICP(**kw), lambda **kw: FastVGICPCuda(**kw),
        lambda **kw: vgicp_register_fresh(pts, mask, pts, mask, eye, cfg, **kw),
        lambda **kw: vgicp_evaluate(pts, mask, covs, pts, mask, covs, eye, cfg, **kw),
        lambda **kw: vgicp_mahalanobis(pts, mask, covs, pts, mask, covs, eye, cfg, **kw),
        lambda **kw: build_voxelmap(pts, mask, 1.0, covs=covs, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    reg = FastVGICP(device="cpu")
    assert reg.device == torch.device("cpu")
    reg.set_input_source(pts[:100])
    assert reg._source.points.device.type == "cpu"
    vmap = build_voxelmap(pts, mask, 1.0, covs=covs, device="cpu")
    assert vmap.packed.device.type == "cpu" and int(vmap.num_voxels) == 1


class _HashFields:
    """The fields of a JAX hash-table `VoxelMap`, as numpy."""

    means = np.zeros((4, 3), np.float32)
    covs = np.zeros((4, 3, 3), np.float32)
    counts = np.zeros(4, np.int32)
    coords = np.zeros((4, 3), np.int32)
    table = np.full(32, 2**30, np.int32)
    num_voxels = np.int32(0)
    resolution = np.float32(1.0)
    packed = np.zeros((4, 16), np.float32)
    lut = np.zeros((32, 4), np.int32)


class _GridFields(_HashFields):
    """The fields of a JAX `GridVoxelMap`, as numpy (grid8 is not read)."""

    grid = np.full((4, 4, 4), -1, np.int32)
    grid8 = np.full((9, 8), -1, np.int32)
    origin = np.zeros(3, np.int32)


def test_convert_helpers_default_to_cuda_and_raise_without_it(monkeypatch):
    """The helpers that carry the JAX package's state into the port put
    their tensors on the card unless the caller asks for the CPU."""
    from fast_gicp_tpu_torch import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid8 = np.zeros((9, 8), np.int32)
    rows = np.zeros((4, 16), np.float32)
    calls = [
        lambda **kw: convert.covs_from_numpy(np.zeros((6, 4), np.float32), **kw),
        lambda **kw: convert.raw_grid_from_numpy(rows, grid8, np.zeros(3, np.int32), 1.0, **kw),
        lambda **kw: convert.raw_ndt_grid_from_numpy(rows, grid8, np.zeros(3, np.int32), 1.0,
                                                     (4, 4, 4), **kw),
        lambda **kw: convert.ndt_grid_map_from_numpy(rows, grid8, np.zeros(3, np.int32), 1.0,
                                                     (4, 4, 4), **kw),
        lambda **kw: convert.ndt_stats_from_numpy(np.zeros((4, 3), np.float32), np.ones(4, bool),
                                                  np.zeros((6, 4), np.float32), **kw),
        lambda **kw: convert.voxel_map_from_numpy(_HashFields(), **kw),
        lambda **kw: convert.grid_voxel_map_from_numpy(_GridFields(), **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        out = call(device="cpu")
        tensors = out if isinstance(out, tuple) else [out]
        assert all(t.device.type == "cpu" for t in tensors if isinstance(t, torch.Tensor))


def test_wrappers_take_plain_version_on_cpu_without_counting():
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize, cuda_solver

    wrappers = (cuda_kernels.rbf_moments, cuda_linearize.linearize_raw,
                cuda_linearize.error, cuda_solver.lm_trial, cuda_kernels.nn_search,
                cuda_kernels.knn_moments, cuda_linearize.linearize)
    for fn in wrappers:
        fn.launches = 0
    rng = np.random.default_rng(0)
    n = 256
    pts = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    mask = torch.ones(n, dtype=torch.bool)
    m = cuda_kernels.rbf_moments(pts, mask, pts, mask, pts.mean(0), 0.5, 3.0)
    assert m.shape == (16, n) and m.device.type == "cpu"
    rows = torch.zeros((n, 16))
    rows[:, 0] = 2.0
    rows[:, 1:4] = 2.0 * pts
    rows[:, [4, 8, 12]] = 2.0
    x = torch.eye(4)
    ca = torch.zeros((6, n))
    ca[[0, 3, 5]] = 1.0
    err, H, b, aux = cuda_linearize.linearize_raw(pts.T.contiguous(), ca, x, rows,
                                                  torch.ones(n))
    e = cuda_linearize.error(pts.T.contiguous(), x, aux)
    xi, delta, d, denom = cuda_solver.lm_trial(
        H + torch.eye(6), b, torch.tensor([0.1]), x)
    assert float(err) == pytest.approx(0.0, abs=1e-4) and float(e) == pytest.approx(0.0, abs=1e-4)
    assert xi.shape == (4, 4) and d.shape == (6,)
    idx, sq = cuda_kernels.nn_search(pts, pts, mask)
    assert idx.tolist() == list(range(n)) and float(sq.max()) == 0.0
    mom, kth = cuda_kernels.knn_moments(pts, mask, pts, mask,
                                        torch.zeros((1, 2), dtype=torch.int32), 20)
    assert mom.shape == (10, n) and kth.shape == (n,)
    fin = torch.cat([pts, torch.eye(3).reshape(1, 9).expand(n, 9), torch.ones((n, 1)),
                     torch.zeros((n, 3))], dim=1)
    err, _H, _b, _aux = cuda_linearize.linearize(pts.T.contiguous(), ca, x, fin,
                                                 torch.ones(n))
    assert float(err) == pytest.approx(0.0, abs=1e-4)
    assert all(fn.launches == 0 for fn in wrappers)


def _idx_inputs(device, n=256, t=64):
    """GICP linearize inputs on `device` with a row table of t finalized rows
    and int64 ids (n,) into it."""
    rng = np.random.default_rng(1)
    p = torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32), device=device)
    ca = torch.zeros((6, n), device=device)
    ca[[0, 3, 5]] = 1.0
    table = torch.zeros((t, 16), device=device)
    table[:, 0:3] = torch.as_tensor(rng.normal(size=(t, 3)).astype(np.float32))
    table[:, [3, 7, 11, 12]] = 1.0
    ids = torch.as_tensor(rng.integers(0, t, n), device=device)
    return p, ca, torch.eye(4, device=device), table, torch.ones(n, device=device), ids


def test_idx_wrappers_take_plain_version_on_cpu_without_counting():
    """The idx form of both linearize wrappers, int32 and int64 ids, on CPU
    tensors: the plain version on table[ids], no launch counted."""
    from fast_gicp_tpu_torch.ops import cuda_linearize

    wrappers = (cuda_linearize.linearize, cuda_linearize.linearize_raw)
    for fn in wrappers:
        fn.launches = fn.idx_launches = 0
    p, ca, x, table, valid, ids = _idx_inputs("cpu")
    for fn in wrappers:
        for dt in (torch.int32, torch.int64):
            got = fn(p, ca, x, table, valid, ids.to(dt))
            want = fn(p, ca, x, table[ids], valid)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert got[3].device.type == "cpu"
    assert all(fn.launches == 0 and fn.idx_launches == 0 for fn in wrappers)


def test_idx_wrappers_reject_bad_ids_and_mixed_devices():
    """float, 2-D or short ids and a table whose rows are not 16 floats are
    refused on every device; ids or a table on another device than the rest
    are refused, never taken as CPU tensors."""
    from fast_gicp_tpu_torch.ops import cuda_linearize

    p, ca, x, table, valid, ids = _idx_inputs("cpu")
    meta = _idx_inputs("meta")
    for fn in (cuda_linearize.linearize, cuda_linearize.linearize_raw):
        for bad in (ids.float(), ids.reshape(16, 16), ids[:-1], meta[5].float()):
            with pytest.raises(ValueError, match="idx"):
                fn(p, ca, x, table, valid, bad)
        with pytest.raises(ValueError, match="rows"):
            fn(p, ca, x, table[:, :13], valid, ids)
        with pytest.raises(ValueError, match="several devices"):
            fn(p, ca, x, table, valid, meta[5])
        with pytest.raises(ValueError, match="several devices"):
            fn(p, ca, x, meta[3], valid, ids)
        with pytest.raises(ValueError, match="unsupported device meta"):
            fn(*meta)


def _lm_step_inputs(device, n=256):
    """A state, normal equations and a GICP trial cost on `device`."""
    from fast_gicp_tpu_torch.ops import cuda_solver

    p, _ca, x, _pack = _ndt_inputs(device, n)
    aux = torch.zeros((10, n), device=device)
    aux[[0, 3, 5, 6]] = 1.0
    return (cuda_solver.lm_state(x), torch.eye(6, device=device),
            torch.zeros(6, device=device), torch.zeros((), device=device), aux,
            cuda_solver.TrialCost(p))


def test_lm_step_takes_plain_version_on_cpu_without_counting():
    from fast_gicp_tpu_torch.ops import cuda_linearize, cuda_solver
    from fast_gicp_tpu_torch.solver import LsqConfig

    wrappers = (cuda_solver.lm_step, cuda_solver.lm_trial, cuda_linearize.error)
    for fn in wrappers:
        fn.launches = 0
    state, H, b, y0, aux, cost = _lm_step_inputs("cpu")
    cuda_solver.lm_step(state, H, b, y0, aux, cost, True, LsqConfig())
    # b = 0: a zero step, delta = I, converged; yi = y0 = 0 accepts it
    assert state[cuda_solver.STATE_DONE].item() == 1.0
    assert state[cuda_solver.STATE_CONV].item() == 1.0
    assert torch.equal(state[cuda_solver.STATE_X], torch.eye(4).reshape(16))
    assert all(fn.launches == 0 for fn in wrappers)


def test_lm_step_raises_for_tensors_on_other_devices():
    """No fallback: a state that is not on the CPU never takes the plain
    version; a mix of devices, another device than CUDA and a cost that is
    not a TrialCost are refused."""
    from fast_gicp_tpu_torch.ops import cuda_solver
    from fast_gicp_tpu_torch.solver import LsqConfig

    cfg = LsqConfig()
    state, H, b, y0, aux, cost = _lm_step_inputs("meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_solver.lm_step(state, H, b, y0, aux, cost, True, cfg)
    cpu_state, cpu_H = _lm_step_inputs("cpu")[:2]
    with pytest.raises(ValueError, match="several devices"):
        cuda_solver.lm_step(state, cpu_H, b, y0, aux, cost, True, cfg)
    with pytest.raises(ValueError, match="several devices"):
        cuda_solver.lm_step(cpu_state, H, b, y0, aux, cost, True, cfg)
    with pytest.raises(ValueError, match="TrialCost"):
        cuda_solver.lm_step(state, H, b, y0, aux, lambda x, a: x.sum(), True, cfg)


def test_ndt_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from fast_gicp_tpu_torch.models import ndt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((2048, 3), np.float32)
    mask = np.ones(2048, bool)
    eye = np.eye(4, dtype=np.float32)
    cfg = ndt.NDTConfig(grid_dims=(32, 32, 32))
    calls = [
        lambda: ndt.ndt_register_fresh(pts, mask, pts, mask, eye, cfg),
        lambda: ndt.ndt_align(pts, mask, pts, mask, eye, cfg),
        lambda: ndt.ndt_prepare_cloud(pts, mask, cfg),
        lambda: ndt.ndt_evaluate(pts, mask, pts, mask, eye, cfg),
        lambda: ndt.ndt_align_prebuilt(pts, mask, None, torch.zeros(3), None,
                                       torch.zeros(3), eye, cfg._replace(distance_mode="p2d")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_ndt_class_and_slice_e_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """NDTCuda (and its alias NDT), the hash-map NDT entry points,
    FastGICPMultiPoints and multipoint_align, the three batch aligns and
    pygicp.align_points run on the card unless the caller asks for the
    CPU."""
    import fast_gicp_tpu_torch as pkg
    from fast_gicp_tpu_torch import pygicp
    from fast_gicp_tpu_torch.models import batch, experimental, ndt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((2048, 3), np.float32)
    mask = np.ones(2048, bool)
    eye = np.eye(4, dtype=np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32), (2048, 1, 1))
    b = lambda a: a[None]  # noqa: E731  (a batch of one)
    cfg = ndt.NDTConfig()  # grid_dims None: the hash map
    calls = [
        lambda **kw: ndt.NDTCuda(**kw), lambda **kw: ndt.NDT(**kw),
        lambda **kw: experimental.FastGICPMultiPoints(**kw),
        lambda **kw: experimental.multipoint_align(pts, mask, covs, pts, mask, covs, eye, **kw),
        lambda **kw: ndt.ndt_align(pts, mask, pts, mask, eye, cfg, **kw),
        lambda **kw: ndt.ndt_register_fresh(pts, mask, pts, mask, eye, cfg, **kw),
        lambda **kw: ndt.ndt_prepare_cloud(pts, mask, cfg, **kw),
        lambda **kw: ndt.ndt_evaluate(pts, mask, pts, mask, eye, cfg, **kw),
        lambda **kw: batch.gicp_align_batch(b(pts), b(mask), b(covs), b(pts), b(mask),
                                            b(covs), b(eye), **kw),
        lambda **kw: batch.vgicp_align_batch(b(pts), b(mask), b(covs), b(pts), b(mask),
                                             b(covs), b(eye), **kw),
        lambda **kw: batch.ndt_align_batch(b(pts), b(mask), b(pts), b(mask), b(eye), **kw),
        lambda **kw: pygicp.align_points(pts, pts, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert pkg.NDT is pkg.NDTCuda is ndt.NDTCuda
    assert ndt.NDTCuda(device="cpu").device == torch.device("cpu")
    for method in ("GICP", "VGICP", "VGICP_CUDA", "NDT_CUDA"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pygicp._make_reg(method, 20, 1.0, 1.0, "DIRECT1", 1.5)
        assert pygicp._make_reg(method, 20, 1.0, 1.0, "DIRECT1", 1.5,
                                device="cpu").device.type == "cpu"


def test_hash_ndt_freeze_and_pack_form_on_cpu_without_counting():
    """On the hash map the NDT objective's linearization is the eager freeze
    and the pack-form wrapper, which on CPU tensors takes the plain version
    and counts no launch; a miss is never valid."""
    from fast_gicp_tpu_torch.models import ndt
    from fast_gicp_tpu_torch.ops import cuda_ndt, voxelmap

    rng = np.random.default_rng(3)
    pts = torch.as_tensor((rng.normal(size=(512, 3)) * [2.0, 2.0, 0.5]).astype(np.float32))
    mask = torch.ones(512, dtype=torch.bool)
    vmap = ndt._ndt_voxelmap(pts, mask, 1.0)
    offsets = voxelmap.neighbor_offsets("direct7")
    obj = ndt.make_ndt_objective(pts + 0.1, mask, None, vmap, offsets)
    before = {m: f.launches for m, f in cuda_ndt._BY_MODE.items()}
    x = torch.eye(4)
    pack = obj.freeze(x)
    assert pack.shape == (7 * 512, 16) and obj.mode == "p2d"
    vids = voxelmap.lookup_voxels_cols(vmap, *cuda_ndt._query(obj.p, x, vmap, offsets))
    assert not (pack[:, 9].reshape(7, 512) > 0)[vids < 0].any()
    err, H, b, aux = obj.linearize(x)
    assert torch.isfinite(err) and torch.equal(aux[6], pack[:, 9])
    assert {m: f.launches for m, f in cuda_ndt._BY_MODE.items()} == before
    with pytest.raises(ValueError, match="does not take a VoxelMap"):
        cuda_ndt.ndt_freeze_pack(obj.p, mask, x, vmap, offsets, "p2d_raw")


def _ndt_inputs(device, n=256):
    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32), device=device)
    ca = torch.zeros((6, n), device=device)
    ca[[0, 3, 5]] = 0.1
    pack = torch.zeros((n, 16), device=device)
    pack[:, 0:3] = p.T
    pack[:, [3, 6, 8]] = 1.0  # cov_B = M = I
    pack[:, 9] = 1.0
    return p, ca, torch.eye(4, device=device), pack


def test_ndt_wrappers_take_plain_version_on_cpu_without_counting():
    from fast_gicp_tpu_torch.ops import cuda_ndt

    wrappers = (cuda_ndt.ndt_linearize_d2d, cuda_ndt.ndt_linearize_p2d,
                cuda_ndt.ndt_linearize_d2d_raw, cuda_ndt.ndt_linearize_p2d_raw,
                cuda_ndt.ndt_error)
    for fn in wrappers:
        fn.launches = 0
    p, ca, x, pack = _ndt_inputs("cpu")
    for mode in cuda_ndt.MODES:
        err, H, b, aux = cuda_ndt.ndt_linearize(p, ca, x, pack, 1.0, mode)
        assert aux.shape == (10, 256) and aux.device.type == "cpu"
        assert float(cuda_ndt.ndt_error(p, aux, x, 1.0)) == pytest.approx(float(err), abs=1e-4)
    assert float(cuda_ndt.ndt_linearize(p, ca, x, pack, 1.0, "p2d")[0]) == 0.0
    assert all(fn.launches == 0 for fn in wrappers)


def test_wrappers_raise_for_tensors_on_other_devices():
    """No fallback: a tensor that is not on the CPU never takes the plain
    version; what is not a CUDA tensor is refused."""
    from fast_gicp_tpu_torch.ops import cuda_linearize, cuda_ndt

    p, ca, x, pack = _ndt_inputs("meta")
    for mode in cuda_ndt.MODES:
        with pytest.raises(ValueError, match="unsupported device meta"):
            cuda_ndt.ndt_linearize(p, ca, x, pack, 1.0, mode)
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_ndt.ndt_error(p, torch.zeros((10, 256), device="meta"), x, 1.0)
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_linearize.linearize(p, ca, x, pack, torch.ones(256, device="meta"))


def _ndt_map_inputs(device, raw, n=64):
    """Lookup-form inputs on `device`: p (3, n), ca, mask, x, a voxel map
    built on the CPU from the source points and moved, offsets DIRECT7."""
    from fast_gicp_tpu_torch.ops import voxelmap

    p, ca, x, _pack = _ndt_inputs("cpu", n)
    pts = torch.cat([p.T, p.T + 0.05, p.T - 0.05, p.T * 1.01] * 2)
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    dims = voxelmap.auto_grid_dims(pts.numpy(), 1.0)
    if raw:
        vmap = voxelmap.build_ndt_raw_grid(pts, mask, 1.0, dims)
    else:
        vmap = voxelmap.build_ndt_grid_compact(pts, mask, 1.0, dims, budget=128)[0]
    vmap = type(vmap)(*(t.to(device) if isinstance(t, torch.Tensor) else t for t in vmap))
    smask = torch.ones(n, dtype=torch.bool)
    return (p.to(device), ca.to(device), smask.to(device), x.to(device), vmap,
            voxelmap.neighbor_offsets("direct7"))


def test_ndt_lookup_wrappers_take_plain_version_on_cpu_without_counting():
    """The lookup form on CPU tensors, at one pose and with another lookup
    pose: its plain version (the eager freeze, then `ndt_linearize_plain`),
    no launch counted in any form."""
    from fast_gicp_tpu_torch.ops import cuda_ndt

    wrappers = [cuda_ndt._BY_MODE[m] for m in cuda_ndt.MODES]
    for fn in wrappers:
        fn.launches = fn.lookup_launches = 0
    for mode in cuda_ndt.MODES:
        p, ca, mask, x, vmap, offsets = _ndt_map_inputs("cpu", mode.endswith("_raw"))
        got = cuda_ndt.ndt_linearize_lookup(p, ca, mask, x, vmap, offsets, mode)
        assert got[3].shape == (10, 7 * 64) and got[3].device.type == "cpu"
        assert got[3][6].sum() > 0
        again = cuda_ndt.ndt_linearize_lookup(p, ca, mask, x, vmap, offsets, mode,
                                              x_lookup=x.clone())
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(fn.launches == 0 and fn.lookup_launches == 0 for fn in wrappers)


def test_ndt_lookup_wrappers_reject_bad_input_and_mixed_devices():
    """Bad shapes and dtypes, a map of the other kind, too many offsets, a
    bad lookup pose and tensors on several devices are refused on every
    device; tensors that are not on the CPU never take the plain version."""
    from fast_gicp_tpu_torch.ops import cuda_ndt

    p, ca, mask, x, vmap, offsets = _ndt_map_inputs("cpu", raw=True)
    fin = _ndt_map_inputs("cpu", raw=False)[4]
    look = cuda_ndt.ndt_linearize_lookup
    with pytest.raises(ValueError, match="mask"):
        look(p, ca, mask.float(), x, vmap, offsets, "d2d_raw")
    with pytest.raises(ValueError, match="p: expected"):
        look(p[:, :-1], ca, mask, x, vmap, offsets, "d2d_raw")
    with pytest.raises(ValueError, match="ca"):
        look(p, None, mask, x, vmap, offsets, "d2d_raw")
    with pytest.raises(ValueError, match="does not take a NdtGridMap"):
        look(p, ca, mask, x, fin, offsets, "d2d_raw")
    with pytest.raises(ValueError, match="does not take a RawNdtGrid"):
        look(p, ca, mask, x, vmap, offsets, "p2d")
    with pytest.raises(ValueError, match="offsets"):
        look(p, ca, mask, x, vmap, np.zeros((513, 3), np.int32), "d2d_raw")
    with pytest.raises(ValueError, match="unknown NDT linearize mode"):
        look(p, ca, mask, x, vmap, offsets, "d2d_hash")
    with pytest.raises(ValueError, match="x_lookup"):
        look(p, ca, mask, x, vmap, offsets, "d2d_raw", x_lookup=x[:3])
    with pytest.raises(ValueError, match="x_lookup"):
        look(p, ca, mask, x, vmap, offsets, "d2d_raw", x_lookup=x.double())
    meta = _ndt_map_inputs("meta", raw=True)
    with pytest.raises(ValueError, match="several devices"):
        look(p, ca, meta[2], x, vmap, offsets, "d2d_raw")
    with pytest.raises(ValueError, match="several devices"):
        look(p, ca, mask, x, vmap, offsets, "d2d_raw", x_lookup=meta[3])
    with pytest.raises(ValueError, match="unsupported device meta"):
        look(*meta[:5], offsets, "d2d_raw")
    with pytest.raises(ValueError, match="unsupported device meta"):
        look(*meta[:5], offsets, "d2d_raw", x_lookup=meta[3].clone())


def test_knn_and_adaptive_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from fast_gicp_tpu_torch.ops import covariance, neighbors

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((512, 3), np.float32)
    mask = np.ones(512, bool)
    calls = [
        lambda: neighbors.knn_search(pts, pts, mask, 20),
        lambda: neighbors.knn_search_culled(pts, pts, mask, 20),
        lambda: covariance.adaptive_radius_covariances(pts, mask),
        lambda: covariance.knn_covariances(pts, mask, method="min_eig", approx=False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_slab_and_radius_wrappers_take_plain_version_on_cpu_without_counting():
    from fast_gicp_tpu_torch.ops import cuda_kernels

    wrappers = (cuda_kernels.knn_slab, cuda_kernels.radius_count, cuda_kernels.radius_window)
    for fn in wrappers:
        fn.launches = 0
    n = 512
    pts = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32))
    mask = torch.ones(n, dtype=torch.bool)
    idx, sq = cuda_kernels.knn_slab(pts, mask, pts, mask,
                                    torch.tensor([[0, 1], [1, 0]], dtype=torch.int32), 4)
    assert idx.shape == (n, 4) and idx.device.type == "cpu"
    assert idx[:, 0].tolist() == list(range(n)) and float(sq[:, 0].max()) == 0.0
    r2 = torch.tensor([0.25, 1.0, 4.0])
    cnt = cuda_kernels.radius_count(pts, mask, pts, mask, pts.mean(0), r2)
    assert cnt.shape == (3, n) and bool((cnt[0] >= 1).all()) and bool((cnt[1:] >= cnt[:-1]).all())
    rows = cuda_kernels.radius_window(pts, mask, pts, mask, pts.mean(0), torch.full((n,), 0.25))
    assert rows.shape == (16, n) and torch.equal(rows[0], cnt[0])
    assert cuda_kernels.radius_inputs(pts, mask, pts, mask, pts.mean(0)) is None  # no cull
    assert all(fn.launches == 0 for fn in wrappers)


def test_slab_and_radius_wrappers_raise_for_tensors_on_other_devices():
    from fast_gicp_tpu_torch.ops import cuda_kernels

    p = torch.zeros((256, 3), device="meta")
    m = torch.ones(256, dtype=torch.bool, device="meta")
    c = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_kernels.knn_slab(p, m, p, m, torch.zeros((1, 1), dtype=torch.int32,
                                                      device="meta"), 4)
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_kernels.radius_count(p, m, p, m, c, torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_kernels.radius_window(p, m, p, m, c, torch.ones(256, device="meta"))
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_kernels.radius_inputs(p, m, p, m, c)


@pytest.mark.parametrize("path", sorted((PKG / "ops").glob("cuda_*.py"))
                         + [PKG / "ops" / "covariance.py", PKG / "ops" / "neighbors.py",
                            PKG / "models" / "ndt.py", PKG / "models" / "experimental.py",
                            PKG / "models" / "batch.py", PKG / "pygicp.py",
                            PKG / "models" / "scan_to_map.py", PKG / "utils" / "kitti.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_kernel_modules_have_no_try(path):
    """A wrapper launches its kernel or raises: no try/except that could
    fall back to the plain version."""
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], path


def test_odometry_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    """Slice F: the persistent map's constructors and functional calls,
    `ScanToMapOdometry`, the odometry functions and the KITTI app's twin run
    on the card unless the caller asks for the CPU; with device="cpu" they
    run there."""
    from fast_gicp_tpu_torch.apps import kitti as app
    from fast_gicp_tpu_torch.models import scan_to_map as stm
    from fast_gicp_tpu_torch.utils import kitti

    cpu_map = stm.empty_map(256, 1.0, device="cpu")
    path = str(tmp_path / "map.npz")
    stm.save_map(path, cpu_map)
    (tmp_path / "000000.bin").write_bytes(np.zeros((8, 4), np.float32).tobytes())
    (tmp_path / "000001.bin").write_bytes(np.zeros((8, 4), np.float32).tobytes())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((2048, 3), np.float32)
    mask = np.ones(2048, bool)
    covs = np.tile(np.eye(3, dtype=np.float32), (2048, 1, 1))
    eye = np.eye(4, dtype=np.float32)
    scans = [pts[:100], pts[:100]]
    calls = [
        lambda **kw: stm.empty_map(256, 1.0, **kw),
        lambda **kw: stm.load_map(path, **kw),
        lambda **kw: stm.map_from_voxels(np.zeros((1, 13), np.float32),
                                         np.zeros((1, 3), np.int32), 1.0, **kw),
        lambda **kw: stm.merge_maps(cpu_map, cpu_map, **kw),
        lambda **kw: stm.update_map(cpu_map, pts, covs, mask, **kw),
        lambda **kw: stm.align_to_map(cpu_map, pts, mask, covs, eye, **kw),
        lambda **kw: stm.ScanToMapOdometry(**kw),
        lambda **kw: kitti.run_odometry_batched(scans, **kw),
        lambda **kw: kitti.run_odometry_stream(scans, **kw),
        lambda **kw: kitti.run_odometry_scan(scans, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.main([str(tmp_path), "--mode", "map", "--out", str(tmp_path / "t.txt")])
    assert stm.ScanToMapOdometry(device="cpu").state.sums.device.type == "cpu"
    assert stm.load_map(path, device="cpu").lut.device.type == "cpu"
    state = stm.update_map(cpu_map, pts, covs, mask, device="cpu")
    assert state.sums.device.type == "cpu" and int(state.num_voxels) == 1
