"""Port vs JAX: the NDT linearize (four modes) and trial-error kernels'
plain versions (fast_gicp_tpu_torch.ops.cuda_ndt) through the port's NDT
objective, against the JAX package's fused objective
`_make_ndt_objective_fused(..., interpret=True)` (the Pallas kernel bodies
`_ndt_{d2d,p2d}{,_raw}_lin_kernel` and `_ndt_error_kernel` in interpret
mode) and against its SoA objective, on the same JAX-built voxel maps
carried across by `convert`.

Tolerances: the Pallas bodies run under XLA:CPU, which fuses multiply-adds
in interpret mode, and take arccos from a polynomial (|err| <= 2e-8 rad);
the raw modes' MIN_EIG clamp and the inverse of a near-planar voxel's
covariance (|M| up to ~1e3) magnify both.  So M is held to 1e-4 of each
lane's largest |M|, the 28 sums to 1e-4 of their largest entry and the
errors to rtol 1e-4 (2,048 sources x 7 offsets summed in two orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_gicp_tpu import se3 as jse3
from fast_gicp_tpu.models import ndt as jndt
from fast_gicp_tpu.ops import pallas_linearize
from fast_gicp_tpu.ops import soa as jsoa
from fast_gicp_tpu.ops import voxelmap as jvox
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch.models import ndt
from fast_gicp_tpu_torch.ops import cuda_linearize, cuda_ndt
from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims, lookup_ndt_cols, neighbor_offsets
from fast_gicp_tpu_torch.utils.synthetic import ndt_kernel_edge_cases, ndt_lookup_edge_cases
from tests.torch_cpu import warm_intra_op_threads

N = 2048
MODES = ["d2d", "p2d", "d2d_raw", "p2d_raw"]


@pytest.fixture(autouse=True, scope="module")
def _warm_threads():
    warm_intra_op_threads()


@pytest.fixture(scope="module")
def scene():
    """Target: a near-planar ground patch and a dense blob (voxels well
    above the > 6 points gate); source: the target points with 5 cm noise,
    the last 100 masked; random SPD source covariances for D2D."""
    rng = np.random.default_rng(7)
    k = N // 2
    plane = np.column_stack([rng.uniform(-4, 4, k), rng.uniform(-4, 4, k),
                             0.003 * rng.standard_normal(k)])
    blob = rng.normal(size=(N - k, 3)) * [1.5, 1.0, 0.8] + [1.0, 0.5, 1.5]
    tgt = np.concatenate([plane, blob]).astype(np.float32)
    src = (tgt + rng.normal(size=tgt.shape) * 0.05).astype(np.float32)
    mask = np.arange(N) < N - 100
    A = rng.normal(size=(N, 3, 3)).astype(np.float32)
    covs = (A @ np.swapaxes(A, 1, 2) * 0.01 + 0.01 * np.eye(3)).astype(np.float32)
    dims = auto_grid_dims(tgt, 1.0)
    tmask = np.ones(N, bool)
    jraw = jvox.build_ndt_raw_grid(jnp.asarray(tgt), jnp.asarray(tmask), 1.0, dims)
    jfin, _ = jvox.build_ndt_grid_compact(jnp.asarray(tgt), jnp.asarray(tmask), 1.0, dims,
                                          budget=2048)
    maps = {
        True: (jraw, convert.raw_ndt_grid_from_numpy(jraw.rows, jraw.grid8, jraw.origin,
                                                     1.0, jraw.grid.shape, device="cpu")),
        False: (jfin, convert.ndt_grid_map_from_numpy(jfin.packed, jfin.grid8, jfin.origin,
                                                      1.0, jfin.grid.shape, device="cpu")),
    }
    x = np.asarray(jse3.se3_exp(jnp.float32([0.02, -0.01, 0.03, 0.1, -0.2, 0.05])))
    x2 = np.asarray(jse3.se3_exp(jnp.float32([-0.01, 0.02, 0.0, 0.05, 0.1, -0.1])))
    return dict(src=src, mask=mask, covs=covs, dims=dims, maps=maps, x=x, x2=x2)


def _objectives(scene, mode, with_freeze=False):
    """(port objective, JAX fused objective, JAX SoA objective) for `mode`;
    with_freeze: the port's NdtObjective and the fused objective's five
    functions (linearize, error, freeze, linearize_frozen, pack_from_aux)."""
    d2d, raw = mode.startswith("d2d"), mode.endswith("_raw")
    jmap, tmap = scene["maps"][raw]
    offsets = neighbor_offsets("direct7")
    covs = scene["covs"] if d2d else None
    obj = ndt.make_ndt_objective(
        torch.as_tensor(scene["src"]), torch.as_tensor(scene["mask"]),
        None if covs is None else convert.covs_from_numpy(covs, device="cpu"), tmap, offsets)
    assert obj.mode == mode
    P = jsoa.cols_from_points(jnp.asarray(scene["src"]))
    C_A = None if covs is None else jsoa.sym_cols_from_covs(jnp.asarray(covs))
    joffs = jnp.asarray(offsets)
    n = len(scene["src"])
    fused = jndt._make_ndt_objective_fused(
        P, C_A, jnp.asarray(scene["mask"]), jmap, joffs.T[:, :, None], n, len(offsets),
        lambda v: v, with_freeze, interpret=True)
    if with_freeze:
        return obj, fused
    cfg = jndt.NDTConfig(resolution=1.0, grid_dims=scene["dims"])
    soa_obj = jndt.make_ndt_objective(jnp.asarray(scene["src"]), jnp.asarray(scene["mask"]),
                                      None if covs is None else jnp.asarray(covs), jmap,
                                      joffs, cfg)
    return (obj.linearize, obj.error), fused, soa_obj


def _close_to_max(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
def test_ndt_linearize_matches_pallas(scene, mode):
    """err, H, b and the aux [M, valid, mu] of one linearization and the
    trial error against its aux, port against the Pallas bodies."""
    (lin, err_fn), (jlin, jerr), _ = _objectives(scene, mode)
    x, x2 = torch.as_tensor(scene["x"]), torch.as_tensor(scene["x2"])
    e, H, b, aux = lin(x)
    e_j, H_j, b_j, aux16 = jlin(jnp.asarray(scene["x"]))
    aux_j = np.asarray(aux16)[:10]
    valid = aux_j[6]
    assert valid.sum() > 1000  # the gate and the masks leave most lanes
    np.testing.assert_array_equal(aux[6].numpy(), valid)
    np.testing.assert_allclose(aux[7:10].numpy(), aux_j[7:10], rtol=1e-5, atol=1e-5)
    scale = np.maximum(np.abs(aux_j[:6]).max(0), 1e-30)
    np.testing.assert_allclose(aux[:6].numpy() / scale, aux_j[:6] / scale, rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)
    _close_to_max(H.numpy(), H_j, 1e-4)
    _close_to_max(b.numpy(), b_j, 1e-4)
    np.testing.assert_allclose(float(err_fn(x2, aux)),
                               float(jerr(jnp.asarray(scene["x2"]), aux16)), rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_ndt_linearize_matches_jax_soa(scene, mode):
    """The same against the JAX package's SoA objective (XLA ops, no
    Pallas): err, H, b and the trial error."""
    (lin, err_fn), _, (jlin, jerr) = _objectives(scene, mode)
    x, x2 = torch.as_tensor(scene["x"]), torch.as_tensor(scene["x2"])
    e, H, b, aux = lin(x)
    e_j, H_j, b_j, aux_j = jlin(jnp.asarray(scene["x"]))
    np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)
    _close_to_max(H.numpy(), H_j, 1e-4)
    _close_to_max(b.numpy(), b_j, 1e-4)
    np.testing.assert_allclose(float(err_fn(x2, aux)),
                               float(jerr(jnp.asarray(scene["x2"]), aux_j)), rtol=1e-4)


@pytest.mark.parametrize("mode", ["d2d", "p2d_raw"])
def test_ndt_error_matches_pallas_on_the_same_aux(scene, mode):
    """Kernel 15 alone: the port's `ndt_error` and the Pallas
    `ndt_error_pallas` on the same aux (the JAX linearize's), at a trial
    pose."""
    _, (jlin, _jerr), _ = _objectives(scene, mode)
    aux16 = np.asarray(jlin(jnp.asarray(scene["x"]))[3])
    L = aux16.shape[1]
    P = np.tile(scene["src"].T, (1, 7))
    got = cuda_ndt.ndt_error(torch.as_tensor(P), torch.as_tensor(aux16[:10].copy()),
                             torch.as_tensor(scene["x2"]), 1.0)
    P8 = jnp.concatenate([jnp.asarray(P), jnp.zeros((5, L), jnp.float32)])
    want = pallas_linearize.ndt_error_pallas(P8, jnp.asarray(aux16), jnp.asarray(scene["x2"]),
                                             1.0, interpret=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_p2d_pack_from_aux_reproduces_the_linearization(scene):
    """P2D's frozen phase seeds from the aux: linearizing the rebuilt
    M-direct pack at the same pose gives the same sums and aux."""
    offsets = neighbor_offsets("direct7")
    _jmap, tmap = scene["maps"][True]
    obj = ndt.make_ndt_objective(
        torch.as_tensor(scene["src"]), torch.as_tensor(scene["mask"]), None, tmap, offsets)
    x = torch.as_tensor(scene["x"])
    e, H, b, aux = obj.linearize(x)
    e2, H2, b2, aux2 = obj.linearize_frozen(x, obj.pack_from_aux(aux))
    torch.testing.assert_close(aux2, aux)
    torch.testing.assert_close(e2, e, rtol=1e-6, atol=0)
    torch.testing.assert_close(H2, H, rtol=1e-6, atol=1e-6 * float(H.abs().max()))
    torch.testing.assert_close(b2, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
    d2d = ndt.make_ndt_objective(torch.as_tensor(scene["src"]), torch.as_tensor(scene["mask"]),
                                 convert.covs_from_numpy(scene["covs"], device="cpu"), tmap, offsets)
    assert d2d.pack_from_aux is None  # D2D re-freezes M at every linearization


def test_ndt_aux_must_not_reach_the_gicp_error(scene):
    """The NDT aux [M, valid, mu] and the GICP aux [M, w, mu] have the same
    shape: the GICP `error` reads row 6 as the weight, so on the same NDT aux
    it gives another sum than `ndt_error` (which recomputes the Cauchy
    weight); and `ndt_error` on a GICP aux is not the GICP error."""
    (lin, err_fn), _, _ = _objectives(scene, "p2d_raw")
    x, x2 = torch.as_tensor(scene["x"]), torch.as_tensor(scene["x2"])
    aux = lin(x)[3]
    P = torch.as_tensor(np.tile(scene["src"].T, (1, 7)))
    e_ndt = float(cuda_ndt.ndt_error(P, aux, x2, 1.0))
    e_gicp = float(cuda_linearize.error(P, x2, aux))
    assert e_ndt == pytest.approx(float(err_fn(x2, aux)), rel=1e-6)
    assert abs(e_gicp - e_ndt) > 0.05 * abs(e_ndt)
    gicp_aux = aux.clone()
    gicp_aux[6] = 2.0 * aux[6]  # a GICP weight sqrt(count) = 2 on valid lanes
    e_g = float(cuda_linearize.error(P, x2, gicp_aux))
    assert abs(float(cuda_ndt.ndt_error(P, gicp_aux, x2, 1.0)) - e_g) > 0.05 * abs(e_g)


def test_ndt_linearize_rejects_bad_input():
    p = torch.zeros((3, 16))
    pack = torch.zeros((16, 16))
    x = torch.eye(4)
    with pytest.raises(ValueError, match="unknown NDT linearize mode"):
        cuda_ndt.ndt_linearize(p, None, x, pack, 1.0, "d2d_hash")
    with pytest.raises(ValueError, match="pack"):
        cuda_ndt.ndt_linearize(p, None, x, torch.zeros((16, 10)), 1.0, "p2d")
    with pytest.raises(ValueError, match="ca"):
        cuda_ndt.ndt_linearize(p, None, x, pack, 1.0, "d2d")
    err, H, b, aux = cuda_ndt.ndt_linearize(p, None, x, pack, 1.0, "p2d_raw")
    assert float(err) == 0.0 and aux.shape == (10, 16) and not aux[6].any()


EDGE_CASES = ndt_kernel_edge_cases()
_X_EDGE = np.asarray(jse3.se3_exp(jnp.float32([0.02, -0.01, 0.03, 0.1, -0.2, 0.05])))
_X2_EDGE = np.asarray(jse3.se3_exp(jnp.float32([-0.01, 0.02, 0.0, 0.05, 0.1, -0.1])))


def _padded(a, rows):
    """a (R, L) zero-padded to (rows, L rounded up to a multiple of the
    Pallas kernels' 2,048 lanes): the zero lanes are empty, invalid voxels."""
    out = np.zeros((rows, -(-a.shape[1] // 2048) * 2048), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _edge_linearize(case):
    """The port's d2d_raw plain version on an edge case at _X_EDGE:
    (err, H, b, aux) as numpy."""
    k = case["offsets"]
    p = torch.as_tensor(np.tile(case["p"], (1, k)))
    ca = torch.as_tensor(np.tile(case["ca"], (1, k)))
    out = cuda_ndt.ndt_linearize(p, ca, torch.as_tensor(_X_EDGE), torch.as_tensor(case["pack"]),
                                 1.0, "d2d_raw")
    return tuple(t.numpy() for t in out)


@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: c["name"])
def test_ndt_d2d_raw_edge_cases_match_pallas(case):
    """d2d_raw's plain version against `ndt_linearize_pallas(mode="d2d_raw",
    interpret=True)` on the same raw pack, its lanes padded to the Pallas
    tile with empty voxels: ragged and tiny L, L = 1, every lane invalid,
    near-planar, coincident and empty voxels.  Tolerances of the module
    docstring; an all-invalid pack gives exact zeros."""
    k = case["offsets"]
    L = case["pack"].shape[0]
    e, H, b, aux = _edge_linearize(case)
    e_j, H_j, b_j, aux_j = pallas_linearize.ndt_linearize_pallas(
        jnp.asarray(_padded(np.tile(case["p"], (1, k)), 8)),
        jnp.asarray(_padded(np.tile(case["ca"], (1, k)), 8)), jnp.asarray(_X_EDGE),
        jnp.asarray(_padded(case["pack"].T, 16)), 1.0, "d2d_raw", interpret=True)
    aux_j = np.asarray(aux_j)[:10, :L]
    np.testing.assert_array_equal(aux[6], aux_j[6])
    np.testing.assert_array_equal(aux[6], case["pack"][:, 13] * (case["pack"][:, 3] > 0))
    np.testing.assert_allclose(aux[7:10], aux_j[7:10], rtol=1e-5, atol=1e-5)
    scale = np.maximum(np.abs(aux_j[:6]).max(0), 1e-30)
    np.testing.assert_allclose(aux[:6] / scale, aux_j[:6] / scale, rtol=0, atol=1e-4)
    if not aux[6].any():
        assert float(e) == 0.0 and not H.any() and not b.any() and not aux[:6].any()
        return
    np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)
    _close_to_max(H, H_j, 1e-4)
    _close_to_max(b, b_j, 1e-4)


def _error_f64(p, aux, x, k):
    """sum w e^T M e in float64 from the same float32 inputs."""
    p, aux, x = (np.asarray(a, np.float64) for a in (p, aux, x))
    pt = np.tile(x[:3, :3] @ p + x[:3, 3:], (1, k))
    e = aux[7:10] - pt
    m00, m01, m02, m11, m12, m22 = aux[:6]
    me = np.stack([m00 * e[0] + m01 * e[1] + m02 * e[2],
                   m01 * e[0] + m11 * e[1] + m12 * e[2],
                   m02 * e[0] + m12 * e[1] + m22 * e[2]])
    w = 1.0 / (1.0 + (e * e).sum(0)) * aux[6]
    return float((w * (e * me).sum(0)).sum())


@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: c["name"])
def test_ndt_error_edge_cases_match_pallas_and_float64(case):
    """ndt_error's plain version (untiled source columns, offsets=K) on the
    aux of the d2d_raw linearization, at a trial pose, against
    `ndt_error_pallas(interpret=True)` on the padded lanes and against a
    float64 numpy sum.  Every term is >= 0 (M is the inverse of an SPD
    matrix), so the float32 sums agree to rtol 1e-5 (the Pallas body fuses
    multiply-adds: rtol 1e-4, as above); all-invalid lanes give exactly 0."""
    k = case["offsets"]
    aux = _edge_linearize(case)[3]
    got = float(cuda_ndt.ndt_error(torch.as_tensor(case["p"]), torch.as_tensor(aux),
                                   torch.as_tensor(_X2_EDGE), 1.0, offsets=k))
    if not aux[6].any():
        assert got == 0.0
        return
    np.testing.assert_allclose(got, _error_f64(case["p"], aux, _X2_EDGE, k), rtol=1e-5)
    want = pallas_linearize.ndt_error_pallas(
        jnp.asarray(_padded(np.tile(case["p"], (1, k)), 8)), jnp.asarray(_padded(aux, 16)),
        jnp.asarray(_X2_EDGE), 1.0, interpret=True)
    np.testing.assert_allclose(got, float(want), rtol=1e-4)


@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: c["name"])
def test_ndt_error_untiled_and_tiled_calls_agree(case):
    """The offsets keyword: source columns (3, N), the same tiled to (3, K N)
    read through their first N columns, and the tiled columns as K N lanes
    of their own (offsets=1) give the same bits on the CPU."""
    k = case["offsets"]
    aux = torch.as_tensor(_edge_linearize(case)[3])
    x = torch.as_tensor(_X2_EDGE)
    p = torch.as_tensor(case["p"])
    tiled = p.repeat(1, k)
    untiled = cuda_ndt.ndt_error(p, aux, x, 1.0, offsets=k)
    assert torch.equal(cuda_ndt.ndt_error(tiled, aux, x, 1.0, offsets=k), untiled)
    assert torch.equal(cuda_ndt.ndt_error(tiled, aux, x, 1.0), untiled)


def test_ndt_error_rejects_offsets_that_do_not_divide_the_lanes():
    aux = torch.zeros((10, 21))
    with pytest.raises(ValueError, match="offsets=4 does not divide L=21"):
        cuda_ndt.ndt_error(torch.zeros((3, 21)), aux, torch.eye(4), 1.0, offsets=4)
    with pytest.raises(ValueError, match="p: expected"):
        cuda_ndt.ndt_error(torch.zeros((3, 5)), aux, torch.eye(4), 1.0, offsets=7)


def _port_objective(scene, mode):
    d2d, raw = mode.startswith("d2d"), mode.endswith("_raw")
    covs = convert.covs_from_numpy(scene["covs"], device="cpu") if d2d else None
    return ndt.make_ndt_objective(torch.as_tensor(scene["src"]), torch.as_tensor(scene["mask"]),
                                  covs, scene["maps"][raw][1], neighbor_offsets("direct7"))


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", MODES)
def test_ndt_lookup_form_equals_freeze_and_pack(scene, mode):
    """The lookup form (the voxel lookup in the kernel; on the CPU its plain
    version) against the eager freeze into a pack and the pack form, at the
    same pose: the same bits."""
    obj = _port_objective(scene, mode)
    x = torch.as_tensor(scene["x"])
    got = cuda_ndt.ndt_linearize_lookup(obj.p, obj.ca, obj.mask, x, obj.vmap, obj.offsets, mode)
    pack = cuda_ndt.ndt_freeze_pack(obj.p, obj.mask, x, obj.vmap, obj.offsets, mode)
    _assert_same(got, cuda_ndt.ndt_linearize(obj.p, obj.ca, x, pack, 1.0, mode))
    _assert_same(obj.linearize(x), got)
    assert got[3][6].sum() > 1000


@pytest.mark.parametrize("mode", MODES)
def test_ndt_ids_form_after_a_freeze_at_another_pose(scene, mode):
    """freeze(x) returns the pose x itself (nothing to launch); the frozen
    linearization at x2 is the lookup form with x as its lookup pose and
    equals the pack frozen at x and linearized at x2; the freeze's row ids
    are `lookup_ndt_cols`' at x."""
    obj = _port_objective(scene, mode)
    x, x2 = torch.as_tensor(scene["x"]), torch.as_tensor(scene["x2"])
    frozen = obj.freeze(x)
    assert frozen is x
    ids, q = cuda_ndt._lookup_plain(obj.p, x, obj.vmap, obj.offsets)
    assert ids.shape == (7 * N,)
    assert torch.equal(ids, lookup_ndt_cols(obj.vmap, *q).reshape(-1))
    pack = cuda_ndt.ndt_freeze_pack(obj.p, obj.mask, x, obj.vmap, obj.offsets, mode)
    want = cuda_ndt.ndt_linearize(obj.p, obj.ca, x2, pack, 1.0, mode)
    _assert_same(obj.linearize_frozen(x2, frozen), want)
    _assert_same(cuda_ndt.ndt_linearize_lookup(obj.p, obj.ca, obj.mask, x2, obj.vmap,
                                               obj.offsets, mode, x_lookup=x), want)
    assert not torch.equal(want[3], obj.linearize(x2)[3])  # x2 re-searches other voxels


@pytest.mark.parametrize("mode", MODES)
def test_ndt_frozen_phase_matches_pallas(scene, mode):
    """The port's freeze at x and frozen linearization at x2 (the lookup
    form at x; P2D also the aux-seeded pack form) against the JAX fused objective's
    freeze and `linearize_frozen` (Pallas bodies in interpret mode), and
    the trial error on that aux; tolerances of the module docstring."""
    obj, (jlin, jerr, jfreeze, jfrozen, jfrom_aux) = _objectives(scene, mode, True)
    x, x2 = torch.as_tensor(scene["x"]), torch.as_tensor(scene["x2"])
    jx, jx2 = jnp.asarray(scene["x"]), jnp.asarray(scene["x2"])
    pairs = [(obj.linearize_frozen(x2, obj.freeze(x)), jfrozen(jx2, jfreeze(jx)))]
    if obj.pack_from_aux is not None:
        pairs.append((obj.linearize_frozen(x2, obj.pack_from_aux(obj.linearize(x)[3])),
                      jfrozen(jx2, jfrom_aux(jlin(jx)[3]))))
    for (e, H, b, aux), (e_j, H_j, b_j, aux16) in pairs:
        aux_j = np.asarray(aux16)[:10]
        np.testing.assert_array_equal(aux[6].numpy(), aux_j[6])
        np.testing.assert_allclose(aux[7:10].numpy(), aux_j[7:10], rtol=1e-5, atol=1e-5)
        scale = np.maximum(np.abs(aux_j[:6]).max(0), 1e-30)
        np.testing.assert_allclose(aux[:6].numpy() / scale, aux_j[:6] / scale, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)
        _close_to_max(H.numpy(), H_j, 1e-4)
        _close_to_max(b.numpy(), b_j, 1e-4)
        np.testing.assert_allclose(float(obj.error(x, aux)), float(jerr(jx, aux16)), rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_ndt_untiled_and_tiled_source_columns_agree(scene, mode):
    """Source columns (3, N) read at column i of lane k N + i, and the same
    tiled over the offsets to (3, L) read at column n: the same bits in the
    lookup form (at one pose, and with another lookup pose) and the pack
    form."""
    obj = _port_objective(scene, mode)
    x, x2 = torch.as_tensor(scene["x"]), torch.as_tensor(scene["x2"])
    pt = obj.p.repeat(1, 7)
    cat = None if obj.ca is None else obj.ca.repeat(1, 7)
    _assert_same(cuda_ndt.ndt_linearize_lookup(pt, cat, obj.mask, x, obj.vmap, obj.offsets,
                                               mode), obj.linearize(x))
    frozen = obj.freeze(x)
    _assert_same(cuda_ndt.ndt_linearize_lookup(pt, cat, obj.mask, x2, obj.vmap, obj.offsets,
                                               mode, x_lookup=frozen),
                 obj.linearize_frozen(x2, frozen))
    pack = cuda_ndt.ndt_freeze_pack(pt, obj.mask, x, obj.vmap, obj.offsets, mode)
    _assert_same(cuda_ndt.ndt_linearize(pt, cat, x2, pack, 1.0, mode),
                 cuda_ndt.ndt_linearize(obj.p, obj.ca, x2, pack, 1.0, mode))


LOOKUP_CASES = ndt_lookup_edge_cases()
_LOOKUP_N = 2048  # the Pallas kernels' lane tile: 7 x 2,048 lanes


def _lookup_scene(case, mode):
    """The port's objective and the JAX fused objective on a lookup edge
    case, the JAX-built map carried across by `convert`, the sources
    zero-padded (masked) to 2,048."""
    d2d, raw = mode.startswith("d2d"), mode.endswith("_raw")
    n = len(case["source"])
    pad = _LOOKUP_N - n
    src = np.concatenate([case["source"], np.zeros((pad, 3), np.float32)])
    mask = np.concatenate([case["smask"], np.zeros(pad, bool)])
    covs = np.concatenate([case["covs"], np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
    tgt, tmask, res, dims = (jnp.asarray(case["target"]), jnp.asarray(case["tmask"]),
                             case["resolution"], case["dims"])
    if raw:
        jmap = jvox.build_ndt_raw_grid(tgt, tmask, res, dims)
        tmap = convert.raw_ndt_grid_from_numpy(jmap.rows, jmap.grid8, jmap.origin, res,
                                               jmap.grid.shape, device="cpu")
    else:
        jmap, _ = jvox.build_ndt_grid_compact(tgt, tmask, res, dims, budget=64)
        tmap = convert.ndt_grid_map_from_numpy(jmap.packed, jmap.grid8, jmap.origin, res,
                                               jmap.grid.shape, device="cpu")
    assert tmap.dims == dims
    offsets = neighbor_offsets("direct7")
    obj = ndt.make_ndt_objective(
        torch.as_tensor(src), torch.as_tensor(mask),
        convert.covs_from_numpy(covs, device="cpu") if d2d else None, tmap, offsets)
    fused = jndt._make_ndt_objective_fused(
        jsoa.cols_from_points(jnp.asarray(src)),
        jsoa.sym_cols_from_covs(jnp.asarray(covs)) if d2d else None, jnp.asarray(mask),
        jmap, jnp.asarray(offsets).T[:, :, None], _LOOKUP_N, 7, lambda v: v, False,
        interpret=True)
    return obj, fused


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", LOOKUP_CASES, ids=lambda c: c["name"])
def test_ndt_lookup_edge_cases_match_pallas(case, mode):
    """The lookup form on `ndt_lookup_edge_cases` (grid exactly the target's
    extent with negative coordinates, voxels on its first cell and on the
    last index of each axis, voxels of 6 and 7 points, near-planar, empty
    cells, sources far outside the grid, masked and zero-padded sources; a
    0.3 m scene with sources on voxel faces) at the identity and at a small
    pose, against the JAX fused objective (Pallas in interpret mode):
    valid exactly, which also holds the gate (count 6 invalid, 7 valid),
    the misses (zero row) and the masks; mu within 1e-5; M within 1e-4 of
    each lane's largest |M|; err, H, b as the module docstring.  The
    frozen phase's form at the same pose gives the same bits; lanes outside
    the grid read the zero row."""
    obj, (jlin, _jerr) = _lookup_scene(case, mode)
    poses = [np.eye(4, dtype=np.float32), _X_EDGE]
    for xn in poses:
        x = torch.as_tensor(xn)
        e, H, b, aux = obj.linearize(x)
        e_j, H_j, b_j, aux16 = jlin(jnp.asarray(xn))
        aux_j = np.asarray(aux16)[:10]
        np.testing.assert_array_equal(aux[6].numpy(), aux_j[6])
        np.testing.assert_allclose(aux[7:10].numpy(), aux_j[7:10], rtol=1e-5, atol=1e-5)
        scale = np.maximum(np.abs(aux_j[:6]).max(0), 1e-30)
        np.testing.assert_allclose(aux[:6].numpy() / scale, aux_j[:6] / scale, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(float(e), float(e_j), rtol=1e-4)
        _close_to_max(H.numpy(), H_j, 1e-4)
        _close_to_max(b.numpy(), b_j, 1e-4)
        _assert_same(obj.linearize_frozen(x, obj.freeze(x)), (e, H, b, aux))
        ids, q = cuda_ndt._lookup_plain(obj.p, x, obj.vmap, obj.offsets)
        zero_row = obj.vmap.grid.new_tensor(obj.vmap[0].shape[0] - 1)
        outside = [(qa < o) | (qa >= o + d) for qa, o, d in
                   zip(q, obj.vmap.origin.long(), obj.vmap.dims)]
        outside = (outside[0] | outside[1] | outside[2]).reshape(-1)
        assert outside.any() and torch.equal(ids[outside], zero_row.expand(int(outside.sum())))
    valid = aux[6].numpy().astype(bool)
    assert valid.any() and not valid.all()
