"""NDT linearize and trial error: the CUDA kernels of `csrc/ndt_linearize.cu`
and their plain PyTorch versions (port of `fast_gicp_tpu.ops.pallas_linearize`'s
NDT part, and of the freeze before it in
`fast_gicp_tpu.models.ndt._make_ndt_objective_fused`).

The linearize of each mode replaces a Pallas kernel behind
`ndt_linearize_pallas` (`pallas_linearize.py:518`): "d2d"
`_ndt_d2d_lin_kernel` (`:330`), "p2d" `_ndt_p2d_lin_kernel` (`:347`),
"d2d_raw" `_ndt_d2d_raw_lin_kernel` (`:492`) and "p2d_raw"
`_ndt_p2d_raw_lin_kernel` (`:507`); `ndt_error` replaces `_ndt_error_kernel`
(`:580`) behind `ndt_error_pallas`.  Each mode has a wrapper of its own,
whose `launches` counts the mode's launches in every form (on the host;
each kernel adds its runs to the tally slot `ndt_<mode>`, `tally`).

A linearize takes the target side in one of two forms:
  * lookup (`ndt_linearize_lookup`): the kernel looks each lane's voxel up
    in the map (`voxelmap.voxel_coord` plus the lane's offset, then
    `lookup_ndt_cols`) and reads the row, at the pose it linearizes at or,
    for a frozen phase, at the pose it froze at (`x_lookup`: the same rows
    at every linearization, M and the weight still at the current pose);
    the mode wrapper's `lookup_launches` counts it;
  * pack (`ndt_linearize`): a frozen pack (L, 16) that the caller gathered
    (`ndt_freeze_pack`, the JAX package's freeze); the tests, P2D's frozen
    phase, seeded from a linearization's aux, and every linearization on
    the hash `VoxelMap` and the `GridVoxelMap`, which the kernel cannot
    look up, take it, and it is the lookup form's oracle: from the same
    rows the two give the same bits.
On CPU tensors both forms take their plain version: the eager freeze
(`ndt_freeze_pack`) and `ndt_linearize_plain`.

Layouts (L = K * N correspondences, offset-major: lane k * N + i pairs
source i with offset k; without the JAX package's (8, L) sublane padding and
(8, 128) pose tile):
  * p (3, N): untransformed source columns, or (3, L) tiled over the
    offsets; ca (6, N) or (6, L): unrotated source sym-6 covariance columns
    (D2D only); mask (N,) bool: source validity -- loop-invariant over a
    solve;
  * x (4, 4): the pose, applied inside the kernel;
  * the voxel map: a `RawNdtGrid` (raw modes) or an `NdtGridMap`
    (finalized modes), read as `voxelmap` lays them out; offsets (K, 3)
    int32 (`voxelmap.neighbor_offsets`);
  * pack (L, 16), rows-major: finalized modes [mu (3), cov_B (D2D) or
    M = cov_B^-1 (P2D) sym-6 (6), valid, pad (6)]; raw modes [voxel corner
    o (3), count, sum d (3), sum d d^T sym-6 (6), valid, pad (2)];
  * aux (10, L) = [M (6), valid, mu (3)], written by every form and read
    by `ndt_error`.  GICP's aux (`cuda_linearize`) has the same shape with
    the weight in row 6: the two must not be mixed.
valid = mask[i] & (count > 6).  The Cauchy weight w = c^2 / (c^2 +
|mu - p|^2) * valid uses c = the voxel resolution; `ndt_error` recomputes
it at the trial pose.

The kernel's voxel coordinate is a true float32 division, as on the CPU.
ATen divides a CUDA tensor by a Python float as the product with
f32(1 / res) (`chip_smoke.check_schedule_traps`), so the eager freeze on
the card bins some points on a voxel face into the next cell
(`utils.synthetic._split_faces`); at the paths' resolution of 1.0 both are
exact.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, soa, tally
from .cuda_linearize import (
    AUX_ROWS, _check, _check_cuda, _reduce_scratch, _same_device, normal_equations,
)
from .voxelmap import (
    MIN_EIG, GridVoxelMap, RawNdtGrid, VoxelMap, lookup_ndt_cols, lookup_voxels_cols,
    voxel_coord,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIN_ARGS = (_I, _I, _P, _P, _I, _I, _I, _P, _P, _F, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
             _P, _I, _P, _P, _P, _P, _P, _P)
_ERR_ARGS = (_P, _I, _I, _P, _P, _F, _I, _P, _P, _P, _P, _P)

MODES = ("d2d", "p2d", "d2d_raw", "p2d_raw")
_FORM = {"pack": 0, "lookup": 1}
MAX_OFFSETS = 512  # csrc/ndt_linearize.cu kMaxOffsets
MIN_VOXEL_POINTS = 6  # voxels with 6 points or fewer are skipped


def _c_sq(resolution) -> float:
    """resolution^2 rounded to float32, as the JAX package squares it."""
    r = np.float32(resolution)
    return float(r * r)


def _offsets(offsets):
    """offsets as a C-contiguous (K, 3) int32 numpy array the kernel takes."""
    o = np.ascontiguousarray(np.asarray(offsets, np.int32))
    if o.ndim != 2 or o.shape[1] != 3 or not 1 <= o.shape[0] <= MAX_OFFSETS:
        raise ValueError(f"offsets: expected (K, 3) with 1 <= K <= {MAX_OFFSETS}, "
                         f"got {o.shape}")
    if np.abs(o).max() > 127:
        raise ValueError("offsets: entries beyond [-127, 127]")
    return o


def _source(p, ca, d2d, N, L):
    """Checks the source columns: p (3, N) or (3, L), ca alike for D2D."""
    if p.dim() != 2 or p.shape[-1] not in (N, L):
        raise ValueError(f"p: expected (3, {N}) or (3, {L}), got {tuple(p.shape)}")
    _check("p", p, (3, p.shape[-1]))
    if d2d:
        if ca is None:
            raise ValueError("ca: D2D needs the source covariance columns")
        _check("ca", ca, (6, p.shape[-1]))


def _map_table(vmap, mode):
    """The map's table (raw rows (T, 10) or finalized packed (T, 16)),
    checked against the mode."""
    raw = isinstance(vmap, RawNdtGrid)
    if raw != mode.endswith("_raw"):
        raise ValueError(f"mode {mode!r} does not take a {type(vmap).__name__}")
    table = vmap.rows if raw else vmap.packed
    width = 10 if raw else 16
    if table.dim() != 2 or table.shape[1] != width or table.dtype != torch.float32:
        raise ValueError(f"voxel table: expected (T, {width}) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    gx, gy, gz = vmap.dims
    _check("grid", vmap.grid, (gx * gy * gz + 1,), torch.int64)
    _check("origin", vmap.origin, (3,), torch.int32)
    return table


def _mask(mask):
    if mask.dim() != 1 or mask.dtype != torch.bool:
        raise ValueError(f"mask: expected (N,) bool, got {tuple(mask.shape)} {mask.dtype}")
    return mask.shape[0]


def _launch(wrapper, mode, form, p, ca, x, resolution, L, N, *, pack=None, mask=None,
            vmap=None, offsets=None, x_lookup=None):
    """One launch of `fgt_ndt_linearize` (tensors checked by the caller),
    counted on the mode's wrapper and by the kernel in its tally slot."""
    d2d = mode.startswith("d2d")
    table = None if vmap is None else (vmap.rows if mode.endswith("_raw") else vmap.packed)
    tensors = [p, x] + ([ca] if d2d else []) + [t for t in (
        x_lookup, pack, mask, table, None if vmap is None else vmap.grid,
        None if vmap is None else vmap.origin) if t is not None]
    _check_cuda(tensors)
    for name, t, align in (("pack", pack, 16), ("voxel table", table, 8 if
                           mode.endswith("_raw") else 16)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    if L >= 2**31:
        raise ValueError(f"{L} lanes: beyond int32")
    partials, ticket, stream = _reduce_scratch(p.device)
    out = torch.empty(43, dtype=torch.float32, device=p.device)
    aux = torch.empty((AUX_ROWS, L), dtype=torch.float32, device=p.device)
    dims = (0, 0, 0) if vmap is None else vmap.dims
    offs = None if offsets is None else _offsets(offsets)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _build.function("fgt_ndt_linearize", _LIN_ARGS)
    _build.check(f"fgt_ndt_linearize ({mode}, {form})", fn(
        MODES.index(mode), _FORM[form], p.data_ptr(),
        ptr(ca) if d2d else None, p.shape[-1], N, L, x.data_ptr(),
        None if x_lookup is None or x_lookup.data_ptr() == x.data_ptr() else
        x_lookup.data_ptr(), _c_sq(resolution),
        ptr(pack), ptr(mask), ptr(table), None if vmap is None else vmap.grid.data_ptr(),
        None if vmap is None else vmap.origin.data_ptr(), *dims,
        0 if table is None else table.shape[0] - 1, float(resolution),
        None if offs is None else offs.ctypes.data, 0 if offs is None else offs.shape[0],
        partials.data_ptr(), ticket.data_ptr(), out.data_ptr(), aux.data_ptr(),
        tally.slot(p.device, f"ndt_{mode}"), stream))
    wrapper.launches += 1
    if form == "lookup":
        wrapper.lookup_launches += 1
    return normal_equations(out) + (aux,)


def _linearize(wrapper, mode, p, ca, x, pack, resolution):
    L = pack.shape[0] if pack.dim() == 2 else -1
    _check("pack", pack, (L, 16))
    _source(p, ca, mode.startswith("d2d"), p.shape[-1], L)
    if L % p.shape[-1]:
        raise ValueError(f"p: {p.shape[-1]} columns do not divide L={L}")
    _check("x", x, (4, 4))
    if _same_device([p, x, pack] + ([ca] if mode.startswith("d2d") else [])).type == "cpu":
        tally.add(p.device, f"ndt_{mode}")
        return ndt_linearize_plain(p, ca, x, pack, _c_sq(resolution), mode)
    return _launch(wrapper, mode, "pack", p, ca, x, resolution, L, p.shape[-1], pack=pack)


def ndt_linearize_d2d(p, ca, x, pack, resolution):
    """D2D against a finalized pack [mu, cov_B, valid]: M = (cov_B +
    R C_A R^T)^-1 at pose x.  Returns (err, H (6, 6), b (6,), aux (10, L)).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    return _linearize(ndt_linearize_d2d, "d2d", p, ca, x, pack, resolution)


def ndt_linearize_p2d(p, ca, x, pack, resolution):
    """P2D against a finalized pack [mu, M = cov_B^-1, valid] (ca unused)."""
    return _linearize(ndt_linearize_p2d, "p2d", p, ca, x, pack, resolution)


def ndt_linearize_d2d_raw(p, ca, x, pack, resolution):
    """D2D against a raw pack: finalize and MIN_EIG clamp, then as "d2d"."""
    return _linearize(ndt_linearize_d2d_raw, "d2d_raw", p, ca, x, pack, resolution)


def ndt_linearize_p2d_raw(p, ca, x, pack, resolution):
    """P2D against a raw pack: finalize, MIN_EIG clamp and invert, then as
    "p2d" (ca unused)."""
    return _linearize(ndt_linearize_p2d_raw, "p2d_raw", p, ca, x, pack, resolution)


_BY_MODE = {
    "d2d": ndt_linearize_d2d,
    "p2d": ndt_linearize_p2d,
    "d2d_raw": ndt_linearize_d2d_raw,
    "p2d_raw": ndt_linearize_p2d_raw,
}
for _fn in _BY_MODE.values():
    _fn.launches = _fn.lookup_launches = 0


def _mode_wrapper(mode):
    if mode not in _BY_MODE:
        raise ValueError(f"unknown NDT linearize mode {mode!r}")
    return _BY_MODE[mode]


def ndt_linearize(p, ca, x, pack, resolution, mode):
    """(err (), H (6, 6), b (6,), aux (10, L)) of the NDT objective at pose x
    against a frozen pack (L, 16); `mode` is one of MODES (ca may be None
    for the P2D modes); p (3, N) or (3, L) tiled over the offsets, N
    dividing L.  CPU tensors take the plain version; CUDA tensors launch
    the mode's kernel."""
    return _mode_wrapper(mode)(p, ca, x, pack, resolution)


def ndt_linearize_lookup(p, ca, mask, x, vmap, offsets, mode, x_lookup=None):
    """(err (), H (6, 6), b (6,), aux (10, L)) of the NDT objective at pose x,
    the voxels looked up at pose x_lookup (x if None): lane k * N + i reads
    the row of the map's cell voxel_coord(x_lookup p_i) + offsets[k] (the
    zero row outside the grid).  A frozen phase passes the pose it froze at
    as x_lookup.  mask (N,) bool; p (3, N) or (3, L); vmap a `RawNdtGrid`
    for the raw modes, else an `NdtGridMap`; offsets (K, 3) int32.  CPU
    tensors take the plain version (`ndt_freeze_pack` at x_lookup, then
    `ndt_linearize_plain` at x); CUDA tensors launch the kernel."""
    wrapper = _mode_wrapper(mode)
    N = _mask(mask)
    K = _offsets(offsets).shape[0]
    L = K * N
    _source(p, ca, mode.startswith("d2d"), N, L)
    _check("x", x, (4, 4))
    if x_lookup is not None:
        _check("x_lookup", x_lookup, (4, 4))
    table = _map_table(vmap, mode)
    tensors = [p, x, mask, table, vmap.grid, vmap.origin]
    tensors += ([ca] if mode.startswith("d2d") else []) + ([x_lookup] if x_lookup is not None
                                                            else [])
    if _same_device(tensors).type == "cpu":
        tally.add(p.device, f"ndt_{mode}", form=True)
        pack = ndt_freeze_pack(p, mask, x if x_lookup is None else x_lookup, vmap, offsets,
                               mode)
        return ndt_linearize_plain(p, ca, x, pack, _c_sq(vmap.resolution), mode)
    return _launch(wrapper, mode, "lookup", p, ca, x, vmap.resolution, L, N, mask=mask,
                   vmap=vmap, offsets=offsets, x_lookup=x_lookup)


def ndt_error(p, aux, x, resolution, offsets=1):
    """Sum of w e^T M e at trial pose x against the frozen NDT aux (10, L),
    the Cauchy weight taken at x (scalar).  Lanes are `offsets` blocks of
    N = L / offsets, lane k * N + i reading source column i: p is (3, N), or
    (3, L) tiled over the offsets, of which only the first N columns are
    read.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    L = aux.shape[-1]
    _check("aux", aux, (AUX_ROWS, L))
    _check("x", x, (4, 4))
    if offsets < 1 or L % offsets:
        raise ValueError(f"offsets={offsets} does not divide L={L}")
    N = L // offsets
    if p.dim() == 2 and p.shape[-1] == L:
        p = p[:, :N]
    _check("p", p, (3, N))
    c_sq = _c_sq(resolution)
    if p.device.type == "cpu":
        tally.add(p.device, "ndt_error")
        return ndt_error_plain(p.repeat(1, offsets), aux, x, c_sq)
    _check_cuda([aux, x])
    if p.device != aux.device or (N > 1 and p.stride(1) != 1):
        raise ValueError("p must lie on the device of aux, its columns contiguous")
    partials, ticket, stream = _reduce_scratch(p.device)
    out = torch.empty(1, dtype=torch.float32, device=p.device)
    fn = _build.function("fgt_ndt_error", _ERR_ARGS)
    _build.check("fgt_ndt_error", fn(
        p.data_ptr(), p.stride(0), N, x.data_ptr(), aux.data_ptr(), c_sq, L,
        partials.data_ptr(), ticket.data_ptr(), out.data_ptr(), tally.slot(p.device, "ndt_error"),
        stream))
    ndt_error.launches += 1
    return out[0]


ndt_error.launches = 0


def _cauchy(c_sq, p, q, valid):
    e0, e1, e2 = q[0] - p[0], q[1] - p[1], q[2] - p[2]
    return c_sq / (c_sq + e0 * e0 + e1 * e1 + e2 * e2) * valid


def _unpack_raw(pack):
    """Raw pack rows (L, 16) -> (mu (3, L), clamped cov_B (6, L), valid (L,)):
    the finalize of the raw modes (corner-relative moments divided out,
    E[d d^T] - dmu dmu^T, the MIN_EIG clamp, valid cleared on empty voxels)."""
    cnt = pack[:, 3]
    alive = (cnt > 0).to(pack.dtype)
    inv_n = alive / torch.clamp(cnt, min=1.0)
    d = pack[:, 4:7].T * inv_n
    mu = pack[:, 0:3].T + d
    C = pack[:, 7:13].T * inv_n - torch.stack(
        [d[0] * d[0], d[0] * d[1], d[0] * d[2], d[1] * d[1], d[1] * d[2], d[2] * d[2]])
    return mu, soa.clamp_eigs_cols(C, MIN_EIG), pack[:, 13] * alive


def _query(p, x, vmap, offsets):
    """The query coordinates of the transformed source columns p (3, N):
    `voxel_coord` plus each offset, three (K, N) int32."""
    coords = voxel_coord(soa.transform_cols(x, p), vmap.resolution)
    return [torch.stack([coords[a] + int(o[a]) for o in offsets]) for a in range(3)]


def _lookup_plain(p, x, vmap, offsets):
    """(ids (L,) int64, q): each lane's row of a dense NDT map by `_query`
    and `lookup_ndt_cols`, q the query coordinates, three (K, N) int32."""
    q = _query(p, x, vmap, offsets)
    return lookup_ndt_cols(vmap, *q).reshape(-1), q


def ndt_freeze_pack(p, mask, x, vmap, offsets, mode):
    """The frozen pack (L, 16) of the voxels looked up at pose x, with eager
    ops (the JAX package's freeze, `_make_ndt_objective_fused`): the plain
    version of the lookup in `ndt_linearize_lookup` and the pack form's
    input, valid = mask & (count > 6).  p (3, N) or (3, L) tiled; mask (N,)
    bool; offsets (K, 3).  P2D inverts a finalized map's cov_B.

    On the hash `VoxelMap` and the `GridVoxelMap` (modes "d2d" and "p2d"),
    which the linearize kernel cannot look up, this is the freeze of every
    linearization: `lookup_voxels_cols` and a gather of the `packed` rows,
    valid also requiring a hit (a miss reads row 0, which `valid` keeps
    out), as the JAX package's `_gather_voxel_rows`."""
    N = mask.shape[0]
    if isinstance(vmap, (VoxelMap, GridVoxelMap)):
        if mode not in ("d2d", "p2d"):
            raise ValueError(f"mode {mode!r} does not take a {type(vmap).__name__}")
        vids = lookup_voxels_cols(vmap, *_query(p[:, :N], x, vmap, offsets)).reshape(-1)
        mu, cov6, count = soa.sym_cols_from_packed(vmap.packed[torch.clamp(vids, min=0)])
        valid = (mask.repeat(vids.shape[0] // N) & (count > MIN_VOXEL_POINTS)
                 & (vids >= 0)).to(mu.dtype)
        return _finalized_pack(mu, cov6, valid, mode)
    ids, q = _lookup_plain(p[:, :N], x, vmap, offsets)
    L = ids.shape[0]
    valid_src = mask.repeat(L // N)
    if mode.endswith("_raw"):
        # [o (3), count, sum d (3), sum d d^T (6), valid, pad (2)], o = (q + 1) res
        corner = torch.stack([(qa.reshape(-1).to(torch.float32) + 1.0) * vmap.resolution
                              for qa in q])
        rows = vmap.rows[ids]
        valid = (valid_src & (rows[:, 0] > MIN_VOXEL_POINTS)).to(rows.dtype)
        return torch.cat([corner.T, rows, valid[:, None],
                          torch.zeros((L, 2), dtype=rows.dtype, device=rows.device)],
                         dim=1).contiguous()
    mu, cov6, count = soa.sym_cols_from_packed(vmap.packed[ids])
    valid = (valid_src & (count > MIN_VOXEL_POINTS)).to(mu.dtype)
    return _finalized_pack(mu, cov6, valid, mode)


def _finalized_pack(mu, cov6, valid, mode):
    """The finalized modes' pack (L, 16) [mu, cov_B (D2D) or M (P2D),
    valid, pad]."""
    if mode == "p2d":
        # P2D: M = cov_B^-1 does not depend on the pose; invert at the freeze
        cov6 = soa.inv_sym_cols(cov6)
    return torch.cat([mu.T, cov6.T, valid[:, None],
                      torch.zeros((mu.shape[1], 6), dtype=mu.dtype, device=mu.device)],
                     dim=1).contiguous()


def ndt_linearize_plain(p, ca, x, pack, c_sq, mode):
    """Plain PyTorch version of `ndt_linearize` (`c_sq` = resolution^2);
    p and ca untiled (N columns) or tiled (L)."""
    k = pack.shape[0] // p.shape[-1]
    if k > 1:
        p = p.repeat(1, k)
        ca = None if ca is None else ca.repeat(1, k)
    if mode.endswith("_raw"):
        mu, C, valid = _unpack_raw(pack)
    else:
        mu, C, valid = pack[:, 0:3].T, pack[:, 3:9].T, pack[:, 9]
    if mode.startswith("d2d"):
        M = soa.inv_sym_cols(C + soa.rotate_sym_cols(x[:3, :3], ca))
    elif mode == "p2d_raw":
        M = soa.inv_sym_cols(C)
    else:
        M = C
    M = M * valid
    p_t = soa.transform_cols(x, p)
    err, H, b = soa.linearize_cols(p_t, mu, M, _cauchy(c_sq, p_t, mu, valid))
    return err, H, b, torch.cat([M, valid[None], mu])


def ndt_error_plain(p, aux, x, c_sq):
    """Plain PyTorch version of `ndt_error` (`c_sq` = resolution^2)."""
    p_t = soa.transform_cols(x, p)
    mu, valid = aux[7:10], aux[6]
    return soa.error_cols(p_t, mu, aux[:6], _cauchy(c_sq, p_t, mu, valid))
