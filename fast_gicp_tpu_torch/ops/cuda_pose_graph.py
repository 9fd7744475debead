"""The block-tridiagonal preconditioner of the sparse pose-graph solve: the
CUDA kernels of `csrc/block_tridiag.cu` and their plain PyTorch versions.

No Pallas kernel stands behind it.  The JAX package's `_tridiag_solve`
(`fast_gicp_tpu/models/pose_graph_sparse.py:89-120`) is a block-Thomas
elimination written as two `lax.scan`s, which XLA compiles into one device
loop; as eager ops it would be ~5 launches a pose a sweep.  Its blocks C_k
and G_k depend only on the linearization and lambda, so here it is split:

  * `block_tridiag_factor(D, U) -> (Cinv, G)`, once an LM trial:
    C_k = D_k - U_{k-1}^T G_{k-1}, G_k = C_k^-1 U_k, and C_k^-1, each
    through `linalg3.cholesky_solve`'s unrolled LL^T (diagonal clamped at
    1e-30);
  * `block_tridiag_apply(Cinv, G, U, r) -> x`, once a CG iteration:
    y_k = C_k^-1 (r_k - U_{k-1}^T y_{k-1}), x_k = y_k - G_k x_{k+1}.

D, U, Cinv, G are (K, 6, 6), r and x (K, 6), float32.  CPU tensors take
the plain versions (a Python loop over k, the kernels' oracle, rounding
as the kernels do: the same products and sums in the same order, no FMA);
CUDA tensors launch the kernels.  Each wrapper counts its launches on the
host (`.launches`, one a call that launches: under a capture one an
enqueue into the graph) and each kernel on the device, in its slot of
`pg_counts` (one a run, a graph's replays included); a CPU call adds its
one there as well.

`pg_cond` is the condition kernel of the solves' device form
(`csrc/device_loop.cu`, port-only: it replaces the predicates that XLA
evaluates for the JAX solves' `lax.while_loop`s and the CG's `lax.cond`):
one thread that steps a loop's trip counter, writes the loop's condition
into a conditional node's handle (`graphs`) and adds to the device's tally
`pg_counts`.  `pg_cond_plain` is the same step as eager ops.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, linalg3
from .cuda_linearize import _check_cuda, _same_device

_P, _I = ctypes.c_void_p, ctypes.c_int
_FACTOR_ARGS = (_P, _P, _P, _P, _I, _P, _P)
_APPLY_ARGS = (_P, _P, _P, _P, _P, _I, _P, _P)
_COND_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_ulonglong, _I, _P)

# pg_cond modes: before and after each trip of the Gauss-Newton loop, the LM
# trials and the CG iterations (ENTER sets the trip counter to 0, STEP adds
# one), and the CG iteration's refresh test, (i + 1) % cap == 0
PG_GN_ENTER = 0
PG_GN_STEP = 1
PG_TRIAL_ENTER = 2
PG_TRIAL_STEP = 3
PG_CG_ENTER = 4
PG_CG_STEP = 5
PG_REFRESH = 6
PG_CG_MODES = (PG_CG_ENTER, PG_CG_STEP)
# the CG iterations between two recomputations of the residual (JAX's 64)
CG_REFRESH = 64

# the device's tally: condition launches, solves, Gauss-Newton iterations,
# LM trials, PCGs, CG iterations run (pg_cond), and the runs of
# block_tridiag_apply and block_tridiag_factor (each kernel adds its own)
PG_COUNTS = ("pg_cond", "solves", "iterations", "trials", "pcgs", "cg_iterations", "applies",
             "factors")
_pg_counts: dict = {}


def _check_blocks(name, t, K=None):
    K = t.shape[0] if K is None else K
    if t.dtype != torch.float32 or tuple(t.shape) != (K, 6, 6):
        raise ValueError(f"{name}: expected ({K}, 6, 6) float32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _aligned(t):
    """t, or a contiguous copy of it: the kernels copy their operands in
    bulk, which needs contiguous data starting on a 16-byte boundary."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _solve6(A, B):
    """Solve A X = B for a 6x6 SPD A through `linalg3.cholesky_solve`; B
    (6,) or (6, m) (columns), as the JAX package's `_solve6`."""
    if B.dim() == 1:
        return linalg3.cholesky_solve(A, B)
    return linalg3.cholesky_solve(A.expand(B.shape[1], 6, 6), B.transpose(0, 1)).transpose(0, 1)


def block_tridiag_factor(D, U):
    """(Cinv, G) of the block-Thomas elimination of the block-tridiagonal
    matrix with diagonal blocks D and super-diagonal blocks U."""
    _check_blocks("D", D)
    _check_blocks("U", U, D.shape[0])
    if _same_device((D, U)).type == "cpu":
        _tally(D.device, "factors")
        return block_tridiag_factor_plain(D, U)
    _check_cuda((D, U))
    D, U = _aligned(D), _aligned(U)
    K = D.shape[0]
    Cinv = torch.empty_like(D)
    G = torch.empty_like(D)
    fn = _build.function("fgt_block_tridiag_factor", _FACTOR_ARGS)
    stream = torch.cuda.current_stream(D.device).cuda_stream
    _build.check("fgt_block_tridiag_factor", fn(
        D.data_ptr(), U.data_ptr(), Cinv.data_ptr(), G.data_ptr(), K,
        _slot(D.device, "factors"), stream))
    block_tridiag_factor.launches += 1
    return Cinv, G


block_tridiag_factor.launches = 0


def block_tridiag_factor_plain(D, U):
    """Plain PyTorch version of `block_tridiag_factor`: C_k's product
    summed over m in order, then `_solve6` on the identity's and U_k's
    columns (the kernel's arithmetic, one op at a time)."""
    K = D.shape[0]
    eye = torch.eye(6, dtype=D.dtype, device=D.device)
    Cinv, G = [], []
    for k in range(K):
        C = D[k]
        if k:
            Up, Gp = U[k - 1], G[-1]
            acc = Up[0][:, None] * Gp[0][None, :]
            for m in range(1, 6):
                acc = acc + Up[m][:, None] * Gp[m][None, :]
            C = C - acc
        X = _solve6(C, torch.cat([eye, U[k]], dim=1))
        Cinv.append(X[:, :6])
        G.append(X[:, 6:])
    return torch.stack(Cinv), torch.stack(G)


def block_tridiag_apply(Cinv, G, U, r):
    """x (K, 6) solving the factored block-tridiagonal system for r (K, 6)."""
    K = Cinv.shape[0]
    for name, t in (("Cinv", Cinv), ("G", G), ("U", U)):
        _check_blocks(name, t, K)
    if r.dtype != torch.float32 or tuple(r.shape) != (K, 6):
        raise ValueError(f"r: expected ({K}, 6) float32, got {tuple(r.shape)} {r.dtype}")
    if _same_device((Cinv, G, U, r)).type == "cpu":
        _tally(r.device, "applies")
        return block_tridiag_apply_plain(Cinv, G, U, r)
    _check_cuda((Cinv, G, U, r))
    Cinv, G, U, r = (_aligned(t) for t in (Cinv, G, U, r))
    x = torch.empty_like(r)
    fn = _build.function("fgt_block_tridiag_apply", _APPLY_ARGS)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    _build.check("fgt_block_tridiag_apply", fn(
        Cinv.data_ptr(), G.data_ptr(), U.data_ptr(), r.data_ptr(), x.data_ptr(), K,
        _slot(r.device, "applies"), stream))
    block_tridiag_apply.launches += 1
    return x


block_tridiag_apply.launches = 0


def _dot_rows(M, v):
    """M @ v for a 6x6 M, the products summed over the columns in order
    (the kernel's arithmetic: every product and sum rounded on its own)."""
    P = M * v
    acc = P[:, 0]
    for m in range(1, 6):
        acc = acc + P[:, m]
    return acc


def block_tridiag_apply_plain(Cinv, G, U, r):
    """Plain PyTorch version of `block_tridiag_apply`: the two sweeps as a
    Python loop over k, each 6x6 matrix-vector product summed in the
    kernel's order, so the chain of K steps rounds as the kernel's does."""
    K = r.shape[0]
    ys, y = [], None
    for k in range(K):
        v = r[k] if k == 0 else r[k] - _dot_rows(U[k - 1].transpose(0, 1), y)
        y = _dot_rows(Cinv[k], v)
        ys.append(y)
    xs, x = [None] * K, torch.zeros_like(r[0])
    for k in reversed(range(K)):
        x = ys[k] - _dot_rows(G[k], x)
        xs[k] = x
    return torch.stack(xs)


def block_tridiag_solve(D, U, r):
    """The whole solve of `_tridiag_solve`: factor, then apply."""
    Cinv, G = block_tridiag_factor(D, U)
    return block_tridiag_apply(Cinv, G, U, r)


def pg_counts(device):
    """The device's (8,) int32 tally of what the pose-graph solves ran
    (PG_COUNTS); `pg_cond` and the two block_tridiag kernels add to it on the
    device as they run (a profiler does not see every kernel of a
    conditional body, so a replay's launches are read from here).  Made once a device, eagerly:
    first asked for under a capture, it raises (`graphs.prepare` makes it).
    Zero it with `.zero_()`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _pg_counts:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("pg_counts is made before a capture: call "
                               "graphs.prepare(device) first")
        _pg_counts[device] = torch.zeros(len(PG_COUNTS), dtype=torch.int32, device=device)
    return _pg_counts[device]


def _slot(device, name):
    """The address of the tally's `name` slot, for a kernel to add to."""
    return pg_counts(device)[PG_COUNTS.index(name):].data_ptr()


def _tally(device, name):
    """One more run of a kernel's plain version in its tally slot (a CPU
    call of the wrapper, which stands for the launch)."""
    pg_counts(device)[PG_COUNTS.index(name)] += 1


def _check_scalar(name, t, dtype):
    if t is None or t.dtype != dtype or t.numel() != 1:
        got = None if t is None else (tuple(t.shape), t.dtype)
        raise ValueError(f"{name}: expected one {dtype} value, got {got}")


def pg_cond(mode, cap, counter, flag, stop=None, rr=None, thresh=None, handle=0):
    """One step of a pose-graph loop's bookkeeping, in place: `counter` (one
    int32, the loop's trips) set to 0 (the ENTER modes) or stepped (STEP),
    and the loop's condition, `counter < cap` and `~stop` (a bool: the
    Gauss-Newton loop's conv, the trials' accepted) or `rr > thresh` (float32
    scalars: the CG's res.res and tolerance), written to `flag` ((1,)
    int32) and, for a nonzero `handle` (a conditional handle of the graph
    being captured), into the handle.  PG_REFRESH leaves the counter and
    writes (counter + 1) % cap == 0.  Adds to `pg_counts`.

    CPU tensors take the plain version; CUDA tensors launch the condition
    kernel, one launch a step."""
    if mode not in range(PG_REFRESH + 1):
        raise ValueError(f"unknown pg_cond mode {mode}")
    if mode == PG_REFRESH and cap < 1:
        raise ValueError(f"the refresh test needs a period >= 1, got {cap}")
    _check_scalar("counter", counter, torch.int32)
    _check_scalar("flag", flag, torch.int32)
    if mode in PG_CG_MODES:
        _check_scalar("rr", rr, torch.float32)
        _check_scalar("thresh", thresh, torch.float32)
    elif mode != PG_REFRESH:
        _check_scalar("stop", stop, torch.bool)
    used = [t for t in (counter, flag, stop, rr, thresh) if t is not None]
    if _same_device(used).type == "cpu":
        if handle:
            raise ValueError("a conditional handle exists only under CUDA graph capture")
        return pg_cond_plain(mode, cap, counter, flag, stop, rr, thresh)
    _check_cuda(used)
    counts = pg_counts(counter.device)
    fn = _build.function("fgt_pg_cond", _COND_ARGS)
    stream = torch.cuda.current_stream(counter.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.check("fgt_pg_cond", fn(
        counter.data_ptr(), ptr(stop), ptr(rr), ptr(thresh), flag.data_ptr(),
        counts.data_ptr(), int(mode), int(cap), int(handle), int(handle != 0), stream))
    pg_cond.launches += 1


pg_cond.launches = 0


def pg_cond_plain(mode, cap, counter, flag, stop=None, rr=None, thresh=None):
    """Plain PyTorch version of `pg_cond` (no handle): the same counter,
    condition and tally as eager ops, on any device."""
    counts = pg_counts(counter.device)
    counts[0] += 1
    n = counter.reshape(())
    if mode == PG_REFRESH:
        cond = (n + 1) % cap == 0
    else:
        n = torch.zeros_like(n) if mode in (PG_GN_ENTER, PG_TRIAL_ENTER, PG_CG_ENTER) else n + 1
        counter.copy_(n.reshape(counter.shape))
        slot = {PG_GN_ENTER: "solves", PG_GN_STEP: "iterations", PG_TRIAL_STEP: "trials",
                PG_CG_ENTER: "pcgs", PG_CG_STEP: "cg_iterations"}.get(mode)
        if slot is not None:
            counts[PG_COUNTS.index(slot)] += 1
        cond = n < cap
        if mode in PG_CG_MODES:
            cond = cond & (rr.reshape(()) > thresh.reshape(()))
        else:
            cond = cond & ~stop.reshape(())
    flag.copy_(cond.to(torch.int32).reshape(flag.shape))
