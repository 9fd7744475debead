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
CUDA tensors launch the kernels, which count their launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, linalg3
from .cuda_linearize import _check_cuda, _same_device

_P, _I = ctypes.c_void_p, ctypes.c_int
_FACTOR_ARGS = (_P, _P, _P, _P, _I, _P)
_APPLY_ARGS = (_P, _P, _P, _P, _P, _I, _P)


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
        return block_tridiag_factor_plain(D, U)
    _check_cuda((D, U))
    D, U = _aligned(D), _aligned(U)
    K = D.shape[0]
    Cinv = torch.empty_like(D)
    G = torch.empty_like(D)
    fn = _build.function("fgt_block_tridiag_factor", _FACTOR_ARGS)
    stream = torch.cuda.current_stream(D.device).cuda_stream
    _build.check("fgt_block_tridiag_factor", fn(
        D.data_ptr(), U.data_ptr(), Cinv.data_ptr(), G.data_ptr(), K, stream))
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
        return block_tridiag_apply_plain(Cinv, G, U, r)
    _check_cuda((Cinv, G, U, r))
    Cinv, G, U, r = (_aligned(t) for t in (Cinv, G, U, r))
    x = torch.empty_like(r)
    fn = _build.function("fgt_block_tridiag_apply", _APPLY_ARGS)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    _build.check("fgt_block_tridiag_apply", fn(
        Cinv.data_ptr(), G.data_ptr(), U.data_ptr(), r.data_ptr(), x.data_ptr(), K, stream))
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
