"""Small closed-form linear algebra (port of `fast_gicp_tpu.ops.linalg3`,
the parts the registration solve and the covariance regularizations use).
All functions broadcast over leading batch dimensions."""

from __future__ import annotations

import torch


def symmetrize(A):
    """0.5 (A + A^T) of (..., 3, 3)."""
    return 0.5 * (A + A.transpose(-1, -2))


def inv3(A, eps: float = 0.0):
    """Adjugate inverse of (..., 3, 3), the JAX formula term for term.
    With eps > 0 a determinant of magnitude below eps is replaced by +-eps
    (sign kept, 0 -> +eps); eps = 0, the default, has no guard (a singular
    matrix gives inf/NaN, as there)."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = A[..., 0, 0] * c00 + A[..., 0, 1] * c10 + A[..., 0, 2] * c20
    if eps:
        det = torch.where(torch.abs(det) < eps,
                          torch.where(det < 0, -eps, eps).to(det.dtype), det)
    inv_det = 1.0 / det
    adj = torch.stack(
        [torch.stack([c00, c01, c02], dim=-1),
         torch.stack([c10, c11, c12], dim=-1),
         torch.stack([c20, c21, c22], dim=-1)],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def cholesky_solve(A, b):
    """Solve A x = b for small SPD A via a fully unrolled LL^T.

    The diagonal is clamped at 1e-30 before its square root, as in the JAX
    version: H + lambda I is SPD in exact arithmetic, the clamp only keeps
    f32 round-off from producing NaN.  Supports leading batch dims.
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        diag = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = diag
        inv_diag = 1.0 / diag
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_diag
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
