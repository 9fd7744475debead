"""Small closed-form linear algebra (port of `fast_gicp_tpu.ops.linalg3`,
the part the registration solve uses)."""

from __future__ import annotations

import torch


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
