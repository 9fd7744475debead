"""Structure-of-arrays (n-last) per-correspondence math on torch tensors
(port of `fast_gicp_tpu.ops.soa`).

Points are (3, N) columns; symmetric 3x3 matrices are 6 coefficient rows
(6, N) in the order (m00, m01, m02, m11, m12, m22).  Every op is a
closed-form scalar formula over N.  These are the plain versions behind
the linearize and error kernels (ops/cuda_linearize.py) and the RBF
covariance finalize (ops/covariance.py).
"""

from __future__ import annotations

import torch


def cols_from_points(points):
    """(..., N, 3) -> (..., 3, N)."""
    return points.transpose(-1, -2)


def sym_cols_from_covs(covs):
    """(..., N, 3, 3) symmetric -> (..., 6, N); (..., 6, N) passes through."""
    if covs.shape[-2:] != (3, 3) and covs.shape[-2] == 6:
        return covs
    return torch.stack(
        [covs[..., 0, 0], covs[..., 0, 1], covs[..., 0, 2],
         covs[..., 1, 1], covs[..., 1, 2], covs[..., 2, 2]],
        dim=-2,
    )


def sym_cols_to_rows9(C):
    """(..., 6, N) sym-6 columns -> (..., N, 9) row-major 3x3 rows."""
    full = torch.stack(
        [C[..., 0, :], C[..., 1, :], C[..., 2, :],
         C[..., 1, :], C[..., 3, :], C[..., 4, :],
         C[..., 2, :], C[..., 4, :], C[..., 5, :]],
        dim=-2,
    )
    return full.transpose(-1, -2)


def sym_cols_from_raw(rows):
    """Raw accumulator rows (..., N, 16) [count, sum mu (3), sum cov (9)]
    -> finalized (mean (..., 3, N), cov (..., 6, N), count (..., N));
    empty cells (count 0) give zeros."""
    count = rows[..., 0]
    inv_n = torch.where(
        count > 0, 1.0 / torch.clamp(count, min=1.0), torch.zeros_like(count)
    )
    mean = rows[..., 1:4].transpose(-1, -2) * inv_n[..., None, :]
    cov = torch.stack(
        [rows[..., 4], rows[..., 5], rows[..., 6],
         rows[..., 8], rows[..., 9], rows[..., 12]],
        dim=-2,
    ) * inv_n[..., None, :]
    return mean, cov, count


def sym_cols_from_packed(rows):
    """Finalized voxel rows (..., N, 16) [mean (3), cov (9 row-major),
    count, pad (3)] -> (mean (..., 3, N), cov (..., 6, N), count (..., N))."""
    mean = rows[..., 0:3].transpose(-1, -2)
    cov = torch.stack(
        [rows[..., 3], rows[..., 4], rows[..., 5],
         rows[..., 7], rows[..., 8], rows[..., 11]],
        dim=-2,
    )
    return mean, cov, rows[..., 12]


def transform_cols(T, P):
    """Rigid transform of (..., 3, N) columns by a 4x4 matrix."""
    R, t = T[:3, :3], T[:3, 3]
    x, y, z = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    return torch.stack(
        [R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0],
         R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1],
         R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]],
        dim=-2,
    )


def rotate_sym_cols(R, C):
    """R C R^T for symmetric-6 columns C (..., 6, N), R (3, 3)."""
    c00, c01, c02, c11, c12, c22 = (C[..., i, :] for i in range(6))
    b = []
    for i in range(3):
        r0, r1, r2 = R[i, 0], R[i, 1], R[i, 2]
        b.append((r0 * c00 + r1 * c01 + r2 * c02,
                  r0 * c01 + r1 * c11 + r2 * c12,
                  r0 * c02 + r1 * c12 + r2 * c22))

    def dot(bi, j):
        return bi[0] * R[j, 0] + bi[1] * R[j, 1] + bi[2] * R[j, 2]

    return torch.stack(
        [dot(b[0], 0), dot(b[0], 1), dot(b[0], 2),
         dot(b[1], 1), dot(b[1], 2), dot(b[2], 2)],
        dim=-2,
    )


def inv_sym_cols(C, eps: float = 1e-18):
    """Adjugate inverse of symmetric-6 columns (..., 6, N).

    The determinant is clamped to +-eps: a singular column would otherwise
    give inv_det = inf and 0 * inf = NaN, which survives every downstream
    `* valid` mask and poisons the whole (err, H, b) reduction.
    """
    c00, c01, c02, c11, c12, c22 = (C[..., i, :] for i in range(6))
    a00 = c11 * c22 - c12 * c12
    a01 = c02 * c12 - c01 * c22
    a02 = c01 * c12 - c02 * c11
    a11 = c00 * c22 - c02 * c02
    a12 = c01 * c02 - c00 * c12
    a22 = c00 * c11 - c01 * c01
    det = c00 * a00 + c01 * a01 + c02 * a02
    signed_eps = torch.where(det < 0, -eps, eps).to(det.dtype)
    det = torch.where(det.abs() < eps, signed_eps, det)
    inv_det = 1.0 / det
    return torch.stack([a00, a01, a02, a11, a12, a22], dim=-2) * inv_det[..., None, :]


def eigvals_sym_cols(C):
    """Eigenvalues (small, mid, big) of sym-6 columns, each (..., N), by the
    trigonometric closed form."""
    c00, c01, c02, c11, c12, c22 = (C[..., i, :] for i in range(6))
    q = (c00 + c11 + c22) / 3.0
    p1 = c01 * c01 + c02 * c02 + c12 * c12
    d0, d1, d2 = c00 - q, c11 - q, c22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    iso = p2 <= 1e-30
    p = torch.sqrt(torch.where(iso, torch.ones_like(p2), p2) / 6.0)
    inv_p = 1.0 / p
    b00, b11, b22 = d0 * inv_p, d1 * inv_p, d2 * inv_p
    b01, b02, b12 = c01 * inv_p, c02 * inv_p, c12 * inv_p
    det = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(det * 0.5, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_big = q + 2.0 * p * torch.cos(phi)
    e_small = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)
    e_mid = 3.0 * q - e_big - e_small
    return (
        torch.where(iso, q, e_small),
        torch.where(iso, q, e_mid),
        torch.where(iso, q, e_big),
    )


def plane_covs_cols(C):
    """PLANE regularization on sym-6 columns: I - (1 - 1e-3) v v^T with v
    the smallest eigenvector, found by Cayley-Hamilton as the largest
    column of (A - l_big I)(A - l_mid I); degenerate columns fall back to
    v = e_z."""
    c00, c01, c02, c11, c12, c22 = (C[..., i, :] for i in range(6))
    e_small, e_mid, e_big = eigvals_sym_cols(C)
    t = e_big + e_mid
    d = e_big * e_mid
    s00 = c00 * c00 + c01 * c01 + c02 * c02
    s01 = c00 * c01 + c01 * c11 + c02 * c12
    s02 = c00 * c02 + c01 * c12 + c02 * c22
    s11 = c01 * c01 + c11 * c11 + c12 * c12
    s12 = c01 * c02 + c11 * c12 + c12 * c22
    s22 = c02 * c02 + c12 * c12 + c22 * c22
    g00 = s00 - t * c00 + d
    g01 = s01 - t * c01
    g02 = s02 - t * c02
    g11 = s11 - t * c11 + d
    g12 = s12 - t * c12
    g22 = s22 - t * c22 + d
    n0 = g00 * g00 + g01 * g01 + g02 * g02
    n1 = g01 * g01 + g11 * g11 + g12 * g12
    n2 = g02 * g02 + g12 * g12 + g22 * g22
    use0 = (n0 >= n1) & (n0 >= n2)
    use1 = ~use0 & (n1 >= n2)
    v0 = torch.where(use0, g00, torch.where(use1, g01, g02))
    v1 = torch.where(use0, g01, torch.where(use1, g11, g12))
    v2 = torch.where(use0, g02, torch.where(use1, g12, g22))
    nrm = torch.sqrt(v0 * v0 + v1 * v1 + v2 * v2)
    scale = torch.clamp(
        torch.maximum(e_small.abs(), torch.maximum(e_mid.abs(), e_big.abs())),
        min=1e-30,
    )
    ok = nrm > 1e-12 * scale * scale
    inv = torch.where(ok, 1.0 / torch.where(ok, nrm, torch.ones_like(nrm)),
                      torch.zeros_like(nrm))
    zero = torch.zeros_like(nrm)
    v0 = torch.where(ok, v0 * inv, zero)
    v1 = torch.where(ok, v1 * inv, zero)
    v2 = torch.where(ok, v2 * inv, torch.ones_like(nrm))
    k = 1.0 - 1e-3
    return torch.stack(
        [1.0 - k * v0 * v0, -k * v0 * v1, -k * v0 * v2,
         1.0 - k * v1 * v1, -k * v1 * v2, 1.0 - k * v2 * v2],
        dim=-2,
    )


def clamp_eigs_cols(C, eps):
    """MIN_EIG regularization on sym-6 columns: eigenvalues clamped to
    >= eps with the eigenvectors kept (covariance_regularization.cu
    covariance_regularization_mineig), in closed form.

    With eigenvalues e_s <= e_m <= e_b and clamp deficits
    c_i = max(0, eps - e_i),
        A' = A + c_m I - (c_m - c_b) P_big + (c_s - c_m) P_small,
    each spectral projector a Cayley-Hamilton polynomial in A.  A projector
    denominator that degenerates (repeated eigenvalues) is guarded by
    tiny = 1e-12 scale^2, and its coefficient vanishes in that limit."""
    c00, c01, c02, c11, c12, c22 = (C[..., i, :] for i in range(6))
    e_s, e_m, e_b = eigvals_sym_cols(C)
    c_s = torch.clamp(eps - e_s, min=0.0)
    c_m = torch.clamp(eps - e_m, min=0.0)
    c_b = torch.clamp(eps - e_b, min=0.0)
    s00 = c00 * c00 + c01 * c01 + c02 * c02
    s01 = c00 * c01 + c01 * c11 + c02 * c12
    s02 = c00 * c02 + c01 * c12 + c02 * c22
    s11 = c01 * c01 + c11 * c11 + c12 * c12
    s12 = c01 * c02 + c11 * c12 + c12 * c22
    s22 = c02 * c02 + c12 * c12 + c22 * c22

    scale = torch.clamp(torch.maximum(e_b.abs(), e_s.abs()), min=eps)
    tiny = 1e-12 * scale * scale

    def coeff(num, den):
        safe = den > tiny
        return torch.where(safe, num / torch.where(safe, den, torch.ones_like(den)),
                           torch.zeros_like(den))

    # P_big ~ (A - e_s)(A - e_m) / ((e_b - e_s)(e_b - e_m))
    a_b = coeff(c_m - c_b, (e_b - e_s) * (e_b - e_m))
    # P_small ~ (A - e_m)(A - e_b) / ((e_s - e_m)(e_s - e_b))
    a_s = coeff(c_s - c_m, (e_s - e_m) * (e_s - e_b))

    def poly(t, d, a):
        # a (A^2 - t A + d I)
        return (a * (s00 - t * c00 + d), a * (s01 - t * c01), a * (s02 - t * c02),
                a * (s11 - t * c11 + d), a * (s12 - t * c12), a * (s22 - t * c22 + d))

    pb = poly(e_s + e_m, e_s * e_m, -a_b)
    ps = poly(e_m + e_b, e_m * e_b, a_s)
    return torch.stack(
        [c00 + c_m + pb[0] + ps[0], c01 + pb[1] + ps[1], c02 + pb[2] + ps[2],
         c11 + c_m + pb[3] + ps[3], c12 + pb[4] + ps[4], c22 + c_m + pb[5] + ps[5]],
        dim=-2,
    )


def _mahalanobis_terms(p, q, M):
    """Shared e / Me columns.  p, q: (..., 3, N); M: (..., 6, N)."""
    e0 = q[..., 0, :] - p[..., 0, :]
    e1 = q[..., 1, :] - p[..., 1, :]
    e2 = q[..., 2, :] - p[..., 2, :]
    m00, m01, m02, m11, m12, m22 = (M[..., i, :] for i in range(6))
    me0 = m00 * e0 + m01 * e1 + m02 * e2
    me1 = m01 * e0 + m11 * e1 + m12 * e2
    me2 = m02 * e0 + m12 * e1 + m22 * e2
    return (e0, e1, e2), (me0, me1, me2)


def error_cols(p, q, M, w):
    """Weighted Mahalanobis error sum_n w e^T M e; w is zero on invalid
    columns.  p, q: (..., 3, N); M: (..., 6, N); w: (..., N)."""
    (e0, e1, e2), (me0, me1, me2) = _mahalanobis_terms(p, q, M)
    return torch.sum(w * (e0 * me0 + e1 * me1 + e2 * me2), dim=-1)


def linearize_terms_cols(p, q, M):
    """The 28 per-column terms [err, H (21 unique), b (6)] of
    J^T M J, J^T M e and e^T M e with J = [skew(p) | -I], stacked (..., 28, N)
    in the order `unpack28` reads them."""
    p0, p1, p2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    m00, m01, m02, m11, m12, m22 = (M[..., i, :] for i in range(6))
    (e0, e1, e2), (me0, me1, me2) = _mahalanobis_terms(p, q, M)
    # G = M skew(p)
    g00 = m01 * p2 - m02 * p1
    g10 = m11 * p2 - m12 * p1
    g20 = m12 * p2 - m22 * p1
    g01 = m02 * p0 - m00 * p2
    g11 = m12 * p0 - m01 * p2
    g21 = m22 * p0 - m02 * p2
    g02 = m00 * p1 - m01 * p0
    g12 = m01 * p1 - m11 * p0
    g22 = m02 * p1 - m12 * p0
    return torch.stack(
        [
            e0 * me0 + e1 * me1 + e2 * me2,
            # H11 = -(skew(p) G), 6 unique
            p2 * g10 - p1 * g20, p2 * g11 - p1 * g21, p2 * g12 - p1 * g22,
            p0 * g21 - p2 * g01, p0 * g22 - p2 * g02, p1 * g02 - p0 * g12,
            # H12 = skew(p) M (9)
            p1 * m02 - p2 * m01, p1 * m12 - p2 * m11, p1 * m22 - p2 * m12,
            p2 * m00 - p0 * m02, p2 * m01 - p0 * m12, p2 * m02 - p0 * m22,
            p0 * m01 - p1 * m00, p0 * m11 - p1 * m01, p0 * m12 - p1 * m02,
            # H22 = M (6)
            m00, m01, m02, m11, m12, m22,
            # b = [-p x Me; -Me]
            p2 * me1 - p1 * me2, p0 * me2 - p2 * me0, p1 * me0 - p0 * me1,
            -me0, -me1, -me2,
        ],
        dim=-2,
    )


def unpack28(s):
    """(28,) sums [err, H (21), b (6)] -> (err (), H (6, 6), b (6,)); the
    order of `pallas_linearize._unpack_out` in the JAX package."""
    (h00, h01, h02, h11, h12, h22,
     a00, a01, a02, a10, a11, a12, a20, a21, a22,
     t00, t01, t02, t11, t12, t22) = (s[k] for k in range(1, 22))
    H = torch.stack([
        torch.stack([h00, h01, h02, a00, a01, a02]),
        torch.stack([h01, h11, h12, a10, a11, a12]),
        torch.stack([h02, h12, h22, a20, a21, a22]),
        torch.stack([a00, a10, a20, t00, t01, t02]),
        torch.stack([a01, a11, a21, t01, t11, t12]),
        torch.stack([a02, a12, a22, t02, t12, t22]),
    ])
    return s[0], H, s[22:28]


def linearize_cols(p, q, M, w):
    """Weighted (err, H (6, 6), b (6,)) summed over columns; w is zero on
    invalid columns."""
    return unpack28(torch.sum(linearize_terms_cols(p, q, M) * w[..., None, :], dim=-1))
