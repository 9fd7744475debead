"""SE(3)/SO(3) math on torch tensors (port of `fast_gicp_tpu.se3`).

Quaternion-free Rodrigues `so3_exp` with the reference's small-angle Taylor
switch (theta^2 < 1e-10, so3.hpp:64), rotation-first `se3_exp` with the
V-matrix on the translation, their logarithms, and the target-centroid
frame conjugations used by every align.  Branchless (`torch.where`) and
batched over leading dims; the twist convention is ``xi = [omega, rho]``.
"""

from __future__ import annotations

import torch

# Small-angle switch matching reference so3.hpp:64 (theta_sq < 1e-10).
_SMALL_ANGLE_SQ = 1e-10


def skew(v):
    """Skew-symmetric matrix of a 3-vector; batched over leading dims.
    skew(v) @ x == cross(v, x)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(omega):
    """so(3) -> SO(3) through the unit quaternion, with the 4th-order
    Taylor expansions of sin(t/2)/t and cos(t/2) for theta^2 < 1e-10."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < _SMALL_ANGLE_SQ
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    theta_quad = theta_sq * theta_sq

    imag_taylor = 0.5 - theta_sq / 48.0 + theta_quad / 3840.0
    real_taylor = 1.0 - theta_sq / 8.0 + theta_quad / 384.0
    half_theta = 0.5 * theta
    imag = torch.where(small, imag_taylor, torch.sin(half_theta) / theta)
    real = torch.where(small, real_taylor, torch.cos(half_theta))
    return _quat_to_matrix(
        real, imag * omega[..., 0], imag * omega[..., 1], imag * omega[..., 2]
    )


def _quat_to_matrix(w, x, y, z):
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack(
                [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], -1
            ),
            torch.stack(
                [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], -1
            ),
            torch.stack(
                [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], -1
            ),
        ],
        dim=-2,
    )


def se3_exp(xi):
    """se(3) -> SE(3) as a 4x4 matrix: R = so3_exp(omega), t = V rho with
    V = I + (1-cos)/t^2 W + (t-sin)/t^3 W^2, and V := R for tiny theta."""
    omega = xi[..., :3]
    rho = xi[..., 3:6]
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < _SMALL_ANGLE_SQ
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(ts_safe)

    R = so3_exp(omega)
    W = skew(omega)
    W_sq = W @ W
    a = (1.0 - torch.cos(theta)) / ts_safe
    b = (theta - torch.sin(theta)) / (ts_safe * theta)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V_exact = eye + a[..., None, None] * W + b[..., None, None] * W_sq
    V = torch.where(small[..., None, None], R, V_exact)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return make_transform(R, t)


def so3_log(R):
    """SO(3) -> so(3) rotation vector for theta in [0, pi], with the
    Taylor-guarded theta/sin(theta) factor and the symmetric-part axis
    recovery near theta = pi (same branches as the JAX version)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = cos_t > 1.0 - 5e-7  # theta < ~1e-3
    cos_safe = torch.where(small, torch.zeros_like(cos_t), cos_t)
    theta = torch.where(small, torch.zeros_like(cos_t), torch.arccos(cos_safe))
    sin_t = torch.sin(theta)
    ts_small = torch.clamp(3.0 - trace, min=0.0)
    sin_safe = torch.where(sin_t.abs() < 1e-10, torch.ones_like(sin_t), sin_t)
    factor = torch.where(small, 0.5 + ts_small / 12.0, theta / (2.0 * sin_safe))
    omega_main = v * factor[..., None]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    S = 0.5 * (R + R.transpose(-1, -2)) - cos_t[..., None, None] * eye
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    col = torch.argmax(diag, dim=-1)
    axis_raw = torch.gather(
        S, -1, col[..., None, None].expand(S.shape[:-1] + (1,))
    )[..., 0]
    nrm_sq = torch.sum(axis_raw * axis_raw, dim=-1, keepdim=True)
    nrm = torch.sqrt(torch.where(nrm_sq < 1e-24, torch.ones_like(nrm_sq), nrm_sq))
    axis = axis_raw / nrm
    sign = torch.where(
        torch.sum(axis * v, dim=-1, keepdim=True) < 0, -1.0, 1.0
    ).to(R.dtype)
    omega_pi = axis * sign * theta[..., None]
    return torch.where((theta > 3.0)[..., None], omega_pi, omega_main)


def se3_log(T):
    """SE(3) -> se(3), inverse of `se3_exp`: rho = V^-1 t with
    V^-1 = I - W/2 + (1/theta^2 - (1+cos)/(2 theta sin)) W^2."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < _SMALL_ANGLE_SQ
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(ts_safe)
    W = skew(omega)
    W_sq = W @ W
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    sin_safe = torch.where(sin_t.abs() < 1e-10, torch.ones_like(sin_t), sin_t)
    coef_exact = 1.0 / ts_safe - (1.0 + cos_t) / (2.0 * theta * sin_safe)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0, coef_exact)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    V_inv = eye - 0.5 * W + coef[..., None, None] * W_sq
    rho = torch.einsum("...ij,...j->...i", V_inv, t)
    return torch.cat([omega, rho], dim=-1)


def orthonormalize(T):
    """Project the rotation block of (..., 4, 4) back onto SO(3) by
    Gram-Schmidt over its columns, keeping the translation.

    Feedback loops of the form delta <- inv(prev) @ align(prev @ delta)
    double the rotation's orthonormality defect every iteration (the
    transpose-based rigid inverse is an inverse only for exact rotations),
    so the f32 rounding seed (~1e-7) walks to O(0.1) within ~20 frames.
    Re-projecting once a frame keeps the defect at rounding level."""
    R = T[..., :3, :3]
    c0 = R[..., :, 0]
    c0 = c0 / torch.linalg.vector_norm(c0, dim=-1, keepdim=True)
    c1 = R[..., :, 1]
    c1 = c1 - torch.sum(c0 * c1, dim=-1, keepdim=True) * c0
    c1 = c1 / torch.linalg.vector_norm(c1, dim=-1, keepdim=True)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    return make_transform(torch.stack([c0, c1, c2], dim=-1), T[..., :3, 3])


def make_transform(R, t):
    """4x4 homogeneous transform from R (..., 3, 3) and t (..., 3)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # a fill: assigning a Python float here copies from the host
    return T


def transform_points(T, points):
    """Apply a 4x4 transform to (..., N, 3) points."""
    return points @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def rotate_covs(R, covs):
    """R C R^T for (N, 3, 3) covariances."""
    return torch.einsum("ij,njk,lk->nil", R, covs, R)


def invert_transform(T):
    """Inverse of a rigid (..., 4, 4) transform: [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def rotation_angle(R):
    """Angle (rad) of a rotation matrix, via its trace."""
    cos = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def conjugate_to_centered(x, c):
    """X' = T(-c) X T(c): the pose of both clouds shifted by -c.
    R' = R, t' = t - c + R c."""
    out = x.clone()
    out[..., :3, 3] = x[..., :3, 3] - c + torch.einsum(
        "...ij,j->...i", x[..., :3, :3], c
    )
    return out


def conjugate_from_centered(x_c, c):
    """Inverse of `conjugate_to_centered`: X = T(c) X' T(-c).
    R = R', t = t' + c - R' c."""
    out = x_c.clone()
    out[..., :3, 3] = x_c[..., :3, 3] + c - torch.einsum(
        "...ij,j->...i", x_c[..., :3, :3], c
    )
    return out


def adjoint_translation(c):
    """A (6x6) with exp(A xi) = T(-c) exp(xi) T(c): omega' = omega,
    rho' = rho - c x omega.  World normal equations from centered ones:
    H_world = A^T H' A."""
    A = torch.eye(6, dtype=c.dtype, device=c.device)
    A[3:6, 0:3] = -skew(c)
    return A
