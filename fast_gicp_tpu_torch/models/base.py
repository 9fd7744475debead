"""The target-centroid frame every align and evaluation runs in (port of
`fast_gicp_tpu.models.base.centered_frame_align` and
`centered_frame_evaluate`)."""

from __future__ import annotations

from .. import se3
from ..ops.covariance import masked_mean


def centered_frame_align(run, source, target, target_mask, guess):
    """Run an align in the TARGET-CENTROID frame, report world results.

    The Jacobian J = [skew(T p) | -I] puts |p|^2-scale entries into the
    f32-accumulated normal equations; about the target centroid the lever
    arms are bounded by the cloud extent.  The pose conjugates back exactly
    (X = T(c) X' T(-c)) and the reported 6x6 returns to world twists
    through the translation adjoint (H = A^T H' A).

    `run(source_c, target_c, guess_c) -> LsqResult` is the uncentered align
    body; covariances are translation-invariant and pass through outside.
    """
    c = masked_mean(target, target_mask)
    res = run(
        source - c,
        target - c,
        se3.conjugate_to_centered(guess.to(target.dtype), c),
    )
    A = se3.adjoint_translation(c)
    return res._replace(
        transformation=se3.conjugate_from_centered(res.transformation, c),
        hessian=A.T @ res.hessian @ A,
    )


def centered_frame_evaluate(run, source, target, target_mask, pose):
    """`centered_frame_align`'s twin for evaluating the objective:
    `run(source_c, target_c, pose_c) -> (err, H', b')` evaluates it in the
    target-centroid frame; the returned (err, H, b) are world-frame (err
    is frame-invariant; H and b return through the translation adjoint),
    consistent with the aligns' reported Hessian."""
    c = masked_mean(target, target_mask)
    err, H, b = run(
        source - c,
        target - c,
        se3.conjugate_to_centered(pose.to(target.dtype), c),
    )
    A = se3.adjoint_translation(c)
    return err, A.T @ H @ A, A.T @ b
