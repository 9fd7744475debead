"""Matmul precision control (port of `fast_gicp_tpu.precision`).

Geometry (metre-scale coordinates, Mahalanobis algebra, 6x6 normal
equations) needs full float32 products.  PyTorch's float32 matmuls are
full precision by default, but cuDNN's are TF32 by default and either flag
may have been flipped by the caller, so every public entry point states
both explicitly for the duration of the call.
"""

from __future__ import annotations

import functools

import torch


def f32_matmuls(fn):
    """Decorator: run `fn` with TF32 off for matmuls and cuDNN, restoring
    the caller's settings afterwards."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    return wrapper
