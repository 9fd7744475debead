"""One Levenberg-Marquardt trial step: the CUDA kernel of
`csrc/lm_trial.cu` and its plain PyTorch version (port of
`fast_gicp_tpu.ops.pallas_solver`).

`lm_trial` is the counterpart of `lm_trial_pallas` (kernel
`_lm_trial_kernel`, `pallas_solver.py:127`): solve (H + lambda I) d = -b
with one refinement step, delta = se3_exp(d), xi = delta x and
denom = d . (lambda d - b).  lambda stays a device tensor, so a trial never
copies it to the host.
"""

from __future__ import annotations

import ctypes

import torch

from .. import se3
from . import _build

_P = ctypes.c_void_p
_TRIAL_ARGS = (_P, _P, _P, _P, _P, _P)


def _check(name, t, numel):
    if t.dtype != torch.float32 or t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} float32 values, got "
                         f"{tuple(t.shape)} {t.dtype}")


def lm_trial(H, b, lam, x):
    """(xi (4, 4), delta (4, 4), d (6,), denom ()) for one trial step.

    H (6, 6), b (6,), lam (a one-element tensor) and x (4, 4), float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check("H", H, 36)
    _check("b", b, 6)
    _check("lam", lam, 1)
    _check("x", x, 16)
    if H.device.type == "cpu":
        return lm_trial_plain(H, b, lam.reshape(()), x)
    for t in (H, b, lam, x):
        if t.device != H.device:
            raise ValueError(f"tensors on several devices: {t.device} vs {H.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if H.device.type != "cuda":
        raise ValueError(f"unsupported device {H.device}")
    out = torch.empty(39, dtype=torch.float32, device=H.device)
    fn = _build.function("fgt_lm_trial", _TRIAL_ARGS)
    stream = torch.cuda.current_stream(H.device).cuda_stream
    _build.check("fgt_lm_trial", fn(
        H.data_ptr(), b.data_ptr(), lam.data_ptr(), x.data_ptr(),
        out.data_ptr(), stream))
    lm_trial.launches += 1
    return out[:16].view(4, 4), out[16:32].view(4, 4), out[32:38], out[38]


lm_trial.launches = 0


def lm_trial_plain(H, b, lam, x):
    """Plain PyTorch version of `lm_trial` (the JAX solver's XLA trial,
    `solver.py:117-119`)."""
    from ..solver import _solve_refined  # solver imports this module

    d = _solve_refined(H + lam * torch.eye(6, dtype=H.dtype, device=H.device), -b)
    delta = se3.se3_exp(d)
    return delta @ x, delta, d, torch.dot(d, lam * d - b)
