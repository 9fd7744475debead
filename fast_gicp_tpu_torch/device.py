"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; on a host
without CUDA the default raises instead of dropping silently to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device) -> torch.device:
    """`device` ("cuda", "cpu", "cuda:1" or a torch.device) checked for
    availability; raises for CUDA on a host without it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_f32(a, device: torch.device) -> torch.Tensor:
    """numpy array or tensor -> contiguous float32 tensor on `device`."""
    return torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()


def as_bool(a, device: torch.device) -> torch.Tensor:
    """numpy array or tensor -> bool tensor on `device`."""
    return torch.as_tensor(a, device=device).to(torch.bool)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device` (same dtype) with no host sync:
    to CUDA it is staged in pinned memory and copied asynchronously on the
    current stream (a copy from pageable memory waits for the stream to
    drain).  The odometry uploads every scan this way."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
