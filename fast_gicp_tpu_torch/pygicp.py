"""pygicp-compatible functional API (port of `fast_gicp_tpu.pygicp`).

Mirrors the reference's pybind11 module (src/python/main.cpp:152-224):
`downsample(points, resolution)`, the one-shot `align_points(...)` with the
same method strings, keyword arguments and defaults (main.cpp:155-167), and
the classes under their pygicp names.  The registrations run on the card
unless the caller passes device="cpu".
"""

from __future__ import annotations

import math

import numpy as np

from .models.base import Registration
from .models.gicp import FastGICP, FastGICPSingleThread
from .models.ndt import NDTCuda
from .models.vgicp import FastVGICP, FastVGICPCuda
# pygicp.downsample is pcl::ApproximateVoxelGrid in the reference
# (main.cpp:46-62): the PCL-compatible streaming-hash emulation, so point
# counts and fitness scores line up with published numbers
from .utils.downsample import approximate_voxel_downsample as downsample
from .utils.downsample import voxel_downsample

LsqRegistration = Registration

_METHODS = ("GICP", "VGICP", "VGICP_CUDA", "NDT_CUDA")


def _make_reg(method: str, k_correspondences: int, max_correspondence_distance: float,
              voxel_resolution: float, neighbor_search_method: str,
              neighbor_search_radius: float, device="cuda"):
    """A registration object configured by method string (main.cpp:78-142),
    on `device`."""
    nsm = neighbor_search_method.lower()
    if method == "GICP":
        reg = FastGICP(device=device)
        reg.set_correspondence_randomness(k_correspondences)
    elif method == "VGICP":
        reg = FastVGICP(device=device)
        reg.set_correspondence_randomness(k_correspondences)
        reg.set_resolution(voxel_resolution)
        reg.set_neighbor_search_method(nsm, neighbor_search_radius)
    elif method == "VGICP_CUDA":
        reg = FastVGICPCuda(device=device)
        reg.set_resolution(voxel_resolution)
        reg.set_neighbor_search_method(nsm, neighbor_search_radius)
    elif method == "NDT_CUDA":
        reg = NDTCuda(device=device)
        reg.set_resolution(voxel_resolution)
        reg.set_neighbor_search_method(nsm, neighbor_search_radius)
    else:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    reg.set_max_correspondence_distance(max_correspondence_distance)
    return reg


def align_points(target: np.ndarray, source: np.ndarray, method: str = "GICP",
                 downsample_resolution: float = -1.0, k_correspondences: int = 15,
                 max_correspondence_distance: float = math.inf,
                 voxel_resolution: float = 1.0, num_threads: int = 0,
                 neighbor_search_method: str = "DIRECT1",
                 neighbor_search_radius: float = 1.5,
                 initial_guess: np.ndarray | None = None, device="cuda") -> np.ndarray:
    """One-shot alignment; returns the 4x4 source -> target transform
    (main.cpp:64-142).  `num_threads` is accepted for signature parity and
    ignored.  Runs on `device` (CUDA unless the caller asks for the CPU)."""
    del num_threads
    target = downsample(np.asarray(target), downsample_resolution)
    source = downsample(np.asarray(source), downsample_resolution)
    reg = _make_reg(method, k_correspondences, max_correspondence_distance,
                    voxel_resolution, neighbor_search_method, neighbor_search_radius,
                    device=device)
    reg.set_input_target(target)
    reg.set_input_source(source)
    return reg.align(initial_guess)


__all__ = [
    "downsample",
    "voxel_downsample",
    "align_points",
    "LsqRegistration",
    "FastGICP",
    "FastGICPSingleThread",
    "FastVGICP",
    "FastVGICPCuda",
    "NDTCuda",
]
