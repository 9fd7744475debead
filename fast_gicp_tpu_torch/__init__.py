"""fast_gicp_tpu_torch — the PyTorch/CUDA port of fast_gicp_tpu for Hopper.

The main path, `models.vgicp.vgicp_register`, runs RBF kernel-density
covariances for both clouds, a dense raw voxel grid of the target and a
two-phase Levenberg-Marquardt solve, all on the card.  Its four kernels are
hand-written CUDA C++ (`csrc/*.cu`), built with nvcc for sm_90a at first
use; each has a plain PyTorch twin that runs for CPU tensors.

This package imports torch and numpy only: never jax and never the JAX
package `fast_gicp_tpu`, which stays the reference.
"""

from .models.vgicp import VGICPConfig, vgicp_align, vgicp_register  # noqa: F401
from .ops.covariance import rbf_covariances  # noqa: F401
from .solver import LsqConfig, LsqResult, lsq_solve  # noqa: F401
