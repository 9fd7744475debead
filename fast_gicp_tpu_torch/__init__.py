"""fast_gicp_tpu_torch — the PyTorch/CUDA port of fast_gicp_tpu for Hopper.

Three registration families run on the card:
  * `models.vgicp.vgicp_register`: RBF kernel-density covariances for both
    clouds, a dense raw voxel grid of the target and a two-phase
    Levenberg-Marquardt solve;
  * `models.gicp.gicp_register_fresh`: kNN, RBF or adaptive-radius
    covariances for both clouds (five regularizations) and an LM solve with exact 1-NN correspondences re-searched at every
    linearization (FastGICP); `models.metrics.fitness_score` scores a pose;
  * `models.ndt`: NDT, D2D and P2D, on dense NDT grids --
    `ndt_register_fresh` (each cloud's map prepared in its own frame, as
    NDTCuda's fresh align) and `ndt_align` (raw target grid, optionally
    two-phase).
Their fifteen kernels are hand-written CUDA C++ (`csrc/*.cu`), built with
nvcc for sm_90a at first use; each has a plain PyTorch twin that runs for
CPU tensors.

This package imports torch and numpy only: never jax and never the JAX
package `fast_gicp_tpu`, which stays the reference.
"""

from .models.gicp import GICPConfig, gicp_align, gicp_register_fresh  # noqa: F401
from .models.metrics import fitness_score  # noqa: F401
from .models.ndt import (  # noqa: F401
    NDTConfig,
    ndt_align,
    ndt_align_prebuilt,
    ndt_evaluate,
    ndt_prepare_cloud,
    ndt_register_fresh,
)
from .models.vgicp import VGICPConfig, vgicp_align, vgicp_register  # noqa: F401
from .ops.covariance import (  # noqa: F401
    adaptive_radius_covariances,
    knn_covariances,
    rbf_covariances,
)
from .ops.neighbors import knn_search, knn_search_culled  # noqa: F401
from .solver import LsqConfig, LsqResult, lsq_solve  # noqa: F401
