"""fast_gicp_tpu_torch — the PyTorch/CUDA port of fast_gicp_tpu for Hopper.

Three registration families run on the card, through functions and
through the PCL-shaped class API (`FastGICP`, `FastGICPSingleThread`,
`FastVGICP`, `FastVGICPCuda` on `models.base.Registration`):
  * `models.vgicp.vgicp_register`: RBF kernel-density covariances for both
    clouds, a dense raw voxel grid of the target and a two-phase
    Levenberg-Marquardt solve; `vgicp_register_fresh` and the class API
    also on the hash-table and sparse-grid voxel maps
    (`ops.voxelmap.build_voxelmap`, four accumulation modes);
  * `models.gicp.gicp_register_fresh`: kNN, RBF or adaptive-radius
    covariances for both clouds (five regularizations) and an LM solve with exact 1-NN correspondences re-searched at every
    linearization (FastGICP); `models.metrics.fitness_score` scores a pose;
  * `models.ndt`: NDT, D2D and P2D, on dense NDT grids or the hash map --
    `ndt_register_fresh` (each cloud's map prepared in its own frame, as
    NDTCuda's fresh align), `ndt_align` (raw target grid, optionally
    two-phase) and the class `NDTCuda` (alias `NDT`);
  * `models.experimental.FastGICPMultiPoints` (weighted multi-point
    correspondences), `models.batch` (B pairs a call) and `pygicp`
    (`align_points` and the pygicp names);
  * odometry: `models.scan_to_map.ScanToMapOdometry` (a persistent world
    voxel map each scan is aligned to and fused into, localization on a
    frozen map), the scan-to-scan odometry of `utils.kitti` and the KITTI
    app (`python -m fast_gicp_tpu_torch.apps.kitti`).
Their fifteen kernels are hand-written CUDA C++ (`csrc/*.cu`), built with
nvcc for sm_90a at first use; each has a plain PyTorch twin that runs for
CPU tensors.

This package imports torch and numpy only: never jax and never the JAX
package `fast_gicp_tpu`, which stays the reference.
"""

from .models.base import Registration  # noqa: F401
from .models.batch import gicp_align_batch, ndt_align_batch, vgicp_align_batch  # noqa: F401
from .models.experimental import (  # noqa: F401
    FastGICPMultiPoints,
    MultiPointConfig,
    multipoint_align,
)
from .models.gicp import (  # noqa: F401
    FastGICP,
    FastGICPSingleThread,
    GICPConfig,
    gicp_align,
    gicp_evaluate,
    gicp_register_fresh,
)
from .models.metrics import fitness_score  # noqa: F401
from .models.ndt import (  # noqa: F401
    NDT,
    NDTConfig,
    NDTCuda,
    ndt_align,
    ndt_align_prebuilt,
    ndt_evaluate,
    ndt_prepare_cloud,
    ndt_register_fresh,
)
from .models.scan_to_map import (  # noqa: F401
    MapState,
    ScanToMapConfig,
    ScanToMapOdometry,
    align_to_map,
    load_map,
    save_map,
    update_map,
)
from .models.vgicp import (  # noqa: F401
    FastVGICP,
    FastVGICPCuda,
    VGICPConfig,
    vgicp_align,
    vgicp_align_multires,
    vgicp_evaluate,
    vgicp_mahalanobis,
    vgicp_register,
    vgicp_register_fresh,
)
from .ops.covariance import (  # noqa: F401
    adaptive_radius_covariances,
    covariances_from_neighbors,
    knn_covariances,
    rbf_covariances,
)
from .ops.voxelmap import (  # noqa: F401
    GridVoxelMap,
    VoxelMap,
    build_voxelmap,
    lookup_voxels,
    lookup_voxels_cols,
)
from .ops.neighbors import knn_search, knn_search_culled  # noqa: F401
from .solver import LsqConfig, LsqResult, lsq_solve  # noqa: F401
