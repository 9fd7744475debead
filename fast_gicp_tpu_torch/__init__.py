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
    app (`python -m fast_gicp_tpu_torch.apps.kitti`);
  * the SLAM back-end: `models.loop_closure.detect_loop_closures`
    (candidates from the trajectory, verified by NDT then VGICP), the dense
    `models.pose_graph.optimize_pose_graph`, the sparse
    `models.pose_graph_sparse.optimize_pose_graph_sparse` (block-PCG with
    a block-tridiagonal preconditioner, `ops.cuda_pose_graph`) and
    `SlidingWindowBA`, each solve one CUDA graph by default (its loops
    conditional nodes, `graphs`);
  * multi-device on `torch.distributed` (`parallel`): the aligns with the
    source split across ranks, the multi-process launch, the edge-sharded
    `optimize_pose_graph_sparse_sharded` and the hash-sharded persistent
    map of `parallel.sharded_map.ShardedScanToMapOdometry`.
Their kernels are hand-written CUDA C++ (`csrc/*.cu`), built with
nvcc for sm_90a at first use: the fifteen ports of the JAX package's
Pallas kernels, the block-tridiagonal solve and the device loops' condition kernels; each
has a plain PyTorch twin that runs for CPU tensors.

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
from .models.loop_closure import (  # noqa: F401
    LoopClosure,
    LoopClosureConfig,
    detect_loop_closures,
    find_loop_candidates,
)
from .models.metrics import fitness_score, pose_error  # noqa: F401
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
from .models.pose_graph import (  # noqa: F401
    PoseGraphConfig,
    PoseGraphResult,
    optimize_pose_graph,
)
from .models.pose_graph_sparse import (  # noqa: F401
    SlidingWindowBA,
    SparsePGConfig,
    optimize_pose_graph_sparse,
    optimize_pose_graph_sparse_sharded,
)
from .models.scan_to_map import (  # noqa: F401
    MapState,
    ScanToMapConfig,
    ScanToMapOdometry,
    align_to_map,
    load_map,
    merge_maps,
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
