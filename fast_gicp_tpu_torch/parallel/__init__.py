"""Multi-device registration on `torch.distributed` (port of
`fast_gicp_tpu.parallel`).

The JAX package runs one controller over a device `Mesh` and lets
`shard_map` split the arrays.  Here every rank is a process with one
device, and `mesh.Mesh` holds the process group, the rank, the world size
and the rank's device.  Where the JAX package threads an `axis_name` through
the objectives and sums with `psum`, the port threads `reduce`, a sum
all-reduce over the mesh's group (`Mesh.reduce`):

  * `sharded`: GICP, VGICP and NDT aligns with the source split across the
    ranks and the target replicated (`make_mesh`, `*_align_sharded`);
  * `distributed`: the multi-process launch (`initialize`,
    `make_global_mesh`, `shard_across`, `replicate`, `*_align_multihost`);
  * `sharded_map`: the persistent scan-to-map voxel map sharded by a hash
    of the voxel coordinates (`ShardedScanToMapOdometry`).

The edge-sharded pose graph is
`models.pose_graph_sparse.optimize_pose_graph_sparse_sharded`.
"""
