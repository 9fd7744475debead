"""Command-line apps of the port (`python -m fast_gicp_tpu_torch.apps.kitti`)."""
