"""Mesh reconstruction metrics (port of sv3d_tpu/evaluation)."""

from sv3d_tpu_torch.evaluation.metrics import distance_p2p, eval_mesh, eval_pointcloud

__all__ = ["eval_mesh", "eval_pointcloud", "distance_p2p"]
