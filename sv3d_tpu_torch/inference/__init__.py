"""Inference of the port: dense-grid sweeps and meshing (dense_grid), the
serving CLI (predict)."""

from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid, implicit_to_mesh

__all__ = ["evaluate_on_grid", "implicit_to_mesh"]
