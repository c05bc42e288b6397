"""sv3d_tpu_torch — the PyTorch + CUDA (Hopper) port of sv3d_tpu.

The JAX package ``sv3d_tpu`` is the reference; this package mirrors its layout
and names so each module's counterpart is easy to find.  It imports torch and
never jax or flax.  Public layouts match the JAX package: grids are
(B, D0, D1, D2, 1), points (B, N, 3) with points[..., i] addressing grid axis
i, images (B, H, W, 3).

Layout (the serving slice, image -> mesh, and the training slice):
  geometry      - camera / frustum / grid-space transforms
  ops           - voxelization, Gaussian smoothing, the gather sampler,
                  point-query features, pyramid flattening, lattice
                  interpolation matrices (plain torch)
  ops/cuda      - hand-written Hopper kernels (csrc/*.cu), their wrappers and
                  autograd.Functions, and the nvcc build
  models        - UNet / UNetMini / Projection / IFNet / SceneNet nn.Modules
                  and the flax-semantics BatchNorm
  data          - SceneNetDataset (JAX-free intrinsics reading)
  preprocessing - occupancy labelling of point clouds against GT meshes
  training      - SceneNetTrainer, the loop, checkpoints, optimizer, CLI
  inference     - dense-grid sweep, meshing and the serving CLI
  convert       - flax {"params", "batch_stats"} tree -> this package's state_dict
"""

__version__ = "0.1.0"
