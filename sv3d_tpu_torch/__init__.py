"""sv3d_tpu_torch — the PyTorch + CUDA (Hopper) port of sv3d_tpu.

The JAX package ``sv3d_tpu`` is the reference; this package mirrors its layout
and names so each module's counterpart is easy to find.  It imports torch and
never jax or flax, and nothing of sv3d_tpu: what it needs of the JAX
package's host modules it keeps as its own copies (config, io, native,
utils, data).  Public layouts match the JAX package: grids are
(B, D0, D1, D2, 1), points (B, N, 3) with points[..., i] addressing grid axis
i, images (B, H, W, 3).

Layout (the serving slice, image -> mesh; the training slice; arbitrary-point
inference):
  geometry      - camera / frustum / grid-space transforms
  ops           - voxelization, Gaussian smoothing, the gather sampler,
                  point-query features, pyramid flattening, lattice
                  interpolation matrices (plain torch)
  ops/cuda      - hand-written Hopper kernels (csrc/*.cu), their wrappers and
                  autograd.Functions, and the nvcc build
  models        - UNet / UNetMini / Projection / IFNet / SceneNet nn.Modules
                  and the flax-semantics BatchNorm
  config        - Config / IFNetConfig / ProjectionConfig
  io, native,   - EXR / image / OBJ / .df formats, the host C++ geometry
  utils           library (marching cubes, triangle hash, KD-tree), meshing
                  dumps, the step timer
  data          - datasets, the batching loader, split files
  preprocessing - occupancy labelling of point clouds against GT meshes
  training      - SceneNetTrainer, the loop, checkpoints, optimizer, CLI
  inference     - dense-grid sweep, arbitrary-point evaluation, meshing and
                  the serving CLI
  parallel      - the (dp, sp) mesh over torch.distributed: process group,
                  batch rows and point slices, gradient all-reduce
  convert       - flax {"params", "batch_stats"} tree -> this package's state_dict
"""

__version__ = "0.1.0"
