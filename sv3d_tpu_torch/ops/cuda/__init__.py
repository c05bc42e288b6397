"""Hand-written Hopper kernels of the port and their wrappers.

Each wrapper runs its plain torch version for a CPU tensor and launches its
CUDA kernel for a CUDA tensor (or raises); it counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.  The kernels are built from
sv3d_tpu_torch/csrc/*.cu at first use (sv3d_tpu_torch.ops.cuda.build).
"""
