"""Plain torch ops of the serving slice; the hand-written kernels and their
wrappers live in sv3d_tpu_torch.ops.cuda."""
