"""JAX-free copies of the host-side labelling code that training needs
(sv3d_tpu.preprocessing imports jax through its package __init__)."""
