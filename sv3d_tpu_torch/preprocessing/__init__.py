"""Copies of the host-side labelling code that training needs (the port
imports nothing of sv3d_tpu)."""
