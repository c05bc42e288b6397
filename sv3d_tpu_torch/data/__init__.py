"""Datasets of the port: the JAX package's host-side datasets with JAX-free
camera reading."""
