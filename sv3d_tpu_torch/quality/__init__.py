"""Quality tooling of the port: synthetic scenes, the overfit and
multi-scene quality runs and their per-scene diagnosis, each runnable with
python -m sv3d_tpu_torch.quality.<module>."""
