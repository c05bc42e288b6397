"""Training of the port: the three trainers (end-to-end SceneNetTrainer,
UNet-only DepthRegressorTrainer, IF-Net-only ImplicitRefinementTrainer),
their loop, checkpoints, optimizer and CLI.  Modules are imported by their
full names; this package imports nothing at import time."""
