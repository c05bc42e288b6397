"""End-to-end training of the port: SceneNetTrainer and its loop,
checkpoints, optimizer and CLI.  Modules are imported by their full names;
this package imports nothing at import time."""
