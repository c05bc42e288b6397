"""Optimizer construction with per-module learning-rate groups (port of
sv3d_tpu/training/optim.py): Adam with torch-default hyperparameters, and the
projection module's learnable sigma at project_lr_scale x lr (the end-to-end
trainer gives it 10x)."""

from __future__ import annotations

import torch
from torch import nn


def build_optimizer(lr: float, model: nn.Module, project_lr_scale: float = 10.0):
    """Adam(betas=(0.9, 0.999), eps=1e-8) over model's parameters; those of a
    top-level `project` submodule, if any, form a second group at
    project_lr_scale * lr."""
    project = [p for n, p in model.named_parameters() if n.split(".")[0] == "project"]
    base = [p for n, p in model.named_parameters() if n.split(".")[0] != "project"]
    groups = [{"params": base, "lr": lr}]
    if project:
        groups.append({"params": project, "lr": lr * project_lr_scale})
    return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
