"""Train state (port of sv3d_tpu/training/state.py): the model (parameters
and BatchNorm running statistics), its optimizer, and the optimizer-step
count.  torch updates the first two in place; step counts applied updates."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
