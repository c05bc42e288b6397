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


def create_train_state(model: nn.Module, variables, optimizer: torch.optim.Optimizer
                       ) -> TrainState:
    """A step-0 TrainState of model with variables loaded (a state_dict, such
    as convert.from_flax gives for the JAX package's variables; None keeps
    the model's own) and its optimizer: the JAX package's
    create_train_state(model, variables, tx)."""
    if variables is not None:
        model.load_state_dict(variables)
    return TrainState(model, optimizer)
