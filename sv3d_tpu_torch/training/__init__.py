"""Training of the port: the three trainers (end-to-end SceneNetTrainer,
UNet-only DepthRegressorTrainer, IF-Net-only ImplicitRefinementTrainer),
their loop, checkpoints, optimizer and CLI.  The package exports the JAX
package's names (the train state and the optimizer); the trainers are
imported by their modules' full names."""

from sv3d_tpu_torch.training.optim import build_optimizer
from sv3d_tpu_torch.training.state import TrainState, create_train_state

__all__ = ["TrainState", "create_train_state", "build_optimizer"]
