"""IF-Net-only trainer on precomputed depth grids (port of
sv3d_tpu/training/trainer_ifnet.py).

    python -m sv3d_tpu_torch.training.trainer_ifnet --device cuda \
        --datasetdir data --splitsdir overfit --fused_query --visualize ...

Loss: binary cross-entropy with logits, summed over a sample's points and
meaned over the batch (train_ce_loss, val_ce_loss).  Under --fused_query the
step runs the point-query kernels (K4 forward, K7/K8 backward) and the eval
step K4.  Validation meshes each sample's prediction through the dense sweep
(K2 bf16 on the card) and the GT distance field at level 1.0.  --precision
16 runs the conv stages in bf16 on f32 parameters (the point queries keep
their f32 interface).

The datasets take config.scale_factor, so the GT distance field is read at
the grid's dims.  (The JAX trainer builds them without it: at scale_factor >
1 its GT mesh is written at full resolution, beside a prediction at
config.dims.)

Under a multi-GPU mesh (--dp, --sp) each rank takes its dp row's samples
and its sp slice of their points (shard_batch).  The loss sums over a
sample's points, so the sp shares of one sample add: the gradients are
summed over the ranks and divided by dp, and the logged losses likewise.
Validation's meshes are swept by every rank of the mesh (the lattice rows
split over sp) and written by rank 0.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sv3d_tpu_torch.config import Config
from sv3d_tpu_torch.data.datasets import ImplicitDataset
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.parallel import shard_batch
from sv3d_tpu_torch.training.loop import BaseTrainer, to_device
from sv3d_tpu_torch.training.optim import build_optimizer
from sv3d_tpu_torch.training.state import TrainState
from sv3d_tpu_torch.utils.profiling import span

#: the batch entries that go to the device (the GT distance field stays on
#: the host for the meshing)
TENSORS = ("input", "points", "occupancies")


def ce_loss(logits: torch.Tensor, occupancies: torch.Tensor) -> torch.Tensor:
    """BCE with logits summed over the points (B, N), meaned over the batch."""
    ce = F.binary_cross_entropy_with_logits(logits, occupancies, reduction="none")
    return ce.sum(dim=-1).mean()


def _global(loss: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's ce_loss from each rank's: summed over the ranks
    (the sp shares of a sample's points add), divided by dp."""
    if mesh is None:
        return loss
    return mesh.sum_(loss.detach().clone()) / mesh.dp


def train_step(state: TrainState, batch: dict, mesh=None) -> dict:
    """One optimizer step on a batch of device tensors, in place on state.
    mesh: a multi-GPU Mesh (batch is this rank's rows and points)."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    with span("train.forward", device=True):
        loss = ce_loss(model(batch["input"], batch["points"]), batch["occupancies"])
    with span("train.backward", device=True):
        loss.backward()
    with span("train.optimizer", device=True):
        if mesh is not None:
            mesh.mean_gradients(model.parameters(), divisor=mesh.dp)
        opt.step()
    state.step += 1
    return {"train_ce_loss": _global(loss.detach(), mesh)}


def eval_step(state: TrainState, batch: dict, mesh=None) -> dict:
    model = state.model
    model.eval()
    with torch.no_grad():
        logits = model(batch["input"], batch["points"])
    return {"val_ce_loss": _global(ce_loss(logits, batch["occupancies"]), mesh)}


class ImplicitRefinementTrainer(BaseTrainer):
    monitor = "val_ce_loss"

    def build_state(self) -> TrainState:
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed)
        dt = None if cfg.precision == 32 else cfg.dtype
        model = IFNet(cfg.ifnet(), device=self.device, generator=gen, dtype=dt)
        return TrainState(model, build_optimizer(cfg.lr, model))

    def _dataset(self, split):
        c = self.config
        return ImplicitDataset(split, c.datasetdir, c.num_points, c.splitsdir, seed=c.seed,
                               scale_factor=c.scale_factor)

    def train_dataset(self):
        return self._dataset("train")

    def val_dataset(self):
        return self._dataset("val")

    def _device_batch(self, batch):
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        return to_device(batch, self.device, TENSORS)

    def train_step(self, state, batch, generator):
        with span("train.step"):
            return train_step(state, self._device_batch(batch), self.mesh)

    def eval_step(self, state, batch):
        return eval_step(state, self._device_batch(batch), self.mesh)

    def visualize(self, state, batch, out_dir: Path):
        """<name>_predicted.obj (the dense sweep at inf_res, level 0.5) and,
        when the batch has the GT distance field, <name>_gt.obj (level 1.0),
        for each sample; a name's directories are made as needed.  Under a
        mesh every rank sweeps its share and rank 0 writes."""
        from sv3d_tpu_torch.inference.dense_grid import implicit_to_mesh
        from sv3d_tpu_torch.utils.visualize import visualize_sdf

        model = state.model
        grid = torch.as_tensor(np.asarray(batch["input"], np.float32), device=self.device)
        model.eval()
        try:
            for i, name in enumerate(batch["name"]):
                base = out_dir / str(name)
                if self.is_main:
                    base.parent.mkdir(parents=True, exist_ok=True)
                implicit_to_mesh(model, grid[i:i + 1], self.config.dims, 0.5,
                                 f"{base}_predicted.obj", res_increase=self.config.inf_res,
                                 mesh=self.mesh)
                if "target" in batch and self.is_main:
                    visualize_sdf(np.asarray(batch["target"][i])[..., 0], f"{base}_gt.obj",
                                  level=1.0)
        finally:
            model.train()


def train_implicit_refinement(config: Config, device="cuda", max_steps=None):
    return ImplicitRefinementTrainer(config, device=device).fit(max_steps=max_steps)


def cli_main(argv=None):
    from sv3d_tpu_torch.training.cli import parse_config

    config, device = parse_config(argv)
    train_implicit_refinement(config, device)


if __name__ == "__main__":
    cli_main()
