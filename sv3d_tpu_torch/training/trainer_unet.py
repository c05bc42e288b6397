"""UNet-only depth regression trainer (port of
sv3d_tpu/training/trainer_unet.py).

    python -m sv3d_tpu_torch.training.trainer_unet --device cuda \
        --datasetdir data --splitsdir overfit --visualize ...

Forward: UNetMini on the 240x320 image, or UNet on its 256x256 square
resize (--resize_input, then resized and cropped back to 240x320), sigmoid
renormalized into [min_z, max_z]; loss = mean squared error against the GT
depth (train_loss, val_loss).  --precision 16 runs the UNet in bf16 on f32
parameters and widens its logits to f32 before the resize and the sigmoid.  Validation writes each predicted depth map as
<name>/depth_map.exr.  The checkpoint's model is the UNet itself, which
SceneNetTrainer's --pretrain_unet loads (load_pretrained_unet).  Under a
multi-GPU mesh each dp row of ranks takes its rows (the sp ranks of a row
repeat its step), and the gradients and losses are averaged over the ranks.
"""

from __future__ import annotations

from pathlib import Path

import torch

from sv3d_tpu_torch.config import Config
from sv3d_tpu_torch.data.datasets import DepthDataset
from sv3d_tpu_torch.io.exr import write_exr
from sv3d_tpu_torch.models.mixed import widen
from sv3d_tpu_torch.models.unet import UNet, UNetMini, renormalize_depth, resize_crop_depth
from sv3d_tpu_torch.training.loop import BaseTrainer, to_device
from sv3d_tpu_torch.training.optim import build_optimizer
from sv3d_tpu_torch.training.state import TrainState

#: the batch entries that go to the device
TENSORS = ("input", "target")


def depth_forward(model, config: Config, rgb: torch.Tensor) -> torch.Tensor:
    """rgb (B, H, W, 3) -> (B, 240, 320) renormalized depth, in the module's
    train/eval mode.  bf16 logits (precision 16) widen to f32 first, as the
    JAX package casts them; f32 and float64 ones stay as they are, so a
    float64 copy of the model stays exact."""
    logits = widen(model(rgb))
    if config.resize_input:
        logits = resize_crop_depth(logits)
    return renormalize_depth(logits[..., 0], config.min_z, config.max_z)


def _global(loss: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's mean from each rank's (equal shares)."""
    return loss if mesh is None else mesh.sum_(loss.detach().clone()) / mesh.size


def train_step(state: TrainState, batch: dict, config: Config, mesh=None) -> dict:
    """One optimizer step on a batch of device tensors, in place on state.
    mesh: a multi-GPU Mesh (batch is this rank's rows)."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = torch.mean((depth_forward(model, config, batch["input"]) - batch["target"]) ** 2)
    loss.backward()
    if mesh is not None:
        mesh.mean_gradients(model.parameters())
    opt.step()
    state.step += 1
    return {"train_loss": _global(loss.detach(), mesh)}


def eval_forward(state: TrainState, batch: dict, config: Config, mesh=None) -> tuple:
    """(eval-mode depth, {"val_loss": mean squared error})."""
    state.model.eval()
    with torch.no_grad():
        depth = depth_forward(state.model, config, batch["input"])
    return depth, {"val_loss": _global(torch.mean((depth - batch["target"]) ** 2), mesh)}


class DepthRegressorTrainer(BaseTrainer):
    monitor = "val_loss"

    def build_state(self) -> TrainState:
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed)
        net = UNet if cfg.resize_input else UNetMini
        dt = None if cfg.precision == 32 else cfg.dtype
        model = net(channels_out=1, device=self.device, generator=gen, dtype=dt)
        return TrainState(model, build_optimizer(cfg.lr, model))

    def _dataset(self, split):
        c = self.config
        return DepthDataset(split, c.datasetdir, c.splitsdir, c.resize_input, c.W, seed=c.seed)

    def train_dataset(self):
        return self._dataset("train")

    def val_dataset(self):
        return self._dataset("val")

    def train_step(self, state, batch, generator):
        return train_step(state, to_device(batch, self.device, TENSORS), self.config,
                          self.mesh)

    def eval_step(self, state, batch):
        return eval_forward(state, to_device(batch, self.device, TENSORS), self.config,
                            self.mesh)[1]

    def visualize(self, state, batch, out_dir: Path):
        if not self.is_main:  # no collective here: the other ranks have nothing to do
            return
        depth, _ = eval_forward(state, to_device(batch, self.device, TENSORS), self.config)
        depth = depth.cpu().numpy()
        for i, name in enumerate(batch["name"]):
            d = out_dir / name
            d.mkdir(parents=True, exist_ok=True)
            write_exr(d / "depth_map.exr", depth[i])


def train_unet(config: Config, device="cuda", max_steps=None):
    return DepthRegressorTrainer(config, device=device).fit(max_steps=max_steps)


def cli_main(argv=None):
    from sv3d_tpu_torch.training.cli import parse_config

    config, device = parse_config(argv)
    train_unet(config, device)


if __name__ == "__main__":
    cli_main()
