"""End-to-end scene reconstruction trainer (port of
sv3d_tpu/training/trainer_scene_net.py).

    python -m sv3d_tpu_torch.training.trainer_scene_net --device cuda \
        --datasetdir data --splitsdir overfit --fused_query ...

Losses: ce_loss = mean BCE-with-logits over all query points, mse_depth_loss
= mean squared depth error, loss = ce + mse (ce alone under no_depth_sup),
mesh_ce_loss = BCE over the mesh-sampled supervision points only, point_iou
at logit 0; the three sigma components are logged too.

subsample_points > 0 adds a random subset of the projected cloud to the
query set and labels it on the host against the GT mesh.  The labels belong
to the cloud that the same train-mode forward queried: eager torch returns
that cloud from the forward, the host labels it, and the loss takes the
labels.  (The JAX package labels the cloud of a separate eval-mode
projection pass; with the UNet on, its BatchNorm uses running averages
there and batch statistics in the step, so its labels belong to other
points than the ones queried.)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sv3d_tpu_torch.config import Config
from sv3d_tpu_torch.data.datasets import SceneNetDataset
from sv3d_tpu_torch.geometry import FrustumGrid, read_intrinsics
from sv3d_tpu_torch.models.scene_net import SceneNet
from sv3d_tpu_torch.preprocessing.occupancies import determine_occupancy
from sv3d_tpu_torch.training.loop import BaseTrainer, to_device
from sv3d_tpu_torch.training.optim import build_optimizer
from sv3d_tpu_torch.training.state import TrainState
from sv3d_tpu_torch.utils.profiling import span

#: the batch entries that go to the device
TENSORS = ("rgb", "depthmap_target", "points", "occupancies")


def scene_losses(config: Config, logits, occupancies, depth, depth_target, sigma, mesh=None,
                 supervised_from=None):
    """(train loss, metrics dict); the metric names are the JAX package's.

    mesh (a multi-GPU Mesh, or None): logits and occupancies are this rank's
    rows and slice of the query points, depth its rows.  The train loss is
    this rank's share (means over equal shares, so the world mean of the
    gradients is the global batch's); the metrics are the global batch's on
    every rank: ce and mse the means of the ranks' means, mesh_ce and
    point_iou ratios of all-reduced sums and counts.  supervised_from: the
    first query column of mesh_ce's supervision points (default
    config.subsample_points; a rank's slice starts elsewhere)."""
    ce = F.binary_cross_entropy_with_logits(logits, occupancies)
    mse = torch.mean((depth - depth_target) ** 2)
    loss = ce + mse
    s = config.subsample_points if supervised_from is None else supervised_from
    # binary point IoU at logit 0: 0 for any constant predictor, unlike CE
    # (the checkpoint monitor; see SceneNetTrainer)
    pred = logits > 0
    occ = occupancies > 0.5
    inter, union = (pred & occ).sum(), (pred | occ).sum()
    if mesh is None or mesh.size == 1:
        if config.subsample_points > 0:
            mesh_ce = F.binary_cross_entropy_with_logits(logits[:, s:], occupancies[:, s:])
        else:
            mesh_ce = ce
        point_iou = inter / union.clamp(min=1)
        ce_all, mse_all = ce.detach(), mse.detach()
    else:
        mesh_sum = F.binary_cross_entropy_with_logits(logits[:, s:], occupancies[:, s:],
                                                      reduction="sum")
        count = logits.new_tensor(occupancies[:, s:].numel())
        totals = mesh.sum_(torch.stack([t.detach().double() for t in (
            ce, mse, mesh_sum, count, inter, union)]))
        ce_all, mse_all = (totals[:2] / mesh.size).to(ce.dtype)
        mesh_ce = (totals[2] / totals[3]).to(ce.dtype) if config.subsample_points > 0 else ce_all
        point_iou = (totals[4] / totals[5].clamp(min=1)).float()
    sigma = sigma.detach()
    metrics = {
        "ce_loss": ce_all, "mse_depth_loss": mse_all, "mesh_ce_loss": mesh_ce,
        "point_iou": point_iou, "loss": ce_all + mse_all,
        "sigma_x": sigma[2], "sigma_y": sigma[1], "sigma_z": sigma[0],
    }
    return (ce if config.no_depth_sup else loss), metrics


def _prefixed(prefix: str, metrics: dict) -> dict:
    return {k if k.startswith("sigma") else f"{prefix}_{k}": v for k, v in metrics.items()}


def _microbatches(batch: dict, accum: int) -> list:
    """Split every per-sample entry of batch along its leading axis."""
    b = len(batch["points"])
    if b % accum:
        raise ValueError(f"batch of {b} does not split into {accum} microbatches")
    m = b // accum
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(accum)]


def scene_forward(model: SceneNet, config: Config, batch: dict, subsample_idx=None,
                  label_fn=None, mesh=None):
    """Forward + losses on one (micro)batch of device tensors.  label_fn(pc,
    batch) labels the projected subsample that this forward queried (when
    subsample_points > 0).  With a multi-GPU mesh, batch holds this rank's
    rows and the forward queries its sp slice of the query axis [cloud
    subsample; points], so label_fn sees only the cloud points in that
    slice.  Returns (loss, metrics, (logits, depth, pc, occupancies))."""
    occ = batch["occupancies"]
    n_cloud, point_slice, local_s = model.cloud_queries(batch["depthmap_target"]), None, None
    if mesh is not None and mesh.sp > 1:
        point_slice = mesh.point_slice(n_cloud + batch["points"].shape[1])
        occ = occ[:, max(point_slice.start - n_cloud, 0):point_slice.stop - n_cloud]
        # the slice's first column at or past config.subsample_points
        local_s = min(max(config.subsample_points - point_slice.start, 0),
                      point_slice.stop - point_slice.start)
    logits, depth, pc = model(batch["rgb"], batch["depthmap_target"], batch["points"],
                              subsample_idx, point_slice)
    if config.subsample_points > 0:
        labels = label_fn(pc.detach(), batch) if pc.shape[1] else occ[:, :0]
        occ = torch.cat([labels.to(occ), occ], dim=1)
    loss, metrics = scene_losses(config, logits, occ, depth, batch["depthmap_target"],
                                 model.project.sigma, mesh, local_s)
    return loss, metrics, (logits, depth, pc, occ)


def train_step(state: TrainState, batch: dict, config: Config, subsample_idx=None,
               label_fn=None, mesh=None) -> dict:
    """One optimizer step on a batch of device tensors, in place on state.

    With accum_steps > 1 the batch splits into that many microbatches run in
    sequence: their gradients are averaged and applied once, and BatchNorm's
    running statistics follow the microbatches in order (the JAX scan
    carries them the same way).  subsample_idx: one index array per
    microbatch, or None.  mesh: a multi-GPU Mesh (batch is this rank's
    rows; scene_forward): the gradients are averaged over its ranks once,
    after the last microbatch.  Each rank splits its own rows, so at dp > 1
    a microbatch (and its BatchNorm statistics) is every rank's k-th share,
    not the single process's k-th block of the batch.  Returns the
    microbatch-averaged train_* metrics."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    accum = max(int(config.accum_steps), 1)
    sums: dict = {}
    for i, mb in enumerate(_microbatches(batch, accum)):
        idx = None if subsample_idx is None else subsample_idx[i]
        with span("train.forward", device=True):
            loss, metrics, _ = scene_forward(model, config, mb, idx, label_fn, mesh)
        with span("train.backward", device=True):
            (loss / accum).backward()
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    with span("train.optimizer", device=True):
        if mesh is not None:
            mesh.mean_gradients(model.parameters())
        opt.step()
    state.step += 1
    return _prefixed("train", {k: v / accum for k, v in sums.items()})


class SceneNetTrainer(BaseTrainer):
    # Checkpoint ranking: binary point IoU, not the reference's val CE, which
    # a constant base-rate predictor minimizes early (as in the JAX package);
    # `--monitor val_ce_loss` restores the reference's choice.
    monitor = "val_point_iou"
    monitor_mode = "max"

    def __init__(self, config: Config, device="cuda", **kw):
        super().__init__(config, device=device, **kw)
        intr_path = Path(config.datasetdir) / "intrinsics.txt"
        if not intr_path.exists():
            raise FileNotFoundError(f"expected shared intrinsics at {intr_path}")
        self.intrinsics = read_intrinsics(intr_path)
        # the voxel grid follows config.dims; only the frustum's camera2frustum
        # matrix is used
        self.frustum = FrustumGrid.create(self.intrinsics, voxel_size=0.05 * config.scale_factor)

    def build_state(self) -> TrainState:
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed)
        model = SceneNet(cfg, self.intrinsics, self.frustum, device=self.device, generator=gen)
        state = TrainState(model, build_optimizer(cfg.lr, model))
        if cfg.pretrain_unet:
            from sv3d_tpu_torch.training.checkpoint import load_pretrained_unet

            state = load_pretrained_unet(state, cfg.pretrain_unet)
        return state

    def _flip_x_about(self):
        """Normed mirror constant A of flip augmentation: the grid-space
        mirror of camera X -> -X is x -> 2*camera2frustum[0,3] - x, which in
        normed space is p -> A - p with A = 2*c2f[0,3]/dims[0] - 1."""
        if not self.config.flip_aug:
            return None
        # reversing image columns mirrors camera X exactly only when the
        # principal point is the pixel-grid center, cx == (W-1)/2
        image_width = self.config.projection().image_size[0]
        if abs(2.0 * self.intrinsics.cx - (image_width - 1)) > 1e-6:
            raise ValueError(
                f"flip_aug requires cx == (W-1)/2 for an exact mirror; got "
                f"cx={self.intrinsics.cx} with W={image_width} "
                f"(2*cx - (W-1) = {2.0 * self.intrinsics.cx - (image_width - 1):.4f})"
            )
        return 2.0 * self.frustum.camera2frustum[0][3] / self.config.dims[0] - 1.0

    def _dataset(self, split, **kw):
        c = self.config
        return SceneNetDataset(split, c.datasetdir, c.num_points, c.splitsdir, c.resize_input,
                               c.W, seed=c.seed, **kw)

    def train_dataset(self):
        return self._dataset("train", flip_x_about=self._flip_x_about())

    def val_dataset(self):
        return self._dataset("val")

    def test_dataset(self):
        return self._dataset("test")

    def vis_datasets(self):
        """The train_vis / val_vis splits whose files exist."""
        from sv3d_tpu_torch.data.splits import split_path

        c = self.config
        return {
            split: self._dataset(split)
            for split in ("train_vis", "val_vis")
            if split_path(c.datasetdir, c.splitsdir, split).exists()
        }

    def label_cloud(self, pc: torch.Tensor, batch: dict) -> torch.Tensor:
        """Host labels (B, N) of a projected cloud against the batch's GT
        meshes.  Rows flagged `flipped` were projected in the mirrored scene
        and mirror back (p0 -> A - p0) before the query: occupancy is
        mirror-invariant, occ_mirrored(p) == occ(A - p).  Under a mesh the
        batch holds this rank's rows, their meshes and their flags."""
        with span("train.label_cloud"):
            pc_np = pc.detach().cpu().numpy()
            flipped = batch.get("flipped")
            if flipped is not None and (np.asarray(flipped) > 0.5).any():
                mask = np.asarray(flipped) > 0.5
                pc_np = pc_np.copy()
                pc_np[mask, :, 0] = self._flip_x_about() - pc_np[mask, :, 0]
            _, occ = determine_occupancy(batch["mesh"], pc_np, dims=self.config.dims)
            return torch.from_numpy(occ).to(pc.device)

    def _subsample(self, batch, generator, count: int):
        """count index arrays of config.subsample_points projected pixels, or
        None when the whole cloud (or none of it) is queried."""
        n_pixels = int(np.prod(np.shape(batch["depthmap_target"])[-2:]))
        if not 0 < self.config.subsample_points < n_pixels:
            return None
        return [torch.randperm(n_pixels, generator=generator)[: self.config.subsample_points]
                for _ in range(count)]

    def train_step(self, state, batch, generator):
        # every rank draws the same subsample from its copy of the seeded
        # generator, so each uses the indices of the single-process run
        with span("train.step"):
            idx = self._subsample(batch, generator, max(int(self.config.accum_steps), 1))
            return train_step(state, to_device(batch, self.device, TENSORS), self.config,
                              idx, self.label_cloud, self.mesh)

    def _eval_forward(self, state, batch, mesh=None):
        # a fixed subsample for every evaluation, as the JAX eval's PRNGKey(0)
        idx = self._subsample(batch, torch.Generator().manual_seed(0), 1)
        state.model.eval()
        with torch.no_grad():
            return scene_forward(state.model, self.config,
                                 to_device(batch, self.device, TENSORS),
                                 None if idx is None else idx[0], self.label_cloud, mesh)

    def eval_step(self, state, batch):
        _, metrics, _ = self._eval_forward(state, batch, self.mesh)
        return _prefixed("val", metrics)

    def visualize(self, state, batch, out_dir: Path):
        from sv3d_tpu_torch.utils.visualize import (
            visualize_depthmap,
            visualize_grid,
            visualize_point_list,
        )
        from sv3d_tpu_torch.geometry import unnorm_grid_space
        from sv3d_tpu_torch.inference.dense_grid import implicit_to_mesh

        # the whole batch on every rank: the sweeps are sharded over the
        # mesh (implicit_to_mesh), and rank 0 writes
        _, _, (_, depth, pc, _) = self._eval_forward(state, batch)
        model = state.model
        with torch.no_grad():
            vox = model.project(pc)
        pc_grid = unnorm_grid_space(pc, self.config.dims).cpu().numpy()
        for i, name in enumerate(batch["name"]):
            base = "_".join(str(name).split("/")[-3:])
            if self.is_main:
                visualize_point_list(pc_grid[i], out_dir / f"{base}_projected_pc.obj")
                visualize_grid(vox[i, ..., 0].cpu().numpy(), out_dir / f"{base}_voxelized.obj")
            implicit_to_mesh(model.ifnet, vox[i:i + 1], self.config.dims, 0.5,
                             out_dir / f"{base}_predicted.obj", res_increase=self.config.inf_res,
                             mesh=self.mesh)
            if self.is_main:
                visualize_depthmap(depth[i].cpu().numpy(), out_dir / f"{base}_depthmap",
                                   flip=True)

    def test(self, checkpoint: str, max_batches=None):
        """Load a checkpoint and run the test split with visualization dumps
        (the current config's inf_res / scale_factor / skip_unet apply).
        Under a mesh every rank takes whole batches (the visualization
        sweeps are sharded, and its metrics count each row as often as the
        other), and rank 0 writes."""
        from sv3d_tpu_torch.training.checkpoint import load_state_from_checkpoint

        state = self.distribute(load_state_from_checkpoint(self.build_state(), checkpoint))
        loader = self._loader(self.test_dataset(), shuffle=False, drop_last=False, sliced=False)
        out_dir = self.exp_dir / "test_vis"
        if self.is_main:
            out_dir.mkdir(parents=True, exist_ok=True)
        metrics: dict = {}
        n = 0
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            self.visualize(state, batch, out_dir)
            for k, v in self.eval_step(state, batch).items():
                metrics[k] = metrics.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in metrics.items()}


def train_scene_net(config: Config, device="cuda", max_steps=None):
    trainer = SceneNetTrainer(config, device=device)
    if config.test is not None:
        return trainer.test(config.test)
    return trainer.fit(max_steps=max_steps)


def cli_main(argv=None):
    from sv3d_tpu_torch.training.cli import parse_config

    config, device = parse_config(argv)
    train_scene_net(config, device)


if __name__ == "__main__":
    cli_main()
