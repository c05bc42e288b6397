"""Shared training loop (port of sv3d_tpu/training/loop.py): epochs,
validation cadence with PyTorch-Lightning-1.1 val_check_interval semantics,
sanity validation, metric logging at step 1 and every 10 steps, top-k + last
checkpoints ranked only at validation, resume, and --profiler.

Randomness is explicit: the subsample draws of the train steps come from one
torch.Generator seeded with config.seed (the JAX loop splits one PRNGKey),
model initialization from another; the data order and per-item draws are the
seeded numpy ones of the data layer (sv3d_tpu_torch.data).  The device is
the caller's.  With config.dp * config.sp > 1 (one process a device, under
torchrun or the explicit cluster flags; sv3d_tpu_torch/parallel) the loop
builds the (dp, sp) mesh: every rank builds the same seeded state and
takes rank 0's (distribute), loads its dp row's share of each batch, and
takes part in every collective (the gradient and metric all-reduces,
BatchNorm's statistics, the sharded sweeps of visualization); rank 0 alone
writes the experiment directory, checkpoints and logs, and every rank waits
at a barrier after each checkpoint save, so that a resume on any rank reads
a whole file.  TF32 is off in every trainer (cuDNN's and cuBLAS's TF32
defaults would break parity with the JAX package's f32 convs and
matmuls).  Precision 32 runs float32; precision 16 is the JAX package's
mixed precision, the UNet and IF-Net convs in bf16 on f32 parameters (each
trainer builds its model with config.dtype).
"""

from __future__ import annotations

import json
import random
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sv3d_tpu_torch.config import Config
from sv3d_tpu_torch.models.batchnorm import set_group
from sv3d_tpu_torch.parallel import (
    barrier,
    is_main_process,
    make_mesh,
    process_count,
    replicate_tree,
)
from sv3d_tpu_torch.training.checkpoint import CheckpointManager, load_state_from_checkpoint
from sv3d_tpu_torch.training.logging import MetricLogger
from sv3d_tpu_torch.utils import profiling

#: --profiler advanced traces the first this many train steps
TRACE_STEPS = 20
#: --profiler folds the spans into its summary every this many train steps,
#: so that a long run holds a bounded number of them
SUMMARY_STEPS = 1000


def to_device(batch: dict, device, keys) -> dict:
    """The batch with its entries named in keys as float32 tensors on
    device; the others (names, mesh paths, flags) stay on the host."""
    with profiling.span("train.to_device"):
        out = dict(batch)
        for k in keys:
            if k in batch:
                out[k] = torch.as_tensor(np.asarray(batch[k], np.float32), device=device)
        return out


class BaseTrainer:
    """Subclasses implement:
      build_state() -> TrainState
      train_step(state, batch, generator) -> metrics dict (updates state)
      eval_step(state, batch) -> metrics dict
      train_dataset() / val_dataset() -> dataset objects
      monitor / monitor_mode: validation metric ranking the checkpoints
      visualize(state, batch, out_dir) and vis_datasets(), optional
    """

    monitor = "val_loss"
    monitor_mode = "min"

    def __init__(self, config: Config, device="cuda", experiment_dir: Optional[Path] = None):
        self.config = config
        # the (dp, sp) mesh over the process group's ranks (ValueError unless
        # dp * sp is their count); None for a single process
        multi = config.dp * config.sp > 1 or process_count() > 1
        self.mesh = make_mesh(config.dp, config.sp) if multi else None
        self.is_main = is_main_process()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: CUDA is not available")
        if self.device.type == "cuda" and self.device.index is not None:
            # the kernels launch on the current device (a rank's cuda:<LOCAL_RANK>)
            torch.cuda.set_device(self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        random.seed(config.seed)
        np.random.seed(config.seed)
        self.generator = torch.Generator().manual_seed(config.seed)

        self.exp_dir = Path(experiment_dir) if experiment_dir else config.experiment_dir()
        if self.is_main:
            self.exp_dir.mkdir(parents=True, exist_ok=True)
        if config.monitor:
            self.monitor = config.monitor
            if not config.monitor_mode:
                # infer the direction from the name, so `--monitor val_ce_loss`
                # on a max-mode trainer cannot rank backwards
                self.monitor_mode = "max" if self.monitor.endswith("_iou") else "min"
        if config.monitor_mode:
            self.monitor_mode = config.monitor_mode
        self.ckpt = CheckpointManager(self.exp_dir / "checkpoints", mode=self.monitor_mode,
                                      monitor=self.monitor, primary=self.is_main)
        self.logger = MetricLogger(self.exp_dir / "logs", enabled=self.is_main)
        self.global_step = 0

    # -- subclass hooks ------------------------------------------------------
    def build_state(self):
        raise NotImplementedError

    def train_step(self, state, batch, generator):
        raise NotImplementedError

    def eval_step(self, state, batch):
        raise NotImplementedError

    def train_dataset(self):
        raise NotImplementedError

    def val_dataset(self):
        raise NotImplementedError

    def visualize(self, state, batch, out_dir: Path):
        pass

    def vis_datasets(self) -> dict:
        """name -> dataset pairs to visualize at validation time; an empty
        dict visualizes the first validation batch."""
        return {}

    # -- loop ----------------------------------------------------------------
    def distribute(self, state):
        """Under a mesh: every BatchNorm takes its statistics over this
        rank's sp column, and rank 0's parameters and buffers are broadcast
        (after a build or a restore).  Returns state."""
        if self.mesh is not None:
            set_group(state.model, self.mesh.column)
            replicate_tree(state.model, self.mesh)
        return state

    def _save(self, state, metric=None):
        """A checkpoint (rank 0 writes), then every rank waits for it."""
        self.ckpt.save(state, metric=metric)
        if self.mesh is not None:
            barrier()

    def _loader(self, dataset, shuffle: bool, drop_last: bool, sliced: bool = True):
        """Batches of dataset; under a mesh (sliced) this rank's dp row's
        contiguous share of each, which the sp ranks of the row share."""
        from sv3d_tpu_torch.data.loader import DataLoader

        mesh = self.mesh if sliced else None
        return DataLoader(dataset, batch_size=self.config.batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=self.config.num_workers,
                          seed=self.config.seed,
                          process_index=mesh.dp_index if mesh else 0,
                          process_count=mesh.dp if mesh else 1)

    def validate(self, state, loader, max_batches: Optional[int] = None, do_vis=False):
        """Mean of eval_step's metrics over the batches; under a mesh each
        eval_step returns the global batch's metrics (equal on every rank)."""
        agg: dict = {}
        count = 0
        first_batch = None
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            for k, v in self.eval_step(state, batch).items():
                agg[k] = agg.get(k, 0.0) + float(v)
            if i == 0:
                first_batch = batch
            count += 1
        if do_vis and self.config.visualize:
            self._visualize_pass(state, first_batch)
        return {k: v / max(count, 1) for k, v in agg.items()}

    def _visualize_pass(self, state, fallback_batch):
        """visualize() on the first batch of each vis dataset, else on the
        first validation batch.  Under a mesh every rank takes the whole
        batch (the sweeps are sharded over the mesh) and rank 0 writes."""
        vis_dir = self.exp_dir / "vis" / f"{self.global_step // 100:05d}"
        named = self.vis_datasets()
        if not named and self.mesh is not None and fallback_batch is not None:
            named = {"": self.val_dataset()}
        if named:
            for name, ds in named.items():
                batch = next(iter(self._loader(ds, shuffle=False, drop_last=False,
                                               sliced=False)), None)
                if batch is not None:
                    out = vis_dir / name
                    if self.is_main:
                        out.mkdir(parents=True, exist_ok=True)
                    self.visualize(state, batch, out)
        elif fallback_batch is not None:
            vis_dir.mkdir(parents=True, exist_ok=True)
            self.visualize(state, fallback_batch, vis_dir)

    def fit(self, max_steps: Optional[int] = None):
        cfg = self.config
        state = self.build_state()
        if cfg.resume:
            state = load_state_from_checkpoint(state, cfg.resume)
            self.global_step = int(state.step)
        self.distribute(state)

        train_loader = self._loader(self.train_dataset(), shuffle=True, drop_last=True)
        val_loader_fn = lambda: self._loader(self.val_dataset(), shuffle=False, drop_last=False)
        if len(train_loader) == 0:
            # the JAX package's loop runs max_epoch empty epochs and returns
            # the untrained state
            raise ValueError(f"the train split holds {len(train_loader.dataset)} samples, "
                             f"fewer than a batch of {cfg.batch_size} (the last short batch "
                             "is dropped): no step would run")

        steps_per_epoch = len(train_loader)
        # PL-1.1 val_check_interval: a float in (0, 1] is a fraction of the
        # training epoch, an integer > 1 means every N training batches
        if cfg.val_check_interval > 1:
            val_every_steps = int(cfg.val_check_interval)
        else:
            val_every_steps = max(int(steps_per_epoch * cfg.val_check_interval), 1)
        n_val = len(val_loader_fn())
        max_val_batches = max(int(n_val * cfg.val_check_percent), 1)

        if cfg.sanity_steps > 0:
            self.validate(state, val_loader_fn(), max_batches=cfg.sanity_steps)

        # --profiler (simple or advanced): tracing on for the run, its
        # per-span summary in <exp>/profile_simple.json; advanced also runs
        # torch.profiler over the first TRACE_STEPS steps, the trace with the
        # program's spans in <exp>/profile/trace.json
        traced = profiling.enabled() if cfg.profiler else None
        summ = None
        prof = None
        if traced is not None:
            traced.__enter__()
        if cfg.profiler == "advanced":
            prof = profiling.trace(self.exp_dir / "profile", cuda=self.device.type == "cuda",
                                   write=self.is_main)
            prof.__enter__()

        last_val = {}
        # windowed throughput, validation excluded
        log_t0 = time.time()
        log_step0 = self.global_step
        try:
            for epoch in range(cfg.max_epoch):
                for batch in train_loader:
                    metrics = self.train_step(state, batch, self.generator)
                    self.global_step += 1
                    if prof is not None and self.global_step >= TRACE_STEPS:
                        prof.__exit__(None, None, None)
                        prof = None
                    if traced is not None and self.global_step % SUMMARY_STEPS == 0:
                        summ = profiling.summary(profiling.records(), summ)
                        profiling.reset()
                    if self.global_step % 10 == 0 or self.global_step == 1:
                        metrics = {k: float(v) for k, v in metrics.items()}
                        metrics["steps_per_sec"] = (self.global_step - log_step0) / max(
                            time.time() - log_t0, 1e-9)
                        self.logger.log(metrics, self.global_step)
                        log_t0 = time.time()
                        log_step0 = self.global_step
                    if self.global_step % val_every_steps == 0:
                        last_val = self.validate(state, val_loader_fn(),
                                                 max_batches=max_val_batches, do_vis=True)
                        self.logger.log(last_val, self.global_step)
                        # rank a checkpoint only here, where the monitor is fresh
                        self._save(state, metric=last_val.get(self.monitor))
                        log_t0 = time.time()
                        log_step0 = self.global_step
                    if max_steps is not None and self.global_step >= max_steps:
                        self._save(state)
                        return state
                if (epoch + 1) % max(cfg.save_epoch, 1) == 0:
                    self._save(state)
            self._save(state)
            return state
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            if traced is not None:
                traced.__exit__(None, None, None)
                if self.is_main:
                    summ = profiling.summary(profiling.records(), summ)
                    (self.exp_dir / "profile_simple.json").write_text(json.dumps(summ, indent=2))
