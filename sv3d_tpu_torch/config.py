"""Explicit configuration for the port (a copy of sv3d_tpu/config.py).

The reference funnels all configuration through a single argparse namespace that
is parsed at *module import time* (reference util/arguments.py:7-64, imported by
model/ifnet.py:8).  Here config is an explicit dataclass passed down the stack;
nothing global.  Field for field the JAX package's Config, with three changes:
``Config.dtype`` is a torch dtype, the JAX package's guard against
fused_query with net_res 32 at full scale (a compile limit of its TPU kernel)
is not carried over, and three fields come last that the JAX package lacks:
``decoder``, which puts Convolutional Occupancy Networks' grid decoder
(``"convonet_grid"``, models/convonet.py) or 3DShape2VecSet's transformer
autoencoder (``"vecset"``, models/vecset.py) in the place of Projection and
the IF-Net (``"ifnet"``, the default), and ``convonet`` and ``vecset``, those
decoders' sizes.
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Sequence


# Default frustum grid dimensions at voxel size 0.05 m, depth 0.4-6.0 m,
# 320x240 images (reference model/projection.py:156-157 and
# trainer/trainer_scene_net.py:30).
FULL_DIMS = (139, 104, 112)

# Per-dataset depth normalisation range (reference util/arguments.py:38-41).
DEFAULT_MIN_Z = 0.1953997164964676
DEFAULT_MAX_Z = 7.0


def _triple(v) -> tuple:
    if isinstance(v, (int, float)):
        return (v, v, v)
    t = tuple(v)
    if len(t) == 1:
        return t * 3
    assert len(t) == 3, f"expected scalar or 3-tuple, got {v!r}"
    return t


@dataclass(frozen=True)
class ProjectionConfig:
    """Depth back-projection + differentiable voxelization settings
    (reference model/projection.py:21-37)."""

    dims: tuple = FULL_DIMS
    kernel_size: tuple = (3, 3, 3)
    init_sigma: tuple = (1.5, 1.5, 1.5)
    depth_min: float = 0.4
    depth_max: float = 6.0
    voxel_size: float = 0.05
    image_size: tuple = (320, 240)  # (width, height)

    def __post_init__(self):
        object.__setattr__(self, "kernel_size", _triple(self.kernel_size))
        object.__setattr__(self, "init_sigma", _triple(self.init_sigma))


@dataclass(frozen=True)
class IFNetConfig:
    """IF-Net architecture (reference model/ifnet.py:10-61)."""

    net_res: int = 128          # 128 or 32 feature-pyramid variant
    hidden_dim: int = 256
    displacement: float = 0.0722  # 0.035 for the 32-res variant
    #: route training/eval queries through the point-query kernels
    #: (K4/K7/K8; f32 in the port); the default gather path is exact f32
    fused_query: bool = False

    @property
    def feature_channels(self) -> tuple:
        if self.net_res == 128:
            return (1, 16, 32, 64, 128, 128)
        if self.net_res == 32:
            return (1, 64, 128, 128)
        raise ValueError(f"net_res must be 128 or 32, got {self.net_res}")

    @property
    def align_corners(self) -> bool:
        # The 32-res variant samples with align_corners=True
        # (reference model/ifnet.py:98), the 128-res variant with the torch
        # default align_corners=False (reference model/ifnet.py:162).
        return self.net_res == 32

    @staticmethod
    def for_net_res(
        net_res: int, hidden_dim: int = 256, fused_query: bool = False
    ) -> "IFNetConfig":
        disp = 0.0722 if net_res == 128 else 0.035
        return IFNetConfig(
            net_res=net_res, hidden_dim=hidden_dim, displacement=disp,
            fused_query=fused_query,
        )


@dataclass(frozen=True)
class ConvONetConfig:
    """Convolutional Occupancy Networks' grid decoder (Peng et al., ECCV 2020;
    github.com/autonomousvision/convolutional_occupancy_networks,
    configs/pointcloud/room_grid64.yaml and the modules it names): a
    local-pool PointNet into a grid^3 feature volume, a 3D U-Net over it and
    a ResNet decoder of the sampled features.  The defaults are room_grid64's
    sizes; its widths, which nothing varies, are constants of
    models/convonet.py."""

    grid: int = 64                # cells a side of the feature volume
    unet_levels: int = 4
    unet_fmaps: int = 32          # the U-Net's first level; doubled a level

    @property
    def fmaps(self) -> tuple:
        return tuple(self.unet_fmaps * 2 ** i for i in range(self.unet_levels))


@dataclass(frozen=True)
class VecSetConfig:
    """3DShape2VecSet's occupancy autoencoder (Zhang et al., SIGGRAPH 2023;
    github.com/1zb/3DShape2VecSet models_ae.py, AutoEncoder): Fourier point
    embeddings, a one-head cross-attention from the latents to the input
    points, `depth` self-attention blocks of `heads` heads, and a one-head
    cross-attention from the query points to the latents.  The defaults are
    ae_d512_m512's; its widths that nothing varies (GEGLU's x4, 8 Fourier
    frequencies an axis, LayerNorm's eps) are constants of models/vecset.py.
    The inputs are a lattice of rows x cols pixels of the back-projected
    depth, the latents' seeds its even rows and columns."""

    dim: int = 512
    depth: int = 24
    heads: int = 8
    lattice: tuple = (32, 64)     # the input pixels' rows and columns

    @property
    def dim_head(self) -> int:
        return self.dim // self.heads

    @property
    def num_inputs(self) -> int:
        return self.lattice[0] * self.lattice[1]

    @property
    def num_latents(self) -> int:
        return -(-self.lattice[0] // 2) * -(-self.lattice[1] // 2)


#: the decoders SceneNet takes (Config.decoder)
DECODERS = ("ifnet", "convonet_grid", "vecset")


def decoder_of(config) -> str:
    """config.decoder, or "ifnet" for a configuration without the field (the
    JAX package's Config, which the port's models and trainers also take)."""
    return getattr(config, "decoder", "ifnet")


@dataclass(frozen=True)
class Config:
    """Full run configuration — one field per reference CLI flag
    (reference util/arguments.py:7-64)."""

    # data
    datasetdir: str = "data"
    splitsdir: str = "overfit"
    num_workers: int = 0
    num_points: int = 2048
    W: int = 256                      # square resize target when resize_input
    resize_input: bool = False
    #: horizontal-flip augmentation on the TRAIN split of the end-to-end
    #: dataset.  The reference only flips in UNet-only training (its
    #: scenes_dataset.py flips both input and target); here the flip extends
    #: to the full pipeline: rgb and depth are column-reversed and the query
    #: points are mirrored about the frustum's camera-x plane with the EXACT
    #: grid-space constant 2*camera2frustum[0,3] (cx = (W-1)/2 makes the
    #: pixel-grid mirror exact; the frustum box itself is one voxel row
    #: asymmetric, so the mirror plane is NOT the grid center).
    flip_aug: bool = False
    precision: int = 32               # 32 or 16 (bfloat16)

    # model
    net_res: int = 128
    inf_res: int = 1                  # inference resolution multiplier
    scale_factor: int = 1             # voxel grid downscale factor
    kernel_size: Sequence[int] = (3, 3, 3)
    sigma: Sequence[float] = (1.5,)
    min_z: float = DEFAULT_MIN_Z
    max_z: float = DEFAULT_MAX_Z
    skip_unet: bool = False
    no_depth_sup: bool = False
    subsample_points: int = 0
    fused_query: bool = False     # point-query kernels in training

    # training
    lr: float = 1e-4
    batch_size: int = 16
    #: >1 = gradient accumulation: the batch is split into this many
    #: microbatches scanned sequentially (grads averaged, one optimizer
    #: step) — full-scale f32 batches beyond HBM train unchanged.
    accum_steps: int = 1
    max_epoch: int = 100
    save_epoch: int = 1
    seed: int = -1
    sanity_steps: int = 2
    val_check_percent: float = 0.5
    val_check_interval: float = 0.25
    #: checkpoint-ranking metric override; "" keeps the trainer's default
    #: (scene trainer: val_ce_loss, matching the reference's ModelCheckpoint
    #: monitor, trainer_scene_net.py:217).  "val_point_iou" (monitor_mode
    #: "max") is the robust choice for generalization runs: val CE is
    #: minimized by a constant base-rate predictor early in training, which
    #: meshes to garbage — point IoU is 0 there.
    monitor: str = ""
    #: "min" | "max" | "" (trainer default) — ranking direction for `monitor`
    monitor_mode: str = ""
    resume: str | None = None
    pretrain_unet: str | None = None
    test: str | None = None

    # logging / experiment
    experiment: str = "scenes_net"
    version: str | None = None
    visualize: bool = False
    profiler: str | None = None

    # parallelism (new; the reference is single-device)
    dp: int = 1                       # data-parallel mesh size
    sp: int = 1                       # point-sharding mesh size

    # the decoder (new; the reference has the IF-Net only)
    decoder: str = "ifnet"
    convonet: ConvONetConfig = ConvONetConfig()
    vecset: VecSetConfig = VecSetConfig()

    def __post_init__(self):
        if self.decoder not in DECODERS:
            raise ValueError(f"decoder must be one of {DECODERS}, got {self.decoder!r}")
        object.__setattr__(self, "kernel_size", _triple(tuple(self.kernel_size)))
        object.__setattr__(self, "sigma", _triple(tuple(self.sigma)))
        if self.seed == -1:
            object.__setattr__(self, "seed", random.randint(0, 999))

    @property
    def dims(self) -> tuple:
        return tuple(int(round(d / self.scale_factor)) for d in FULL_DIMS)

    @property
    def dtype(self):
        import torch

        return torch.float32 if self.precision == 32 else torch.bfloat16

    def projection(self) -> ProjectionConfig:
        return ProjectionConfig(
            dims=self.dims,
            kernel_size=tuple(self.kernel_size),
            init_sigma=tuple(self.sigma),
            voxel_size=0.05 * self.scale_factor,
        )

    def ifnet(self) -> IFNetConfig:
        return IFNetConfig.for_net_res(self.net_res, fused_query=self.fused_query)

    def experiment_dir(self, timestamp: bool = True) -> Path:
        name = self.experiment
        if timestamp:
            name = f"{datetime.now().strftime('%d%m%H%M')}_{name}"
        return Path("runs") / name

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
