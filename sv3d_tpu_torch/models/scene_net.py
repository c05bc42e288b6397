"""End-to-end scene reconstruction pipeline (port of
sv3d_tpu/models/scene_net.py): RGB -> depth -> point cloud -> voxel
occupancy -> IF-Net occupancy logits at query points (forward, training),
or the dense lattice (serving, through predict_depth / project_depth /
project and ifnet.query_lattice).  Under Config(decoder="convonet_grid") the
point cloud goes to Convolutional Occupancy Networks' grid decoder
(models/convonet.py), under Config(decoder="vecset") to 3DShape2VecSet's
transformer autoencoder (models/vecset.py), in the place of project and
ifnet, in training only, at precision 32.

config.precision 16 is the JAX package's mixed precision: the UNet and the
IF-Net conv stages compute in bf16 (config.dtype) on f32 parameters, so a
checkpoint has one layout at either precision; Projection (back-projection,
scatter, smoothing) stays f32, and the depth logits widen to f32 before the
resize and the sigmoid."""

from __future__ import annotations

import torch
from torch import nn

from sv3d_tpu_torch.config import Config, decoder_of
from sv3d_tpu_torch.geometry.camera import Intrinsics
from sv3d_tpu_torch.geometry.frustum import FrustumGrid
from sv3d_tpu_torch.geometry.transforms import depthmap_to_gridspace, norm_grid_space
from sv3d_tpu_torch.models.convonet import ConvONet
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.models.mixed import widen
from sv3d_tpu_torch.models.projection import Projection
from sv3d_tpu_torch.models.unet import UNet, UNetMini, renormalize_depth, resize_crop_depth
from sv3d_tpu_torch.models.vecset import VecSet


class SceneNet(nn.Module):
    """unet (absent under config.skip_unet), project and ifnet (or, under
    config.decoder "convonet_grid", convonet; under "vecset", vecset), with
    weights drawn from generator and the module placed on device; the unet
    and ifnet compute in bf16 at config.precision 16."""

    def __init__(self, config: Config, intrinsics: Intrinsics, frustum: FrustumGrid,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        dt = None if config.precision == 32 else config.dtype
        self.config = config
        self.intrinsics = intrinsics
        self.frustum = frustum
        if not config.skip_unet:
            unet_cls = UNet if config.resize_input else UNetMini
            self.unet = unet_cls(channels_out=1, device=device, generator=generator, dtype=dt)
        self.decoder = decoder_of(config)
        if self.decoder == "ifnet":
            self.project = Projection(config.projection(), device=device)
            self.ifnet = IFNet(config.ifnet(), device=device, generator=generator, dtype=dt)
            return
        if config.precision != 32:
            raise ValueError(f"decoder {self.decoder!r} trains at precision 32 only, "
                             f"got {config.precision}")
        if self.decoder == "convonet_grid":
            self.convonet = ConvONet(config.convonet, device=device, generator=generator)
        else:
            self.vecset = VecSet(config.vecset, device=device, generator=generator)

    @property
    def sigma(self):
        """The projection's learnable sigma, or None where the decoder takes
        the point cloud itself (convonet_grid, vecset)."""
        return self.project.sigma if self.decoder == "ifnet" else None

    def predict_depth(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized RGB -> (B, 240, 320) renormalized depth
        (f32 at precision 16: the bf16 logits widen first)."""
        cfg = self.config
        logits = widen(self.unet(rgb))
        if cfg.resize_input:
            logits = resize_crop_depth(logits)
        return renormalize_depth(logits[..., 0], cfg.min_z, cfg.max_z)

    def forward(self, rgb, depth_target, points, subsample_idx=None, point_slice=None):
        """(logits (B, N_q), depthmap (B, 240, 320), point_cloud_out).

        rgb: (B, H, W, 3) normalized (unused under skip_unet, which projects
        depth_target instead); points: (B, N, 3) supervision points.  With
        0 < subsample_points < H*W the query set is the projected cloud at
        subsample_idx (a (subsample_points,) index array the caller draws,
        e.g. from a torch.Generator) followed by points, and point_cloud_out is
        that subsample; with subsample_points == 0 only points are queried;
        above H*W the whole cloud is.  point_slice (a multi-GPU mesh rank's
        share, Mesh.point_slice) cuts the query set to that slice of its
        points, and point_cloud_out to the cloud points inside it; the
        pyramid is computed whole.  BatchNorm follows the module's mode.
        Under decoder "convonet_grid" the whole cloud is ConvONet's input in
        the place of the voxel grid, under "vecset" its lattice of pixels."""
        cfg = self.config
        depthmap = depth_target if cfg.skip_unet else self.predict_depth(rgb)
        point_cloud = self.project_depth(depthmap)
        voxel_occupancy = self.project(point_cloud) if self.decoder == "ifnet" else None

        n_cloud = self.cloud_queries(depthmap)
        if 0 < n_cloud < point_cloud.shape[1]:
            if subsample_idx is None:
                raise ValueError("subsample_points > 0 requires subsample_idx")
            queried = point_cloud[:, subsample_idx.to(point_cloud.device), :]
        else:
            queried = point_cloud[:, :n_cloud]
        query_points = torch.cat([queried, points], dim=1) if n_cloud else points
        if point_slice is not None:
            query_points = query_points[:, point_slice]
            queried = queried[:, point_slice.start:max(min(point_slice.stop, n_cloud),
                                                      point_slice.start)]
        if self.decoder == "ifnet":
            logits = self.ifnet(voxel_occupancy, query_points)
        elif self.decoder == "convonet_grid":
            logits = self.convonet(point_cloud, query_points)
        else:
            logits = self.vecset(point_cloud, query_points, depthmap.shape[-2:])
        return logits, depthmap, queried if n_cloud else point_cloud

    def cloud_queries(self, depthmap: torch.Tensor) -> int:
        """How many projected-cloud points lead the query set for a depth
        map of this shape: subsample_points, 0, or the whole cloud above
        H*W."""
        n_pixels = depthmap.shape[-2] * depthmap.shape[-1]
        s = self.config.subsample_points
        return s if 0 <= s < n_pixels else n_pixels

    def project_depth(self, depthmap: torch.Tensor) -> torch.Tensor:
        """Depth map -> normed-grid-space point cloud.  The frustum gives the
        camera->grid transform, config.dims the normalization, as in the JAX
        package (the two dims differ at some scale factors)."""
        pc = depthmap_to_gridspace(depthmap, self.intrinsics, self.frustum)
        return norm_grid_space(pc, self.config.dims)
