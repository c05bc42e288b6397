"""Scene reconstruction pipeline modules (port of the serving half of
sv3d_tpu/models/scene_net.py): RGB -> depth -> point cloud -> voxel
occupancy; the IF-Net encodes the occupancy and sweeps the lattice.  The
training forward (arbitrary-point queries) comes with the training slice."""

from __future__ import annotations

import torch
from torch import nn

from sv3d_tpu.config import Config
from sv3d_tpu_torch.geometry.camera import Intrinsics
from sv3d_tpu_torch.geometry.frustum import FrustumGrid
from sv3d_tpu_torch.geometry.transforms import depthmap_to_gridspace, norm_grid_space
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.models.projection import Projection
from sv3d_tpu_torch.models.unet import UNet, UNetMini, renormalize_depth, resize_crop_depth


class SceneNet(nn.Module):
    """unet (absent under config.skip_unet), project and ifnet, with weights
    drawn from generator and the module placed on device."""

    def __init__(self, config: Config, intrinsics: Intrinsics, frustum: FrustumGrid,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if config.precision != 32:
            raise NotImplementedError("sv3d_tpu_torch runs float32 only (precision=32)")
        self.config = config
        self.intrinsics = intrinsics
        self.frustum = frustum
        if not config.skip_unet:
            unet_cls = UNet if config.resize_input else UNetMini
            self.unet = unet_cls(channels_out=1, device=device, generator=generator)
        self.project = Projection(config.projection(), device=device)
        self.ifnet = IFNet(config.ifnet(), device=device, generator=generator)

    def predict_depth(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized RGB -> (B, 240, 320) renormalized depth."""
        cfg = self.config
        logits = self.unet(rgb).float()
        if cfg.resize_input:
            logits = resize_crop_depth(logits)
        return renormalize_depth(logits[..., 0], cfg.min_z, cfg.max_z)

    def project_depth(self, depthmap: torch.Tensor) -> torch.Tensor:
        """Depth map -> normed-grid-space point cloud.  The frustum gives the
        camera->grid transform, config.dims the normalization, as in the JAX
        package (the two dims differ at some scale factors)."""
        pc = depthmap_to_gridspace(depthmap, self.intrinsics, self.frustum)
        return norm_grid_space(pc, self.config.dims)
