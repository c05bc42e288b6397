from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.models.projection import Projection
from sv3d_tpu_torch.models.scene_net import SceneNet
from sv3d_tpu_torch.models.unet import UNet, UNetMini

__all__ = ["IFNet", "Projection", "SceneNet", "UNet", "UNetMini"]
