"""Host file formats of the port: EXR, RGB images, OBJ meshes, .df and
semantics volumes (copies of sv3d_tpu/io)."""

from sv3d_tpu_torch.io.exr import read_exr, read_exr_channel, write_exr
from sv3d_tpu_torch.io.image import load_rgb, normalize_rgb, square_pad_resize
from sv3d_tpu_torch.io.mesh import TriMesh, load_obj, save_obj
from sv3d_tpu_torch.io.volume import down_sample, read_df, read_semantics, write_df

__all__ = [
    "read_exr",
    "read_exr_channel",
    "write_exr",
    "load_rgb",
    "normalize_rgb",
    "square_pad_resize",
    "TriMesh",
    "load_obj",
    "save_obj",
    "read_df",
    "read_semantics",
    "down_sample",
    "write_df",
]
