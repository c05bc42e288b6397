from sv3d_tpu_torch.geometry.camera import (
    Intrinsics,
    depth_to_camera,
    distance_to_depth,
    parse_intrinsics,
    read_intrinsics,
)
from sv3d_tpu_torch.geometry.frustum import (
    FrustumGrid,
    generate_frustum,
    generate_frustum_volume,
)
from sv3d_tpu_torch.geometry.transforms import (
    depthmap_to_gridspace,
    make_3d_grid,
    norm_grid_space,
    unnorm_grid_space,
)

__all__ = [
    "Intrinsics",
    "distance_to_depth",
    "depth_to_camera",
    "parse_intrinsics",
    "read_intrinsics",
    "FrustumGrid",
    "generate_frustum",
    "generate_frustum_volume",
    "depthmap_to_gridspace",
    "make_3d_grid",
    "norm_grid_space",
    "unnorm_grid_space",
]
