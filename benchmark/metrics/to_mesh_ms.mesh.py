"""to_mesh_ms.mesh: the median milliseconds of a request's implicit_to_mesh
span (sv3d_tpu_torch/inference/dense_grid.py: IFNet.encode, the sweep K2,
the uint8 pull, marching cubes and the OBJ write).  Layer: encode, sweep
and meshing.  Moves mesh_s."""

import statistics


def read(ctx):
    times = ctx.spans.get("to_mesh")
    return statistics.median(times) * 1e3 if times else None
