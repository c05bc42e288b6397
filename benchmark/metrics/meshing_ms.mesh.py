"""meshing_ms.mesh: the median milliseconds of the port's
utils/visualize.py::visualize_sdf_u8 inside implicit_to_mesh (the native
marching cubes on the uint8 field and the OBJ write, on the host).  Layer:
meshing.  Moves mesh_s."""

import statistics


def read(ctx):
    times = ctx.spans.get("meshing")
    return statistics.median(times) * 1e3 if times else None
