"""predict_ms.mesh: the median milliseconds of a request's predict span
(sv3d_tpu_torch/inference/predict.py::predict: UNetMini depth,
back-projection, K1's scatter and the blur; the span ends in predict's own
.cpu() of the depth).  Layer: depth and voxelization.  Moves mesh_s."""

import statistics


def read(ctx):
    times = ctx.spans.get("predict")
    return statistics.median(times) * 1e3 if times else None
