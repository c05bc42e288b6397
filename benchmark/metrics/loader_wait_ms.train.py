"""loader_wait_ms.train: the median milliseconds a step waits for its batch
(next() of sv3d_tpu_torch/data/loader.py's DataLoader over
data/datasets.py's SceneNetDataset; the batch's copy to the device,
training/loop.py::to_device, runs inside the step).  Layer: data.  Moves
train_samples_per_s."""

import statistics


def read(ctx):
    times = ctx.spans.get("loader_wait")
    return statistics.median(times) * 1e3 if times else None
