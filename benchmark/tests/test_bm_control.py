"""The control, the reference put in the program's place in the next
precision down (TF32 for the float32 layers, fp8 for the bf16 sweep), comes
out not correct under each cell's limits, at a size a test run holds."""

import pytest
import torch

from benchmark import run as bench

SEED = 2**31 + 99


@pytest.mark.parametrize("cell,control,traffic", [
    ("sv3d128.mesh_r1", "serve", dict(pool=2, sample=2, warmup=1)),
    ("sv3d32.mesh_r1", "serve", dict(pool=2, sample=2, warmup=1)),
    ("sv3d128.train_b4", "train", dict(scenes=8, samples=300, batch_size=2, num_points=32,
                                       warmup=4)),
])
def test_control_is_not_correct(tiny, cell, control, traffic):
    spec = tiny(cell, **traffic)
    result, numbers, limits, _ = bench.run_cell(spec, SEED, 0.1, False, torch.device("cpu"),
                                                control)
    assert not result["correct"], (numbers, limits)
