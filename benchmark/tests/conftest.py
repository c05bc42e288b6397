"""The benchmark's own tests (CPU; a test that needs the card is marked
`cuda` and decides inside itself whether one exists):

    python -m pytest benchmark/tests -q
"""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


#: the image->mesh cells whose driver, traffic and limits stay under
#: benchmark/ without an entry in BENCHMARK.json (PERF.md, Open questions)
KEPT = {"workloads": [{"name": "sv3d128.mesh_r1", "config": "sv3d128", "traffic": "mesh_r1",
                       "chips": 1},
                      {"name": "sv3d32.mesh_r1", "config": "sv3d32", "traffic": "mesh_r1",
                       "chips": 1}],
        "configs": [{"name": "sv3d32", "file": "benchmark/configs/sv3d32.json"}]}


def with_kept() -> dict:
    """BENCHMARK.json with the kept image->mesh cells beside its own."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for k, extra in KEPT.items():
        bench[k] = bench[k] + extra
    return bench


def tiny_spec(cell: str, **traffic) -> dict:
    """A cell's spec at a size the CPU runs in seconds: the configuration's
    widths and depth, the grid at a quarter of the frustum's resolution, and
    a small traffic."""
    from benchmark import run as bench

    spec = copy.deepcopy(bench.load_spec(cell, with_kept()))
    spec["cfg"].update(dims=[35, 26, 28], voxel_size=0.2)
    spec["traffic"].update(traffic)
    return spec


@pytest.fixture
def tiny():
    return tiny_spec
