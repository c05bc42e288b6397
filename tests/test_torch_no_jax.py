"""sv3d_tpu_torch imports, serves, evaluates arbitrary points and trains on
the CPU with sv3d_tpu, jax, jaxlib and flax blocked; no source of the port
or chip_smoke.py imports them; and chip_smoke.py refuses to run without
CUDA."""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FORBIDDEN = ("sv3d_tpu", "jax", "jaxlib", "flax")  # top-level names, matched exactly

BLOCK = textwrap.dedent(f"""
    import sys

    FORBIDDEN = {FORBIDDEN!r}

    class _Blocked:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(f"{{name}} is blocked")
            return None

    def loaded_forbidden():
        return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)

    sys.meta_path.insert(0, _Blocked())
""")

SLICE = BLOCK + textwrap.dedent("""
    import importlib, json
    import numpy as np
    import torch
    torch.set_num_threads(1)
    modules = [
        "sv3d_tpu_torch", "sv3d_tpu_torch.convert", "sv3d_tpu_torch.geometry",
        "sv3d_tpu_torch.ops.voxelize", "sv3d_tpu_torch.ops.grid_sample",
        "sv3d_tpu_torch.ops.lattice", "sv3d_tpu_torch.ops.cuda.build",
        "sv3d_tpu_torch.ops.cuda.voxelize", "sv3d_tpu_torch.ops.cuda.sweep",
        "sv3d_tpu_torch.models", "sv3d_tpu_torch.models.convonet", "sv3d_tpu_torch.models.wgrad",
        "sv3d_tpu_torch.models.vecset",
        "sv3d_tpu_torch.ops.cell_pool", "sv3d_tpu_torch.inference.dense_grid",
        "sv3d_tpu_torch.inference.predict", "sv3d_tpu_torch.ops.point_query",
        "sv3d_tpu_torch.ops.cuda.point_query", "sv3d_tpu_torch.models.batchnorm",
        "sv3d_tpu_torch.data.datasets", "sv3d_tpu_torch.preprocessing.occupancies",
        "sv3d_tpu_torch.preprocessing.waterproofing", "sv3d_tpu_torch.training.cli",
        "sv3d_tpu_torch.training.logging", "sv3d_tpu_torch.training.optim",
        "sv3d_tpu_torch.training.state", "sv3d_tpu_torch.training.checkpoint",
        "sv3d_tpu_torch.training.loop", "sv3d_tpu_torch.training.trainer_scene_net",
        "sv3d_tpu_torch.config", "sv3d_tpu_torch.io.exr", "sv3d_tpu_torch.io.mesh",
        "sv3d_tpu_torch.io.image", "sv3d_tpu_torch.io.volume", "sv3d_tpu_torch.native",
        "sv3d_tpu_torch.utils.visualize", "sv3d_tpu_torch.utils.profiling",
        "sv3d_tpu_torch.data.loader", "sv3d_tpu_torch.data.splits", "sv3d_tpu_torch.ops.mlp", "sv3d_tpu_torch.ops.cuda.mlp",
        "sv3d_tpu_torch.preprocessing", "sv3d_tpu_torch.preprocessing.process_sample",
        "sv3d_tpu_torch.preprocessing.create_split", "sv3d_tpu_torch.preprocessing.copy_data",
        "sv3d_tpu_torch.preprocessing.scaled_obj", "sv3d_tpu_torch.evaluation",
        "sv3d_tpu_torch.evaluation.metrics", "sv3d_tpu_torch.training.trainer_ifnet",
        "sv3d_tpu_torch.training.trainer_unet", "sv3d_tpu_torch.models.mixed",
        "sv3d_tpu_torch.quality", "sv3d_tpu_torch.quality.synthetic_scenes",
        "sv3d_tpu_torch.quality.box_scene",
        "sv3d_tpu_torch.quality.scoring", "sv3d_tpu_torch.quality.overfit",
        "sv3d_tpu_torch.quality.multiscene", "sv3d_tpu_torch.quality.diagnose",
        "sv3d_tpu_torch.quality.compare_precision", "sv3d_tpu_torch.parallel",
        "sv3d_tpu_torch.parallel.mesh", "sv3d_tpu_torch.parallel.multihost",
        "sv3d_tpu_torch.bench", "sv3d_tpu_torch.bench.timing", "sv3d_tpu_torch.bench.headline",
        "sv3d_tpu_torch.bench.measure_step", "sv3d_tpu_torch.quality.scaling",
        "sv3d_tpu_torch.io", "sv3d_tpu_torch.ops", "sv3d_tpu_torch.data",
        "sv3d_tpu_torch.inference", "sv3d_tpu_torch.training", "sv3d_tpu_torch.utils",
    ]
    for m in modules:
        importlib.import_module(m)
    from sv3d_tpu_torch.config import IFNetConfig
    from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid, evaluate_points
    from sv3d_tpu_torch.models.ifnet import IFNet

    model = IFNet(IFNetConfig.for_net_res(128), generator=torch.Generator().manual_seed(0)).eval()
    grid = torch.tensor(np.random.default_rng(0).uniform(0, 1, (1, 9, 7, 8, 1)), dtype=torch.float32)
    values = evaluate_on_grid(model, grid, (9, 7, 8))
    pts = np.random.default_rng(1).uniform(-0.5, 0.5, (100, 3))
    routes = [evaluate_points(model, grid, pts, 64, use_kernel=True, bands=b, compute_dtype=dt)
              for dt in (torch.float32, torch.bfloat16) for b in (None, 4)]
    print(json.dumps({
        "shape": list(values.shape), "finite": bool(np.isfinite(values).all()),
        "points": [list(r.shape) for r in routes],
        "agree": bool(np.abs(routes[0] - routes[1]).max() <= 1e-5)
                 and bool(np.abs(routes[2] - routes[3]).max() <= 1e-3),
        "loaded": loaded_forbidden(),
    }))
""")


TRAIN = BLOCK + textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset

    root = write_smoke_dataset(sys.argv[1], scale_factor=8, n_points=500)
    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    cfg = Config(seed=0, scale_factor=8, batch_size=1, num_points=16, subsample_points=32,
                 fused_query=True, datasetdir=str(root), sanity_steps=0, experiment="t")
    state = SceneNetTrainer(cfg, device="cpu", experiment_dir=sys.argv[2]).fit(max_steps=1)
    rec = json.loads(open(sys.argv[2] + "/logs/metrics.jsonl").readline())
    print(json.dumps({
        "step": state.step, "finite": bool(np.isfinite(rec["train_loss"])),
        "loaded": loaded_forbidden(),
    }))
""")


def _run(code_or_args, cwd, env=None):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=240,
        env=env,
    )


def test_port_imports_and_serves_without_jax():
    proc = _run(SLICE, ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"shape": [9, 7, 8], "finite": True, "points": [[100]] * 4,
                   "agree": True, "loaded": []}


def test_port_trains_one_step_without_jax(tmp_path):
    proc = _run(["-c", TRAIN, str(tmp_path / "data"), str(tmp_path / "exp")], ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"step": 1, "finite": True, "loaded": []}


def test_no_source_of_the_port_imports_the_jax_package():
    """Every import statement of every .py under sv3d_tpu_torch/ and of
    chip_smoke.py, at any depth, names none of sv3d_tpu, jax, jaxlib,
    flax."""
    sources = sorted((ROOT / "sv3d_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 40
    # the quality tooling's ports of the JAX package's scripts are scanned
    # too, and the box scene of the tests and the card smoke
    assert {p.name for p in sources if p.parent.name == "quality"} >= {
        "synthetic_scenes.py", "scoring.py", "overfit.py", "multiscene.py", "diagnose.py",
        "compare_precision.py", "box_scene.py"}
    # and the ports of bench.py and scripts/measure_step.py
    assert {p.name for p in sources if p.parent.name == "bench"} >= {
        "__main__.py", "headline.py", "measure_step.py", "timing.py"}
    offenders = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                          if n.split(".")[0] in FORBIDDEN]
    assert not offenders, offenders


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(BLOCK + "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')",
                ROOT, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
