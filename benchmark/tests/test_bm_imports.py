"""No run loads JAX or the JAX package, compared by whole top-level names
(the port's name, sv3d_tpu_torch, begins with the JAX package's), and the
plain reference imports nothing of the port, nor do the architectures'
files that it reaches outside the functions that build the port's model."""

import ast
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "sv3d_tpu"}


def _imports(path, top_level_only=False):
    tree = ast.parse(path.read_text())
    for node in tree.body if top_level_only else ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if path.parent.name == "reference":
        assert "sv3d_tpu_torch" not in tops, path
    if path.parent.name == "arch":
        assert "sv3d_tpu_torch" not in {m.split(".")[0] for m in _imports(path, True)}, path


def test_whole_name_comparison(monkeypatch):
    from benchmark import run as bench

    monkeypatch.setitem(sys.modules, "sv3d_tpu_torch_fake", object())
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sv3d_tpu.models", object())
    assert bench.forbidden_modules() == ["sv3d_tpu"]


BLOCKED_RUN = textwrap.dedent("""
    import sys
    FORBIDDEN = {forbidden!r}

    class _Blocked:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(name + " is blocked")
            return None

    sys.meta_path.insert(0, _Blocked())
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(2)
    from conftest import tiny_spec
    from benchmark import run as bench
    spec = tiny_spec("sv3d128.train_b4", scenes=6, samples=200, batch_size=2, num_points=32)
    result, numbers, _, _ = bench.run_cell(spec, 3, 0.1, False, torch.device("cpu"))
    assert result["attempted"] >= 1 and result["failed"] == 0, result
    assert bench.forbidden_modules() == [], bench.forbidden_modules()
    print("ok")
""")


def test_a_run_loads_no_jax():
    code = BLOCKED_RUN.format(forbidden=FORBIDDEN, root=str(ROOT), tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_run_without_a_card_prints_no_result(tmp_path):
    """On a machine without CUDA the command fails and prints nothing on
    standard output."""
    code = ("import torch, sys; sys.exit(0 if torch.cuda.is_available() else 1)")
    if subprocess.run([sys.executable, "-c", code]).returncode == 0:
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "sv3d128.train_b4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


REFERENCE_ALONE = textwrap.dedent("""
    import sys
    FORBIDDEN = {forbidden!r}

    class _Blocked:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(name + " is blocked")
            return None

    sys.meta_path.insert(0, _Blocked())
    sys.path.insert(0, {root!r})
    import torch
    torch.set_num_threads(2)
    from benchmark.reference import train
    sd, cfg, batch, cam = torch.load({state!r}, weights_only=False)
    out = train.run(sd, cfg, [batch], cam, "cpu")
    assert out["losses"][0] > 0 and out["change_norms"], out
    assert [m for m in sys.modules if m.split(".")[0] in FORBIDDEN] == []
    print("ok")
""")


def test_the_reference_trains_without_the_port(tiny, tmp_path):
    """The reference's training step, through the architecture's occupancy
    forward, in a process that cannot import the port (the state dict made
    beside it, with the port's names and shapes)."""
    import numpy as np
    import torch

    from benchmark.arch.scene_ifnet import port_config
    from benchmark.frozen import scenes
    from benchmark.frozen.weights import seeded_state_dict
    from benchmark.reference import scene, train
    from sv3d_tpu_torch.geometry.camera import parse_intrinsics
    from sv3d_tpu_torch.geometry.frustum import FrustumGrid
    from sv3d_tpu_torch.models.scene_net import SceneNet

    cfg = tiny("sv3d128.train_b4")["cfg"]
    intr = parse_intrinsics(scenes.INTRINSICS_TEXT)
    model = SceneNet(port_config(cfg, num_points=16, batch_size=2, seed=1), intr,
                     FrustumGrid.create(intr, voxel_size=cfg["voxel_size"]))
    sd = seeded_state_dict(model.state_dict(), cfg["sigma"], 5, "cpu")
    scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
    rooms = scenes.write_train_tree(5, 2, tmp_path / "data", "s", scale, shift, cfg["dims"], 100)
    batch = train.batch_at(rooms, 5, 2, 16, scenes.FOCAL, 0)
    cam = (scenes.FOCAL, scenes.CX, scenes.CY, np.asarray(scale), np.asarray(shift))
    torch.save((sd, cfg, batch, cam), tmp_path / "state.pt")
    code = REFERENCE_ALONE.format(forbidden=FORBIDDEN | {"sv3d_tpu_torch"}, root=str(ROOT),
                                  state=str(tmp_path / "state.pt"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
