"""A configuration of a second architecture comes in by new files only: its
benchmark/arch/<arch>.py, its configuration, traffic, limits and per-layer
metric, and new entries in BENCHMARK.json.  The toy architecture under
tests/toy/ (no conv pyramid, no decoder of IF-Net's widths, no scaled leaf,
and no model in the port) is laid into a copy of the benchmark, where the
contract's tests pass for it by its own rule and the reference trains it
into numbers without sigma_change_gap, in a process that cannot import the
port."""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

from conftest import ROOT

BENCH = ROOT / "benchmark"
TOY = BENCH / "tests" / "toy"
#: the contract's tests that each take the toy's configuration or cell
TOY_CASES = ("test_config_files[toy]", "test_every_cell_reports_enough[toy.train_b2]",
             "test_harness_finds_cell_pieces[toy.train_b2]",
             "test_limits_name_what_the_cell_compares[toy.train_b2]",
             "test_names_use_allowed_characters[toy.train_b2]",
             "test_metric_entries[toy_steps.train]")

SCRIPT = textwrap.dedent("""
    import json
    import sys
    import types

    FORBIDDEN = {"jax", "jaxlib", "flax", "sv3d_tpu", "sv3d_tpu_torch"}

    class _Blocked:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(name + " is blocked")
            return None

    sys.meta_path.insert(0, _Blocked())
    tree = sys.argv[1]
    sys.path.insert(0, tree)
    import pytest

    rc = pytest.main(["-q", "-rA", "-p", "no:cacheprovider",
                      tree + "/benchmark/tests/test_bm_contract.py"])

    import numpy as np
    import torch

    torch.set_num_threads(2)
    from benchmark import arch
    from benchmark import run as bench
    from benchmark.frozen.weights import seeded_state_dict
    from benchmark.reference import compare, train

    spec = bench.load_spec("toy.train_b2")
    cfg = spec["cfg"]
    toy = arch.load(cfg["arch"])
    # UNetMini's leaves at 2 filters, then the toy's MLP
    nf, shapes = 2, {}
    for i, (ci, co) in enumerate(zip([3, nf, 2 * nf, 4 * nf], [nf, 2 * nf, 4 * nf, 8 * nf])):
        shapes[f"unet.down.{i}.weight"], shapes[f"unet.down.{i}.bias"] = (co, ci, 4, 4), (co,)
    for i, (ci, co) in enumerate([(8 * nf, 4 * nf), (8 * nf, 2 * nf), (4 * nf, nf), (2 * nf, 1)]):
        shapes[f"unet.same.{i}.weight"], shapes[f"unet.same.{i}.bias"] = (co, ci, 3, 3), (co,)
    for i, c in enumerate([2 * nf, 4 * nf, 4 * nf, 2 * nf, nf]):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"unet.bn.{i}.{leaf}"] = (c,)
    mlp = cfg["mlp"]
    for i in range(cfg["layers"]):
        shapes[f"toy.fc{i}.weight"], shapes[f"toy.fc{i}.bias"] = (mlp[i + 1], mlp[i]), (mlp[i + 1],)
    sd = seeded_state_dict({k: torch.zeros(s) for k, s in shapes.items()}, cfg.get("sigma"), 3,
                           "cpu")
    w, h = cfg["image_size"]
    rng = np.random.default_rng(3)
    f32 = lambda a: a.astype(np.float32)
    hb = {"rgb": f32(rng.uniform(-1, 1, (2, h, w, 3))), "depth": f32(rng.uniform(0.5, 3, (2, h, w))),
          "points": f32(rng.uniform(-0.5, 0.5, (2, 16, 3))),
          "occupancies": f32(rng.uniform(0, 1, (2, 16)) > 0.5)}
    cam = (20.0, w / 2 - 0.5, h / 2 - 0.5, np.full(3, 2.0, np.float32),
           np.array([4.0, 3.0, 0.0], np.float32))
    ref = train.run(sd, cfg, [hb] * 3, cam, "cpu")
    ctl = train.run(sd, cfg, [hb] * 3, cam, "cpu", rows=slice(0, 1))
    step = train.step_from(sd, {}, cfg, hb, cam, "cpu")
    numbers = compare.train_numbers(ctl, ref, [(step, step)], toy.SCALED_LEAF)
    driver = bench.driver_class(spec["traffic"]["kind"])
    run = types.SimpleNamespace(traffic=spec["traffic"], arch=toy, cfg=cfg,
                                device=torch.device("cpu"))
    try:
        driver(run).numbers("sigma_lr")
        sigma_lr = None
    except ValueError as e:
        sigma_lr = str(e)
    print(json.dumps({"pytest": int(rc), "numbers": numbers, "limits": sorted(spec["limits"]),
                      "compared": sorted(driver.compared(toy)), "sigma_lr": sigma_lr,
                      "leaves_moved": sorted(k for k, v in ref["change_norms"].items() if v > 0),
                      "forbidden": sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)}))
""")


def _checkout(tmp_path):
    """A copy of the benchmark with the toy's files added and its entries in
    BENCHMARK.json; no file of the copy is changed but BENCHMARK.json."""
    tree = tmp_path / "checkout"
    shutil.copytree(BENCH, tree / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for src in sorted(TOY.rglob("*")):
        if src.is_file() and src.parent != TOY:
            dst = tree / "benchmark" / src.relative_to(TOY)
            assert not dst.exists(), dst
            shutil.copy(src, dst)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = json.loads((TOY / "entries.json").read_text())
    for k in ("configs", "workloads", "per_layer"):
        bench[k] += entries[k]
    for m in bench["end_to_end"]:
        if m["name"] in entries["end_to_end_workloads"]:
            m["workloads"] += entries["end_to_end_workloads"][m["name"]]
    (tree / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tree


def test_a_second_architecture_by_new_files_only(tmp_path):
    tree = _checkout(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tree)], capture_output=True,
                         text=True, timeout=600, cwd=tree, env=env)
    assert out.returncode == 0, out.stderr[-3000:] + out.stdout[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["pytest"] == 0, out.stdout[-4000:]
    passed = {m.group(1) for m in re.finditer(r"^PASSED \S*::(\S+)", out.stdout, re.M)}
    assert set(TOY_CASES) <= passed, sorted(set(TOY_CASES) - passed)
    # the toy's numbers are the five that every architecture has, no more
    assert sorted(res["numbers"]) == res["limits"] == res["compared"]
    assert "sigma_change_gap" not in res["numbers"]
    assert res["numbers"]["loss_gap"] > 0  # half of each batch: the numbers see it
    assert any(k.startswith("toy.") for k in res["leaves_moved"])
    assert res["sigma_lr"] and "sigma_lr" in res["sigma_lr"]
    assert res["forbidden"] == []


def _toy_arch():
    spec = importlib.util.spec_from_file_location("toy_cloud", TOY / "arch" / "toy_cloud.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_what_a_training_cell_compares_follows_its_architecture():
    """sigma_change_gap is compared where the architecture scales a leaf, and
    nowhere else, so no cell of a model without sigma carries its limit."""
    from benchmark import arch
    from benchmark.drivers.train import Driver

    assert "sigma_change_gap" in Driver.compared(arch.load("scene_ifnet"))
    assert "sigma_change_gap" not in Driver.compared(_toy_arch())
