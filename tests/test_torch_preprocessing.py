"""The port's offline preprocessing (sv3d_tpu_torch.preprocessing) against
the JAX package's, on copies of one synthetic raw tree
(box_scene.write_raw_tree: the box scene with its distance field, and a
view whose far wall lies past the frustum): depth_grid_from_distance,
sample_points, process_sample, the pipeline with its quarantine (serial
and over two worker processes), create_split, copy_data and scaled_obj.
Both run the same numpy and native code on the same draws, so every array
and file must be equal, and the same samples quarantined."""

import importlib
import shutil

import numpy as np
import pytest

from sv3d_tpu.preprocessing import copy_data as jcopy
from sv3d_tpu.preprocessing import create_split as jsplit
from sv3d_tpu.preprocessing import scaled_obj as jscaled
from sv3d_tpu.preprocessing.occupancies import sample_points as j_sample_points
from sv3d_tpu_torch.preprocessing import copy_data, create_split, scaled_obj
from sv3d_tpu_torch.preprocessing.occupancies import sample_points
from sv3d_tpu_torch.quality import box_scene

# the packages' __init__ export a function named process_sample
process_sample = importlib.import_module("sv3d_tpu_torch.preprocessing.process_sample")
jps = importlib.import_module("sv3d_tpu.preprocessing.process_sample")

NUM_SAMPLES = 3000


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    return box_scene.write_raw_tree(tmp_path_factory.mktemp("raw"))


def _copy(tree, dst):
    shutil.copytree(tree, dst, symlinks=True)
    return dst


def _tree_files(root):
    """{relative path: bytes} of every file under root."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_same_tree(got, want):
    """Equal file lists; npz archives equal array by array, others byte for
    byte."""
    a, b = _tree_files(got), _tree_files(want)
    assert a.keys() == b.keys()
    for name in a:
        if name.endswith(".npz"):
            with np.load(got / name) as x, np.load(want / name) as y:
                assert x.files == y.files, name
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name}:{k}")
        else:
            assert a[name] == b[name], name


@pytest.mark.parametrize("scale_factor", [1, 2])
def test_depth_grid_from_distance_matches_jax(raw_tree, scale_factor):
    view = raw_tree / "raw" / "overfit" / "00000" / "00"
    intr = raw_tree / "intrinsics.txt"
    got = process_sample.depth_grid_from_distance(view / "distance.exr", intr, scale_factor)
    want = jps.depth_grid_from_distance(view / "distance.exr", intr, scale_factor)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert tuple(got[2]) == tuple(want[2]) == tuple(got[1].shape)
    assert got[1].sum() > 1000
    far = raw_tree / "raw" / "overfit" / "00000" / "01" / "distance.exr"
    for fn in (process_sample.depth_grid_from_distance, jps.depth_grid_from_distance):
        with pytest.raises(IndexError):
            fn(far, intr, scale_factor)


def test_sample_points_matches_jax(raw_tree, tmp_path):
    from sv3d_tpu_torch.io.mesh import save_obj

    mesh = tmp_path / "box.obj"
    save_obj(mesh, box_scene.box_vertices(2), box_scene.BOX_FACES)
    dims = (70, 52, 56)
    got = sample_points(mesh, dims, 1000, 0.01, rng=np.random.default_rng(3))
    want = j_sample_points(mesh, dims, 1000, 0.01, rng=np.random.default_rng(3))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (1100, 3) and 0 < got[1].mean() < 1


def test_process_sample_matches_jax(raw_tree, tmp_path):
    trees = {who: _copy(raw_tree, tmp_path / who) for who in ("port", "jax")}
    for who, fn in (("port", process_sample.process_sample), ("jax", jps.process_sample)):
        out = fn(trees[who], "overfit", "00000/00", 2, NUM_SAMPLES, seed=4)
        assert out == trees[who] / "processed" / "overfit" / "00000" / "00"
    _assert_same_tree(trees["port"], trees["jax"])
    with np.load(trees["port"] / "processed/overfit/00000/00/depth_grid.npz") as z:
        assert z["grid"].shape == (70, 52, 56)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_pipeline_quarantines_and_matches_jax(raw_tree, tmp_path, num_workers):
    """The CLI's call: raw tree under <datasetdir>/raw, outputs under
    processed/<split>; the far view moves under quarantine/.  The port over
    num_workers processes writes what the JAX pipeline writes serially."""
    trees = {who: _copy(raw_tree, tmp_path / who) for who in ("port", "jax")}
    results = {}
    for who, fn in (("port", process_sample.process_sample_pipeline),
                    ("jax", jps.process_sample_pipeline)):
        root = trees[who]
        workers = num_workers if who == "port" else 0
        done, bad = fn(root / "raw", "overfit", 8, NUM_SAMPLES, 1,
                       processed_root=root / "processed" / "overfit", num_workers=workers)
        results[who] = ([str(x).replace(str(root), "") for x in done],
                        [str(x).replace(str(root), "") for x in bad])
    assert results["port"] == results["jax"] == (["/raw/overfit/00000/00"],
                                                 ["/raw/overfit/00000/01"])
    _assert_same_tree(trees["port"], trees["jax"])
    port = trees["port"]
    assert (port / "raw/quarantine/overfit/00000/01/distance.exr").exists()
    assert not (port / "raw/overfit/00000/01").exists()
    assert not (port / "processed/overfit/00000/01").exists()
    assert sorted(p.name for p in (port / "processed/overfit/00000/00").iterdir()) == [
        "depth_grid.npz", "occupancy_0.01.npz", "occupancy_0.10.npz", "target.df"]
    # skip_existing leaves a complete sample as it is
    stamp = (port / "processed/overfit/00000/00/depth_grid.npz").stat().st_mtime_ns
    done, bad = process_sample.process_sample_pipeline(
        port / "raw", "overfit", 8, NUM_SAMPLES, 1, processed_root=port / "processed" / "overfit",
        skip_existing=True)
    assert len(done) == 1 and not bad
    assert (port / "processed/overfit/00000/00/depth_grid.npz").stat().st_mtime_ns == stamp


def test_pipeline_cli(raw_tree, tmp_path):
    root = _copy(raw_tree, tmp_path / "t")
    done, bad = process_sample.cli_main(["--datasetdir", str(root), "--splitsdir", "overfit",
                                         "--scale_factor", "8", "--num_samples", "500"])
    assert len(done) == 1 and len(bad) == 1
    assert (root / "processed/overfit/00000/00/target.df").exists()


def test_create_split_matches_jax(raw_tree, tmp_path):
    for who, mod in (("port", create_split), ("jax", jsplit)):
        mod.create_split_from_count(tmp_path / who, "count", 23)
        got = mod.create_split_from_tree(tmp_path / who, raw_tree / "raw" / "overfit", "tree",
                                         0.5, 0.5, seed=3)
        assert sorted(got) == ["00000/00", "00000/01"]
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    create_split.cli_main(["--datasetdir", str(tmp_path / "cli"), "--splitsdir", "c",
                           "--n_samples", "10"])
    assert (tmp_path / "cli/splits/c/train.txt").read_text().count("\n") == 8


def test_copy_data_matches_jax(raw_tree, tmp_path):
    src = tmp_path / "renders"
    for scene, view, files in (("a", "0", copy_data.VIEW_FILES), ("a", "1", ("rgb.png",)),
                               ("b", "0", copy_data.VIEW_FILES)):
        d = src / scene / view
        d.mkdir(parents=True)
        for f in files:
            (d / f).write_bytes(f"{scene}/{view}/{f}".encode())
    got = copy_data.copy_data(src, tmp_path / "port", "s")
    want = jcopy.copy_data(src, tmp_path / "jax", "s")
    assert [x.replace("port", "jax") for x in got] == want and len(got) == 2
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_scaled_obj_matches_jax(raw_tree, tmp_path):
    from sv3d_tpu_torch.io.mesh import save_obj

    for who in ("port", "jax"):
        for name in ("x/a_predicted.obj", "b_predicted.obj", "c_gt.obj"):
            (tmp_path / who / name).parent.mkdir(parents=True, exist_ok=True)
            save_obj(tmp_path / who / name, box_scene.box_vertices(1), box_scene.BOX_FACES)
    got = scaled_obj.convert_tree(tmp_path / "port")
    want = jscaled.convert_tree(tmp_path / "jax")
    assert [p.name for p in got] == [p.name for p in want] == ["b_predicted_normed.obj",
                                                              "a_predicted_normed.obj"]
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    outs = scaled_obj.cli_main(["--root", str(tmp_path / "port"), "--pattern", "*_gt.obj"])
    assert [p.name for p in outs] == ["c_gt_normed.obj"]
