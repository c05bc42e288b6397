"""The port's mesh evaluation (sv3d_tpu_torch.evaluation.metrics) against
the JAX package's, on seeded unit-space meshes: box_scene's box, the
box shifted along x, the box shrunk about its centre.  Both run the same
native code on the same numpy draws: floats at 1e-6 relative, IoU exactly.
And the analytic case chip_smoke checks on the card: a box against itself
shifted by half its width has volumetric IoU 1/3."""

import json

import numpy as np
import pytest

from sv3d_tpu.evaluation import metrics as jmetrics
from sv3d_tpu.io.mesh import TriMesh as JTriMesh
from sv3d_tpu_torch.evaluation import metrics
from sv3d_tpu_torch.io.mesh import TriMesh, save_obj
from sv3d_tpu_torch.quality import box_scene

RTOL = 1e-6
N_POINTS = 2000


def _box(shift=(0.0, 0.0, 0.0), scale=1.0):
    """The smoke scene's box in unit space (translate -dims/2, scale
    1/dims), shifted and scaled about its centre: (vertices, faces)."""
    dims = np.array([139.0, 104.0, 112.0])
    v = (box_scene.box_vertices(1) - dims / 2) / dims
    c = v.mean(axis=0)
    return (v - c) * scale + c + np.asarray(shift), box_scene.BOX_FACES


MESHES = {"box": _box(), "shifted": _box(shift=(0.05, 0.0, 0.0)), "shrunk": _box(scale=0.7)}
PAIRS = [("box", "box"), ("box", "shifted"), ("shrunk", "box")]


def _both(name):
    v, f = MESHES[name]
    return TriMesh(v.copy(), f.copy()), JTriMesh(v.copy(), f.copy())


def _assert_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "iou" or np.isnan(v):
            assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)


def test_distance_p2p_and_eval_pointcloud_match_jax():
    rng = np.random.default_rng(0)
    src, tgt = rng.uniform(-0.5, 0.5, (500, 3)), rng.uniform(-0.5, 0.5, (700, 3))
    ns, nt = rng.normal(size=(500, 3)), rng.normal(size=(700, 3))
    for args in ((src, tgt), (src, tgt, ns, nt)):
        got, want = metrics.distance_p2p(*args), jmetrics.distance_p2p(*args)
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            np.testing.assert_allclose(got[1], want[1], rtol=RTOL)
        _assert_metrics(metrics.eval_pointcloud(*args), jmetrics.eval_pointcloud(*args))


@pytest.mark.parametrize("pred,gt", PAIRS)
def test_eval_mesh_and_volumetric_iou_match_jax(pred, gt):
    (p, jp), (g, jg) = _both(pred), _both(gt)
    iou = metrics.volumetric_iou(p, g, -0.5, 0.5, 20000, np.random.default_rng(1))
    assert iou == jmetrics.volumetric_iou(jp, jg, -0.5, 0.5, 20000, np.random.default_rng(1))
    got = metrics.eval_mesh(p, g, n_points=N_POINTS)
    _assert_metrics(got, jmetrics.eval_mesh(jp, jg, n_points=N_POINTS))
    if pred == gt:
        assert got["iou"] == 1.0 and got["chamfer_l2"] < 1e-4
    else:
        assert 0.0 < got["iou"] < 1.0


def test_evaluate_mesh_lists_and_cli_match_jax(tmp_path, monkeypatch):
    paths = {}
    for name, (v, f) in MESHES.items():
        paths[name] = tmp_path / f"{name}.obj"
        save_obj(paths[name], v, f)
    pf = tmp_path / "path_files"
    pf.mkdir()
    (pf / "pred.txt").write_text("".join(f"{paths[p]}\n" for p, _ in PAIRS))
    (pf / "gt.txt").write_text("".join(f"{paths[g]}\n" for _, g in PAIRS))
    preds = [str(paths[p]) for p, _ in PAIRS]
    gts = [str(paths[g]) for _, g in PAIRS]
    got = metrics.evaluate_mesh_lists(preds, gts, N_POINTS)
    want = jmetrics.evaluate_mesh_lists(preds, gts, N_POINTS)
    assert metrics.METRIC_KEYS == jmetrics.METRIC_KEYS
    _assert_metrics(got["mean"], want["mean"])
    for k in metrics.METRIC_KEYS:
        for a, b in zip(got["raw"][k], want["raw"][k]):
            _assert_metrics({k: a}, {k: b})

    argv = ["--path_files", str(pf), "--experiment", "pred.txt", "--gt", "gt.txt",
            "--n_points", str(N_POINTS)]
    files = {}
    for who, cli in (("port", metrics.cli_main), ("jax", jmetrics.cli_main)):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        cli(argv)
        files[who] = (tmp_path / who / "results" / "exp_pred.txt").read_text().split("\n")
    head = lambda lines: [ln.rsplit(": ", 1) for ln in lines[1:len(metrics.METRIC_KEYS) + 1]]
    assert files["port"][0] == files["jax"][0] == f"{len(PAIRS)} meshes"
    _assert_metrics({k: float(v) for k, v in head(files["port"])},
                    {k: float(v) for k, v in head(files["jax"])})
    raw = [json.loads(lines[-1]) for lines in (files["port"], files["jax"])]
    for k in metrics.METRIC_KEYS:
        for a, b in zip(raw[0][k], raw[1][k]):
            _assert_metrics({k: a}, {k: b})


def test_half_width_shift_has_iou_one_third():
    """A box and the same box shifted by half its width along x overlap in
    half of each: IoU (1/2) / (3/2) = 1/3, up to the sampling error."""
    v, f = box_scene.iou_box_pair()
    got = metrics.volumetric_iou(TriMesh(v[0], f), TriMesh(v[1], f), -0.5, 0.5, 200000)
    assert abs(got - 1.0 / 3.0) <= 0.01
