"""Mesh reconstruction metrics: completeness, accuracy, Chamfer-L2, normal
consistency and volumetric IoU (port of sv3d_tpu/evaluation/metrics.py;
host code on the port's native KD-tree, OBJ reader and waterproofing).

    python -m sv3d_tpu_torch.evaluation.metrics --path_files results/path_files \
        --experiment predicted.txt --gt normed_gt.txt

The CLI reads two lists of OBJ paths (<path_files>/<experiment> and
<path_files>/<gt>, one path a line, pairs in order), scores each pair in the
unit-space bounding box [-0.5, 0.5]^3 and writes results/exp_<experiment>
(relative to the working directory): the pair count, the mean of each
metric, then the per-pair values as JSON.  Volumetric IoU labels 10 x
n_points uniform samples of that box by waterproofing on both meshes.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from sv3d_tpu_torch.io.mesh import TriMesh, load_obj
from sv3d_tpu_torch.native import KDTree
from sv3d_tpu_torch.preprocessing.waterproofing import implicit_waterproofing


def distance_p2p(points_src, points_tgt, normals_src=None, normals_tgt=None):
    """Distance of each src point to its nearest tgt point, and |cos| of the
    angle between their normals (None without normals)."""
    kdtree = KDTree(np.asarray(points_tgt, dtype=np.float32))
    dist, idx = kdtree.query(np.asarray(points_src, dtype=np.float32))
    if normals_src is None or normals_tgt is None:
        return dist, None
    ns = normals_src / np.linalg.norm(normals_src, axis=-1, keepdims=True)
    nt = normals_tgt / np.linalg.norm(normals_tgt, axis=-1, keepdims=True)
    dot = np.abs((nt[idx] * ns).sum(axis=-1))
    return dist, dot


def eval_pointcloud(pc_pred, pc_gt, normals_pred=None, normals_gt=None) -> dict:
    completeness, completeness_normals = distance_p2p(pc_gt, pc_pred, normals_gt, normals_pred)
    accuracy, accuracy_normals = distance_p2p(pc_pred, pc_gt, normals_pred, normals_gt)

    completeness2 = float((completeness**2).mean())
    accuracy2 = float((accuracy**2).mean())
    out = {
        "completeness": float(completeness.mean()),
        "accuracy": float(accuracy.mean()),
        "completeness2": completeness2,
        "accuracy2": accuracy2,
        "chamfer_l2": 0.5 * completeness2 + 0.5 * accuracy2,
        "iou": float("nan"),
    }
    if normals_pred is not None:
        cn = float(completeness_normals.mean())
        an = float(accuracy_normals.mean())
        out.update({"normals completeness": cn, "normals accuracy": an,
                    "normals": 0.5 * cn + 0.5 * an})
    else:
        out.update({"normals completeness": float("nan"), "normals accuracy": float("nan"),
                    "normals": float("nan")})
    return out


def volumetric_iou(
    mesh_pred: TriMesh, mesh_gt: TriMesh, bb_min: float, bb_max: float,
    n_samples: int, rng=None,
) -> float:
    """IoU of the two meshes' insides over n_samples uniform points of the
    box [bb_min, bb_max]^3; nan when neither holds a sample."""
    rng = np.random.default_rng(0) if rng is None else rng
    samples = rng.random((n_samples, 3)) * (bb_max - bb_min) + bb_min
    occ_pred = implicit_waterproofing(mesh_pred, samples)[0]
    occ_gt = implicit_waterproofing(mesh_gt, samples)[0]
    union = (occ_pred | occ_gt).sum()
    inter = (occ_pred & occ_gt).sum()
    return float(inter) / float(union) if union > 0 else float("nan")


def eval_mesh(
    mesh_pred: TriMesh,
    mesh_gt: TriMesh,
    bb_min: float = -0.5,
    bb_max: float = 0.5,
    n_points: int = 100000,
    rng=None,
) -> dict:
    """The metrics of one pair: n_points surface samples of each mesh for
    the distances and normals, 10 x n_points box samples for the IoU, all
    drawn from rng (np.random.default_rng(0) when None)."""
    rng = np.random.default_rng(0) if rng is None else rng
    pc_pred, idx_p = mesh_pred.sample(n_points, return_index=True, rng=rng)
    pc_gt, idx_g = mesh_gt.sample(n_points, return_index=True, rng=rng)
    out = eval_pointcloud(
        pc_pred.astype(np.float32), pc_gt.astype(np.float32),
        mesh_pred.face_normals[idx_p], mesh_gt.face_normals[idx_g],
    )
    out["iou"] = volumetric_iou(mesh_pred, mesh_gt, bb_min, bb_max, n_points * 10, rng)
    return out


METRIC_KEYS = [
    "completeness", "accuracy", "normals completeness", "normals accuracy",
    "normals", "completeness2", "accuracy2", "chamfer_l2", "iou",
]


def evaluate_mesh_lists(paths_pred, paths_gt, n_points=100000, verbose=False) -> dict:
    """Per-pair metrics and their means: {"mean": {key: mean}, "raw": {key:
    [value a pair]}}."""
    performance = {k: [] for k in METRIC_KEYS}
    for i, (pp, pg) in enumerate(zip(paths_pred, paths_gt)):
        if verbose:
            print(f"evaluating {i + 1}/{len(paths_pred)}: {pp} vs {pg}")
        out = eval_mesh(load_obj(pp), load_obj(pg), -0.5, 0.5, n_points)
        for k in METRIC_KEYS:
            performance[k].append(out[k])
    means = {k: float(np.mean(v)) for k, v in performance.items()}
    return {"mean": means, "raw": performance}


def cli_main(argv=None):
    p = argparse.ArgumentParser(description="batch mesh evaluation")
    p.add_argument("--path_files", type=str, default="results/path_files")
    p.add_argument("--experiment", type=str, required=True)
    p.add_argument("--gt", type=str, default="normed_gt.txt")
    p.add_argument("--n_points", type=int, default=100000)
    p.add_argument("--verbose", action="store_true")
    a = p.parse_args(argv)

    pf = Path(a.path_files)
    preds = (pf / a.experiment).read_text().splitlines()
    gts = (pf / a.gt).read_text().splitlines()
    results = evaluate_mesh_lists(preds, gts, a.n_points, a.verbose)

    out = Path("results") / f"exp_{a.experiment}"
    out.parent.mkdir(exist_ok=True)
    with open(out, "w") as f:
        n = len(results["raw"]["completeness"])
        f.write(f"{n} meshes\n")
        for k, v in results["mean"].items():
            f.write(f"mean {k}: {v}\n")
        f.write("\n")
        f.write(json.dumps(results["raw"]))
    print(json.dumps(results["mean"], indent=2))
    return results


if __name__ == "__main__":
    cli_main()
