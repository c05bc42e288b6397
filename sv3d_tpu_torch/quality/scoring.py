"""What the quality runs share: a scene's voxel grid from a trained SceneNet
(predicted or ground-truth depth), the mesh of its occupancy field, and the
reference's score of that mesh against the ground-truth mesh."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sv3d_tpu_torch.evaluation.metrics import eval_mesh
from sv3d_tpu_torch.io.mesh import load_obj

#: a score of a mesh that could not be made or sampled (the field never
#: crosses the level): the worst IoU and normals, no Chamfer distance
FAILED = {"iou": 0.0, "chamfer_l2": None, "normals": 0.0}


def device_name(device) -> str:
    """The card's name for a CUDA device (as torch reports it), else the
    device's own name: results name the hardware they ran on."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def predicted_depth(model, rgb: np.ndarray) -> np.ndarray:
    """(240, 320) depth that model's UNet (eval mode) predicts from one
    normalized (H, W, 3) RGB array."""
    device = model.project.sigma.device
    model.eval()
    with torch.inference_mode():
        img = torch.as_tensor(np.asarray(rgb, np.float32), device=device)[None]
        return model.predict_depth(img)[0].cpu().numpy()


def depth_voxels(model, depth: np.ndarray) -> torch.Tensor:
    """(1, *dims, 1) voxel occupancy of one (240, 320) depth map, on the
    model's device: back-projection and the learned-sigma voxelization, as
    training builds it."""
    device = model.project.sigma.device
    with torch.inference_mode():
        d = torch.as_tensor(np.asarray(depth, np.float32), device=device)[None]
        return model.project(model.project_depth(d))


def normalized(path: str | Path, dims):
    """The OBJ at path, moved from grid coordinates of dims into the unit
    cube [-0.5, 0.5]^3 (the reference's convert_to_scaled_obj)."""
    dims = np.asarray(dims, dtype=np.float64)
    return load_obj(path).apply_translation(-dims / 2).apply_scale(1.0 / dims)


def score(pred_path: str | Path, gt_mesh: str | Path, dims, eval_points: int) -> dict:
    """The reference's metrics of one mesh pair, both OBJs in grid
    coordinates of dims and normalized into the unit cube: {"iou",
    "chamfer_l2", "normals"} (rounded as the results JSON keeps them)."""
    m = eval_mesh(normalized(pred_path, dims), normalized(gt_mesh, dims), -0.5, 0.5,
                  n_points=eval_points)
    return {"iou": round(float(m["iou"]), 4), "chamfer_l2": round(float(m["chamfer_l2"]), 6),
            "normals": round(float(m["normals"]), 4)}


def mesh_and_score(model, vox, dims, pred_path: Path, gt_mesh: str | Path,
                   eval_points: int) -> dict:
    """Mesh model.ifnet's field on vox at level 0.5 into pred_path (the dense
    sweep, K2 bf16 on the card) and score it against gt_mesh: score()'s
    dict, or FAILED with the reason under "failed" when the mesh is empty
    or cannot be scored."""
    from sv3d_tpu_torch.inference.dense_grid import implicit_to_mesh

    model.eval()
    try:
        implicit_to_mesh(model.ifnet, vox, dims, 0.5, pred_path)
        return score(pred_path, gt_mesh, dims, eval_points)
    except (ValueError, RuntimeError) as e:
        return {**FAILED, "failed": str(e)[:120]}
