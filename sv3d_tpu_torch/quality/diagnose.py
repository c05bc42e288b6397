"""Per-scene failure diagnosis of a held-out quality run (port of
scripts/diagnose_scenes.py).

Held-out IoU varies widely from scene to scene, and a few near-zero scenes
pull the mean down.  The end-to-end pipeline's first suspect is the UNet's
depth on room geometries it never saw; this tool isolates it per test scene
of a quality.multiscene tree:

  * predicted-vs-GT depth error (mean absolute, relative, 95th percentile):
    a scene whose depth is wrong cannot reconstruct;
  * containment of the back-projected cloud (the share of pixels whose
    points land inside the frustum grid): an out-of-frustum cloud voxelizes
    to nothing;
  * with --full, the dense sweep and mesh from both predicted and GT depth,
    each scored against the GT mesh, which splits the IoU loss into a depth
    part and an IF-Net part.

Writes <exp>/diagnosis/{scene}_depth.png (GT | predicted | abs error) and a
summary to stdout and <exp>/diagnosis/summary.json.

    python -m sv3d_tpu_torch.quality.diagnose --exp runs/scaling_96 \\
        --root .synth_quality [--ckpt runs/scaling_96/checkpoints/step_XXXX] [--full]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="per-scene diagnosis of a quality run")
    p.add_argument("--exp", required=True)
    p.add_argument("--root", default=".synth_quality")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint (default: the manifest's best, else last)")
    p.add_argument("--net_res", type=int, default=128)
    p.add_argument("--scale_factor", type=int, default=1)
    p.add_argument("--precision", type=int, default=32,
                   help="32: float32; 16: bf16 mixed precision")
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--eval_points", type=int, default=50000)
    p.add_argument("--full", action="store_true",
                   help="also mesh from predicted and from GT depth and score both "
                   "(dense sweeps)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails if absent)")
    return p


def checkpoint_of(exp: Path, ckpt: str | None) -> Path:
    """ckpt, else the manifest's best checkpoint of exp, else its last."""
    if ckpt:
        return Path(ckpt)
    ckpt_dir = exp / "checkpoints"
    manifest = ckpt_dir / "manifest.json"
    if manifest.exists():
        scores = json.loads(manifest.read_text())["scores"]
        if scores:
            return Path(scores[0][1])
    return ckpt_dir / "last"


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import torch
    from PIL import Image

    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.inference.predict import resolve_device
    from sv3d_tpu_torch.quality.scoring import depth_voxels, mesh_and_score, predicted_depth
    from sv3d_tpu_torch.training.checkpoint import load_state_from_checkpoint
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    exp = Path(args.exp)
    cfg = Config(datasetdir=args.root, splitsdir="synth", skip_unet=False,
                 num_points=args.num_points, batch_size=1, seed=0, sanity_steps=0,
                 net_res=args.net_res, scale_factor=args.scale_factor,
                 precision=args.precision, experiment="diagnose")
    trainer = SceneNetTrainer(cfg, device=resolve_device(args.device),
                              experiment_dir=exp / "diagnosis_tmp")
    ckpt = checkpoint_of(exp, args.ckpt)
    print(f"diagnosing checkpoint {ckpt}", flush=True)
    model = load_state_from_checkpoint(trainer.build_state(), ckpt).model.eval()

    out_dir = exp / "diagnosis"
    out_dir.mkdir(parents=True, exist_ok=True)
    test_ds = trainer.test_dataset()

    def cloud_inside(depth) -> float:
        """Share of the pixels whose point lands in normed grid space
        [-0.5, 0.5]^3."""
        with torch.inference_mode():
            d = torch.as_tensor(np.asarray(depth, np.float32), device=trainer.device)[None]
            pc = model.project_depth(d)[0].cpu().numpy()
        return float(np.mean(np.all(np.abs(pc) <= 0.5 + 1e-6, axis=-1)))

    rows = []
    for i in range(len(test_ds)):
        sample = test_ds[i]
        name = sample["name"].replace("/", "_")
        gt = np.asarray(sample["depthmap_target"])  # (H, W)
        pred = predicted_depth(model, sample["rgb"])
        err = np.abs(pred - gt)
        row = {
            "name": sample["name"],
            "depth_mae": round(float(err.mean()), 4),
            "depth_mae_rel": round(float((err / np.maximum(gt, 0.1)).mean()), 4),
            "depth_p95_err": round(float(np.percentile(err, 95)), 4),
            "gt_depth_range": [round(float(gt.min()), 3), round(float(gt.max()), 3)],
            "cloud_in_frustum_pred": round(cloud_inside(pred), 4),
            "cloud_in_frustum_gt": round(cloud_inside(gt), 4),
        }

        # side-by-side depth panel: GT | predicted | abs error
        lo, hi = gt.min(), max(gt.max(), pred.max())
        span = max(hi - lo, 1e-6)
        norm = lambda d: ((np.clip(d, lo, hi) - lo) / span * 255).astype(np.uint8)
        panel = np.concatenate(
            [norm(gt), norm(pred), (np.clip(err / span, 0, 1) * 255).astype(np.uint8)], axis=1)
        Image.fromarray(panel).save(out_dir / f"{name}_depth.png")

        if args.full:
            for tag, depth in (("pred", pred), ("gtdepth", gt)):
                m = mesh_and_score(model, depth_voxels(model, depth), cfg.dims,
                                   out_dir / f"{name}_{tag}.obj", sample["mesh"],
                                   args.eval_points)
                row[f"iou_{tag}"] = m["iou"]
                if "failed" in m:
                    row[f"iou_{tag}_error"] = m["failed"][:100]
        rows.append(row)
        print(json.dumps(row), flush=True)

    summary = {
        "checkpoint": str(ckpt),
        "scenes": rows,
        "worst_depth": sorted(rows, key=lambda r: -r["depth_mae"])[:2],
    }
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(f"wrote {out_dir}/summary.json", flush=True)
    return summary


if __name__ == "__main__":
    main()
