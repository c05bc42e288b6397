"""Quality check by overfitting (port of scripts/quality_overfit.py): train the
scene pipeline on one scene, mesh its occupancy field and score the mesh
against the GT mesh with the reference's protocol (IoU, Chamfer-L2, normal
consistency).

The scene is synthetic (quality/synthetic_scenes.py, scene 0 of --seed,
preprocessed at --scale_factor into --root): the reference overfit fixture
that the JAX package's script reads is not part of the repository.  The
train split repeats the scene 500 times (one epoch is 500 steps), the val
split holds it once; validation never runs.  Without --use_unet the run is
the viability protocol (GT depth -> voxelization -> IF-Net), with it the
end-to-end one (the UNet trained jointly, the mesh made from predicted
depth).  --precision 16 trains and meshes in bf16 mixed precision, so one
seed in both precisions measures what bf16 costs in IoU.

    python -m sv3d_tpu_torch.quality.overfit --steps 3000 --use_unet \\
        --precision 16 --exp runs/quality_e2e_p16

Writes the results JSON to <exp>/quality.json (or --out) and prints it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

#: the train split repeats the scene, so an epoch is this many steps
REPEATS = 500


def build_data(root: Path, scale: int, num_samples: int, seed: int) -> str:
    """One synthetic scene under root (splitsdir "overfit"): rendered,
    preprocessed, and the train / val split files; returns its name.  The
    root is stamped as the multi-scene runs stamp theirs."""
    from sv3d_tpu_torch.data.splits import write_split
    from sv3d_tpu_torch.preprocessing.process_sample import process_sample_pipeline
    from sv3d_tpu_torch.quality.multiscene import stamp_root
    from sv3d_tpu_torch.quality.synthetic_scenes import generate

    stamp_root(root, {"seed": seed, "num_samples": num_samples, "scale_factor": scale})
    (name,) = generate(root, 1, seed=seed, splitsdir="overfit", skip_existing=True)
    processed, quarantined = process_sample_pipeline(
        root / "raw", "overfit", down_scale_factor=scale, num_samples=num_samples, seed=seed,
        processed_root=root / "processed" / "overfit", skip_existing=True)
    if quarantined or len(processed) != 1:
        raise RuntimeError(f"the synthetic scene was not processed: {quarantined}")
    write_split(root, "overfit", "train", [name] * REPEATS)
    write_split(root, "overfit", "val", [name])
    return name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="overfit one scene and score its mesh")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--net_res", type=int, default=128)
    p.add_argument("--scale_factor", type=int, default=1,
                   help="2 = the reference report's half-scale viability config "
                   "(70x52x56 grid; pair with --net_res 32)")
    p.add_argument("--root", default=".synth_overfit",
                   help="data root of the synthetic scene (made when absent)")
    p.add_argument("--seed", type=int, default=0, help="the scene's and the run's seed")
    p.add_argument("--num_samples", type=int, default=100000,
                   help="occupancy sample points per sigma (the reference's 100k)")
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--eval_points", type=int, default=50000)
    p.add_argument("--out", default=None,
                   help="results JSON path (default <exp>/quality.json)")
    p.add_argument("--exp", default=None,
                   help="experiment directory (default runs/quality_e2e with --use_unet, "
                   "else runs/quality_overfit)")
    p.add_argument("--resume_last", action="store_true",
                   help="continue from <exp>/checkpoints/last if present")
    p.add_argument("--use_unet", action="store_true",
                   help="end-to-end protocol: train the UNet jointly and reconstruct from "
                   "predicted depth (default: the GT-depth viability protocol)")
    p.add_argument("--pretrain_unet", default=None)
    p.add_argument("--precision", type=int, default=32,
                   help="32: float32; 16: bf16 mixed precision")
    p.add_argument("--fused_query", action="store_true",
                   help="train through the point-query kernels")
    p.add_argument("--device", default="cuda",
                   help="torch device to train and mesh on (default cuda; fails if absent)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.inference.predict import resolve_device
    from sv3d_tpu_torch.quality.scoring import (
        depth_voxels,
        device_name,
        mesh_and_score,
        predicted_depth,
    )
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    device = resolve_device(args.device)
    root = Path(args.root)
    build_data(root, args.scale_factor, args.num_samples, args.seed)
    cfg = Config(
        datasetdir=str(root), splitsdir="overfit", skip_unet=not args.use_unet,
        pretrain_unet=args.pretrain_unet, precision=args.precision,
        fused_query=args.fused_query, scale_factor=args.scale_factor,
        num_points=args.num_points, batch_size=1, max_epoch=10_000, seed=args.seed,
        sanity_steps=0, save_epoch=10_000, net_res=args.net_res, lr=args.lr,
        experiment="quality_overfit", val_check_interval=1e9,
    )
    out_dir = Path(args.exp or ("runs/quality_e2e" if args.use_unet else "runs/quality_overfit"))
    if args.resume_last and (out_dir / "checkpoints" / "last").exists():
        cfg = cfg.replace(resume=str(out_dir / "checkpoints" / "last"))
        print(f"resuming from {cfg.resume}", flush=True)
    trainer = SceneNetTrainer(cfg, device=device, experiment_dir=out_dir)

    t0 = time.time()
    state = trainer.fit(max_steps=args.steps)
    train_s = time.time() - t0
    print(f"trained {args.steps} steps in {train_s:.1f}s "
          f"({args.steps / train_s:.2f} steps/s)", flush=True)

    # the voxel grid as training builds it: from predicted depth (end to
    # end) or GT depth (viability)
    sample = trainer.train_dataset()[0]
    model = state.model
    depth = (predicted_depth(model, sample["rgb"]) if args.use_unet
             else sample["depthmap_target"])
    pred_path = out_dir / "predicted.obj"
    t0 = time.time()
    # both meshes are in the run's grid coordinates (process_sample meshes
    # the GT distance field at --scale_factor)
    metrics = mesh_and_score(model, depth_voxels(model, depth), cfg.dims, pred_path,
                             sample["mesh"], args.eval_points)
    mesh_s = time.time() - t0
    print(f"mesh extracted and scored in {mesh_s:.1f}s -> {pred_path}", flush=True)

    protocol = ("pretrained_unet" if (args.use_unet and args.pretrain_unet)
                else "end_to_end" if args.use_unet else "viability_gt_depth")
    result = {
        "steps": args.steps,
        "fused_query": bool(args.fused_query),
        "precision": args.precision,
        "device": device_name(device),
        "train_seconds": round(train_s, 1),
        "steps_per_sec": round(args.steps / train_s, 3),
        # one cold extraction and scoring, the dense sweep's first call included
        "mesh_seconds_cold": round(mesh_s, 2),
        "protocol": protocol,
        "scale_factor": args.scale_factor,
        "net_res": args.net_res,
        **metrics,
        # the reference report's Table 1 rows: pretrained UNet 0.43, end to
        # end 0.40, viability (GT depth, half scale) 0.48
        "reference": (
            {"iou": 0.43, "chamfer_l2": 0.0065, "normals": 0.82} if protocol == "pretrained_unet"
            else {"iou": 0.40, "chamfer_l2": 0.0094, "normals": 0.77} if args.use_unet
            else {"iou": 0.48, "chamfer_l2": 0.0007, "normals": 0.82}
        ),
        "note": (
            "OVERFIT protocol: train and eval on the SAME single synthetic scene "
            "(sv3d_tpu_torch/quality/synthetic_scenes.py, scene 0 of the seed): a "
            "pipeline-correctness check, not generalization.  The embedded `reference` "
            "numbers are the reference report's TEST-SPLIT MEANS over 291 held-out real "
            "scenes, not comparable with this iou"
        ),
    }
    out_path = Path(args.out) if args.out else out_dir / "quality.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=2))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
