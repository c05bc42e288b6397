"""Multi-scene generalization quality run (port of
scripts/quality_multiscene.py): train on N synthetic scenes, evaluate IoU,
Chamfer-L2 and normal consistency on held-out scenes, the protocol shape of
the reference's headline table (test-split means over meshes; dataset sizes
2753/291/291).

Stages (--stage data|train|eval, or all):
  data   generate train/val/test scenes (quality/synthetic_scenes.py), run
         preprocessing.process_sample_pipeline, write the split files;
  train  fit SceneNetTrainer on the train split, validating on val;
  eval   mesh every test scene from the model's own prediction (the best
         validation checkpoint, or the end-of-fit state under --stage all)
         and score it against its GT mesh.

The data root carries a params stamp (seed, num_samples, scale_factor): a
rerun with other parameters is refused, since the data stage keeps scenes
that exist.  A root without a stamp is stamped only while it holds no scene
tree; a tree without a stamp is refused, because the parameters it was made
with are unknown.

    python -m sv3d_tpu_torch.quality.multiscene --root .synth_quality \\
        --n_train 32 --n_val 8 --n_test 8 --steps 4000 --use_unet \\
        --out quality_multiscene.json
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

SPLITS = ("train", "val", "test")
STAMP = "params_stamp.json"


def stamp_root(root: Path, stamp: dict) -> None:
    """Check root's params stamp against this run's, or write it to a root
    that holds no scene tree yet; SystemExit for another run's stamp and for
    a tree without one."""
    path = root / STAMP
    if path.exists():
        old = json.loads(path.read_text())
        if old != stamp:
            raise SystemExit(
                f"data root {root} was generated with {old}, but this run requests {stamp}; "
                "the data stage keeps scenes that exist, so it would mix stale data with the "
                f"new parameters: use a fresh --root or delete the tree (and {STAMP})")
        return
    if (root / "raw").exists() or (root / "processed").exists():
        raise SystemExit(
            f"data root {root} holds a scene tree but no {STAMP}: the parameters it was "
            "generated with are unknown; use a fresh --root or delete the tree")
    root.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(stamp))


def build_data(root: Path, counts: dict, scale: int, num_samples: int, seed: int,
               num_workers: int, append_train: int = 0) -> list:
    """Generate scenes, preprocess them and write the split files; returns the
    scene names.  Scene ids are unique across splits (train first, then val,
    then test), so one raw/processed tree serves all three split files.

    append_train: extra train scenes generated after the test block, so the
    val/test scene indices (and, since each scene is seeded by (seed, i), the
    exact geometry) are those of a smaller tree with the same counts: a
    bigger train set scores the same held-out scenes as an earlier run."""
    from sv3d_tpu_torch.data.splits import write_split
    from sv3d_tpu_torch.preprocessing.process_sample import process_sample_pipeline
    from sv3d_tpu_torch.quality.synthetic_scenes import generate

    stamp_root(root, {"seed": seed, "num_samples": num_samples, "scale_factor": scale})
    total = sum(counts.values()) + append_train
    # scenes are seeded per index, so growing a tree (or resuming an
    # interrupted data stage) renders and processes only the missing scenes
    names = generate(root, total, bad_scenes=0, seed=seed, splitsdir="synth",
                     skip_existing=True, num_workers=num_workers)
    processed, quarantined = process_sample_pipeline(
        root / "raw", "synth", down_scale_factor=scale, num_samples=num_samples, seed=seed,
        processed_root=root / "processed" / "synth", num_workers=num_workers,
        skip_existing=True)
    if quarantined:
        raise RuntimeError(f"synthetic scenes were quarantined: {quarantined}")
    # the pipeline walks the whole raw tree: a tree grown by an earlier run
    # with a larger append_train holds more scenes than these splits use
    done = {p.replace("\\", "/").split("raw/synth/")[-1] for p in processed}
    missing = [n for n in names if n not in done]
    if missing:
        raise RuntimeError(f"scenes not processed: {missing[:5]}")

    off = 0
    members = {}
    for split in SPLITS:
        members[split] = names[off:off + counts[split]]
        off += counts[split]
    members["train"] = members["train"] + names[off:]
    for split in SPLITS:
        write_split(root, "synth", split, members[split])
    return names


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="multi-scene held-out quality run")
    p.add_argument("--root", default=".synth_quality")
    p.add_argument("--n_train", type=int, default=32)
    p.add_argument("--append_train", type=int, default=0,
                   help="extra train scenes generated after the test block: val/test keep "
                   "the scenes they have without it, so a larger-train run scores the same "
                   "held-out scenes as a smaller one")
    p.add_argument("--n_val", type=int, default=8)
    p.add_argument("--n_test", type=int, default=8)
    p.add_argument("--scale_factor", type=int, default=1)
    p.add_argument("--net_res", type=int, default=128)
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--num_samples", type=int, default=100000,
                   help="occupancy sample points per sigma per scene (the reference's 100k)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_points", type=int, default=50000)
    p.add_argument("--data_workers", type=int, default=4)
    p.add_argument("--use_unet", action="store_true",
                   help="end-to-end protocol: reconstruct from the depth predicted from "
                   "the RGB render (default: the GT-depth viability protocol)")
    p.add_argument("--fused_query", action="store_true")
    p.add_argument("--flip_aug", action="store_true",
                   help="exact-mirror horizontal flip augmentation on the train split")
    p.add_argument("--precision", type=int, default=32,
                   help="32: float32; 16: bf16 mixed precision")
    p.add_argument("--val_every", type=int, default=None,
                   help="steps between validations and checkpoint scoring (default "
                   "steps // 4); the eval stage scores the best validation checkpoint")
    p.add_argument("--monitor", default="val_point_iou",
                   help="checkpoint-ranking metric (max mode for *_iou); val CE, the "
                   "reference's, is minimized early by a constant base-rate predictor")
    p.add_argument("--ckpt", default=None,
                   help="eval stage only: evaluate this checkpoint instead of the "
                   "manifest's best")
    p.add_argument("--stage", choices=["all", "data", "train", "eval"], default="all")
    p.add_argument("--resume_last", action="store_true",
                   help="continue the train stage from <exp>/checkpoints/last if it exists")
    p.add_argument("--exp", default="runs/quality_multiscene")
    p.add_argument("--out", default="quality_multiscene.json")
    p.add_argument("--device", default="cuda",
                   help="torch device to train and evaluate on (default cuda; fails if "
                   "absent)")
    return p


def _config(args, root: Path):
    from sv3d_tpu_torch.config import Config

    return Config(
        datasetdir=str(root), splitsdir="synth", skip_unet=not args.use_unet,
        precision=args.precision, fused_query=args.fused_query, flip_aug=args.flip_aug,
        scale_factor=args.scale_factor, num_points=args.num_points,
        batch_size=args.batch_size, max_epoch=10_000, seed=args.seed, sanity_steps=0,
        # checkpoints ride the validation cadence, which refreshes `last` too
        save_epoch=10_000, net_res=args.net_res, lr=args.lr,
        experiment="quality_multiscene",
        val_check_interval=max(args.val_every or args.steps // 4, 1), val_check_percent=1.0,
        monitor=args.monitor, monitor_mode="max" if args.monitor.endswith("_iou") else "min",
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    root = Path(args.root)
    counts = {"train": args.n_train, "val": args.n_val, "test": args.n_test}

    if args.stage in ("all", "data"):
        t0 = time.time()
        build_data(root, counts, args.scale_factor, args.num_samples, args.seed,
                   args.data_workers, args.append_train)
        print(f"data: {sum(counts.values()) + args.append_train} scenes generated and "
              f"processed in {time.time() - t0:.1f}s", flush=True)
        if args.stage == "data":
            return
    if not (root / STAMP).exists():
        raise SystemExit(f"data root {root} has no {STAMP}: run --stage data first")

    from sv3d_tpu_torch.inference.predict import resolve_device
    from sv3d_tpu_torch.quality.scoring import (
        depth_voxels,
        device_name,
        mesh_and_score,
        predicted_depth,
    )
    from sv3d_tpu_torch.training.checkpoint import load_state_from_checkpoint
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    cfg = _config(args, root)
    exp_dir = Path(args.exp)
    if args.resume_last and (exp_dir / "checkpoints" / "last").exists():
        cfg = cfg.replace(resume=str(exp_dir / "checkpoints" / "last"))
        print(f"resuming from {cfg.resume}", flush=True)
    trainer = SceneNetTrainer(cfg, device=resolve_device(args.device), experiment_dir=exp_dir)
    n_train = args.n_train + args.append_train
    if len(trainer.train_dataset()) != n_train or len(trainer.val_dataset()) != args.n_val:
        raise SystemExit(f"the split files under {root} do not hold {n_train} train and "
                         f"{args.n_val} val scenes: run --stage data with these counts")

    stats_path = exp_dir / "train_stats.json"
    if args.stage in ("all", "train"):
        t0 = time.time()
        state = trainer.fit(max_steps=args.steps)
        train_s = time.time() - t0
        print(f"trained {args.steps} steps in {train_s:.1f}s "
              f"({args.steps / train_s:.2f} steps/s)", flush=True)
        # for a later --stage eval
        stats_path.write_text(json.dumps({"train_seconds": round(train_s, 1)}))
        if args.stage == "train":
            return
        eval_ckpt = "end-of-fit state"
    else:
        # the best validation checkpoint, as the reference's protocol scores
        # it; `last` when no validation ran
        ckpt_dir = exp_dir / "checkpoints"
        ckpt = ckpt_dir / "last"
        manifest = ckpt_dir / "manifest.json"
        if args.ckpt:
            ckpt = Path(args.ckpt)
            print(f"evaluating explicitly requested checkpoint {ckpt}", flush=True)
        elif manifest.exists():
            scores = json.loads(manifest.read_text())["scores"]
            if scores:
                ckpt = Path(scores[0][1])
                print(f"evaluating best-val checkpoint {ckpt} "
                      f"({trainer.monitor}={scores[0][0]:.4f})", flush=True)
        state = load_state_from_checkpoint(trainer.build_state(), ckpt)
        eval_ckpt = ckpt.name
        train_s = (json.loads(stats_path.read_text())["train_seconds"]
                   if stats_path.exists() else None)

    # each test scene: mesh from the model's own prediction, both meshes
    # normalized into the unit cube, 100k-style surface samples and
    # volumetric IoU from uniform box samples (the reference's protocol)
    model = state.model
    test_ds = trainer.test_dataset()
    if len(test_ds) != args.n_test:
        raise SystemExit(f"the test split holds {len(test_ds)} scenes, not {args.n_test}")
    mesh_dir = exp_dir / "test_meshes"
    mesh_dir.mkdir(parents=True, exist_ok=True)
    per_scene = []
    for i in range(len(test_ds)):
        sample = test_ds[i]
        depth = (predicted_depth(model, sample["rgb"]) if args.use_unet
                 else sample["depthmap_target"])
        vox = depth_voxels(model, depth)
        pred_path = mesh_dir / f"{sample['name'].replace('/', '_')}.obj"
        m = mesh_and_score(model, vox, cfg.dims, pred_path, sample["mesh"], args.eval_points)
        per_scene.append({"name": sample["name"], **m})
        if "failed" in m:
            print(f"test scene {sample['name']}: FAILED ({m['failed']})", flush=True)
        else:
            print(f"test scene {sample['name']}: iou={m['iou']:.4f} "
                  f"chamfer={m['chamfer_l2']:.6f} normals={m['normals']:.4f}", flush=True)

    chams = [s["chamfer_l2"] for s in per_scene if s["chamfer_l2"] is not None]
    result = {
        "protocol": ("end_to_end_generalization" if args.use_unet
                     else "viability_gt_depth_generalization"),
        "dataset": "synthetic box rooms (sv3d_tpu_torch/quality/synthetic_scenes.py)",
        "n_train": n_train, "n_val": args.n_val, "n_test": args.n_test,
        "scale_factor": args.scale_factor, "net_res": args.net_res,
        "precision": args.precision,
        "steps": args.steps, "batch_size": args.batch_size, "flip_aug": args.flip_aug,
        "train_seconds": round(train_s, 1) if train_s is not None else None,
        "eval_checkpoint": eval_ckpt,
        "monitor": args.monitor,
        "device": device_name(trainer.device),
        "iou": round(float(np.mean([s["iou"] for s in per_scene])), 4),
        "chamfer_l2": round(float(np.mean(chams)), 6) if chams else None,
        "normals": round(float(np.mean([s["normals"] for s in per_scene])), 4),
        "n_failed": sum(1 for s in per_scene if "failed" in s),
        "per_scene": per_scene,
        "note": (
            "metrics are means over HELD-OUT test scenes never seen in training, the "
            "reference's test-split protocol shape, on synthetic data; NOT comparable to "
            "the reference's 0.40-0.48 IoU on real scenes"
        ),
    }
    Path(args.out).write_text(json.dumps(result, indent=2))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
