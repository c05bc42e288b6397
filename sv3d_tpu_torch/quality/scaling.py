"""The scene-scaling experiment (port of scripts/run_scaling_arms.sh): one
arm of train-set size 32 against 96, and 96 with flip augmentation, on the
same 8 held-out scenes (`--append_train` grows the train set past the
val/test block), each run of it a `quality.multiscene` train stage and an
eval stage of its best validation checkpoint, in processes of their own.

    python -m sv3d_tpu_torch.quality.scaling --arm 32 --runs 2 --serve \\
        --out QUALITY_TORCH_SCALING_32_r1.json
    python -m sv3d_tpu_torch.quality.scaling --arm 96 --out QUALITY_TORCH_SCALING_96_r1.json
    python -m sv3d_tpu_torch.quality.scaling --arm 96f --out QUALITY_TORCH_SCALING_96f_r1.json

Flags after `--` go to every multiscene command after the arm's own (a CPU
dry run: `-- --device cpu --scale_factor 8 --num_samples 400 --steps 4`).
Several runs of an arm start from the same seed: their spread is the run to
run variation that atomics and cuDNN's algorithm choices leave.  The eval
of one run overlaps the training of the next.

The artifact holds each run's command, train seconds, eval checkpoint and
mean and per-scene IoU, Chamfer-L2 and normal consistency, the card's name
and power limit, the JAX package's figures of the same arm (its round-5
artifact at the checkout's root, without its TPU seconds), and the
comparison decided in advance: the port agrees when the JAX mean IoU lies
within the port's runs widened by SE, with the per-scene paired
differences.  --serve also serves
the first held-out test image from the first run's eval checkpoint through
`inference.predict` and times image->mesh (chip_smoke.py phase 6's method:
median of 5 warm runs, each ending in a synchronize; the device's idle
share from torch.profiler).
"""

from __future__ import annotations

import argparse
import json
import shlex
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: each arm's multiscene flags beyond the common ones
ARMS = {
    "32": ["--append_train", "0", "--steps", "2000"],
    "96": ["--append_train", "64", "--steps", "6000"],
    "96f": ["--append_train", "64", "--steps", "6000", "--flip_aug"],
}
#: the protocol (README's commands; scripts/run_scaling_arms.sh's flags)
COMMON = ["--n_val", "8", "--n_test", "8", "--use_unet", "--val_every", "250",
          "--num_samples", "100000", "--n_train", "32"]
#: the standard error of an 8-scene mean IoU: 0.112 (the sample standard
#: deviation of QUALITY_SCALING_32_r5.json's per-scene IoUs) / sqrt(8)
SE = 0.04


def multiscene_cmd(root: str, arm: str, *flags, extra=()) -> list:
    return [sys.executable, "-m", "sv3d_tpu_torch.quality.multiscene", "--root", root,
            *COMMON, *ARMS[arm], *flags, *extra]


def shown(cmd: list) -> str:
    """cmd as a shell line, with `python` for this interpreter's path."""
    return shlex.join(["python" if a == sys.executable else a for a in cmd])


def _run(cmd: list, log: Path) -> subprocess.Popen:
    print("$ " + shown(cmd), flush=True)
    log.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(cmd, stdout=log.open("w"), stderr=subprocess.STDOUT)


def _wait(proc: subprocess.Popen, log: Path) -> None:
    if proc.wait() != 0:
        sys.stdout.write(log.read_text()[-4000:])
        raise SystemExit(f"{shown(proc.args)} failed with exit code {proc.returncode}")


def jax_reference(path: Path) -> dict | None:
    """The JAX package's figures of the arm from its artifact, without the
    TPU's train seconds."""
    if not path.exists():
        return None
    ref = json.loads(path.read_text())
    return {"source": path.name,
            "note": "the JAX package's figures of the same arm (round 5, on a TPU); no time "
                    "is taken from them",
            **{k: ref[k] for k in ("n_train", "steps", "flip_aug", "eval_checkpoint", "iou",
                                   "chamfer_l2", "normals", "n_failed")},
            "per_scene": [{k: s[k] for k in ("name", "iou", "chamfer_l2", "normals")}
                          for s in ref["per_scene"]]}


def compare(runs: list, ref: dict | None) -> dict | None:
    """The comparison decided before the runs: the JAX mean IoU within
    [lowest run - SE, highest run + SE]; each run's per-scene paired
    differences (port minus JAX) on the same held-out scenes.  None without
    a reference or when its held-out scenes are not the runs' (another size
    of tree)."""
    want = {s["name"]: s["iou"] for s in ref["per_scene"]} if ref else {}
    if any({s["name"] for s in r["per_scene"]} != set(want) for r in runs):
        return None
    ious = [r["iou"] for r in runs]
    band = [min(ious) - SE, max(ious) + SE]
    paired = [{s["name"]: round(s["iou"] - want[s["name"]], 4) for s in r["per_scene"]}
              for r in runs]
    return {"rule": "agrees when the JAX mean IoU lies within [lowest port run - SE, "
                    "highest port run + SE]",
            "se": SE, "band": [round(b, 4) for b in band], "jax_iou": ref["iou"],
            "agrees": band[0] <= ref["iou"] <= band[1],
            "paired_iou_differences": paired,
            "mean_paired_iou_difference": [round(float(np.mean(list(p.values()))), 4)
                                           for p in paired]}


def serve(exp: Path, root: Path, device: str) -> dict:
    """The first held-out test image through `python -m
    sv3d_tpu_torch.inference.predict` from the run's eval checkpoint (the
    mesh's face count), then image->mesh timed in this process."""
    import torch

    from sv3d_tpu_torch.bench.timing import device_info, profile_calls, timed_runs
    from sv3d_tpu_torch.data.datasets import _load_normalized_rgb
    from sv3d_tpu_torch.inference.dense_grid import implicit_to_mesh
    from sv3d_tpu_torch.inference.predict import build_parser, load_model, predict
    from sv3d_tpu_torch.io.mesh import load_obj

    result = json.loads((exp / "quality.json").read_text())
    ckpt = exp / "checkpoints" / result["eval_checkpoint"]
    name = (root / "splits" / "synth" / "test.txt").read_text().split()[0]
    rgb = root / "raw" / "synth" / name / "rgb.png"
    out = exp / "served"
    argv = ["--checkpoint", str(ckpt), "--rgb", str(rgb), "--intrinsics",
            str(root / "intrinsics.txt"), "--device", device, "--out", str(out),
            *(f"--{k}={result[k]}" for k in ("scale_factor", "net_res", "precision"))]
    cmd = [sys.executable, "-m", "sv3d_tpu_torch.inference.predict", *argv]
    print("$ " + shown(cmd), flush=True)
    subprocess.run(cmd, check=True)
    mesh = load_obj(out / f"{rgb.parent.name}.obj")

    config, model = load_model(build_parser().parse_args(argv))
    image = _load_normalized_rgb(rgb, False, config.resize_input, config.W)

    def image_to_mesh():
        vox, _ = predict(config, model, rgb=image)
        implicit_to_mesh(model.ifnet, vox, config.dims, 0.5, out / "timed.obj")

    times = timed_runs(image_to_mesh, device, runs=5, warmup=1)
    served = {"command": shown(cmd), "checkpoint": str(ckpt), "image": name,
              "faces": len(mesh.faces), "verts": len(mesh.vertices),
              "image_to_mesh_s": times, "image_to_mesh_median_s": statistics.median(times),
              "device": device_info(device)}
    if torch.device(device).type == "cuda":
        _, wall, busy, _ = profile_calls(image_to_mesh, steps=2)
        served["profile"] = {"host_ms": wall, "device_ms": busy,
                             "device_idle": 1.0 - busy / wall}
    return served


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="one arm of the scene-scaling experiment")
    p.add_argument("--arm", choices=sorted(ARMS), required=True)
    p.add_argument("--runs", type=int, default=1, help="runs of the arm from the same seed")
    p.add_argument("--root", default=".synth_quality")
    p.add_argument("--exp", default="runs/scaling", help="experiment prefix: <exp>_<arm>_r<i>")
    p.add_argument("--data_workers", type=int, default=8)
    p.add_argument("--serve", action="store_true",
                   help="serve a held-out image from the first run's eval checkpoint")
    p.add_argument("--device", default="cuda", help="the device of the serving timing")
    p.add_argument("--out", required=True)
    p.add_argument("extra", nargs="*", help="flags after -- for every multiscene command")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sv3d_tpu_torch.bench.timing import device_info

    root = Path(args.root)
    commands = []
    t0 = time.time()
    data = multiscene_cmd(args.root, args.arm, "--stage", "data", "--device", "cpu",
                          "--data_workers", str(args.data_workers), extra=args.extra)
    commands.append(shown(data))
    log_dir = Path(f"{args.exp}_{args.arm}_logs")
    _wait(_run(data, log_dir / "data.log"), log_dir / "data.log")
    data_s = time.time() - t0

    exps = [Path(f"{args.exp}_{args.arm}_r{i}") for i in range(args.runs)]
    evals = []
    for exp in exps:
        train = multiscene_cmd(args.root, args.arm, "--stage", "train", "--exp", str(exp),
                               extra=args.extra)
        commands.append(shown(train))
        log = log_dir / f"{exp.name}_train.log"
        _wait(_run(train, log), log)
        # this run's eval overlaps the next run's training
        ev = multiscene_cmd(args.root, args.arm, "--stage", "eval", "--exp", str(exp),
                            "--out", str(exp / "quality.json"), extra=args.extra)
        commands.append(shown(ev))
        log = log_dir / f"{exp.name}_eval.log"
        evals.append((_run(ev, log), log))
    for proc, log in evals:
        _wait(proc, log)

    runs, qualities = [], [json.loads((exp / "quality.json").read_text()) for exp in exps]
    for exp, r in zip(exps, qualities):
        manifest = json.loads((exp / "checkpoints" / "manifest.json").read_text())
        runs.append({"exp": str(exp), "train_seconds": r["train_seconds"],
                     "eval_checkpoint": r["eval_checkpoint"],
                     "best_val_point_iou": manifest["scores"][0][0] if manifest["scores"]
                     else None,
                     **{k: r[k] for k in ("device", "iou", "chamfer_l2", "normals", "n_failed",
                                          "per_scene")}})
    ref = jax_reference(Path(__file__).resolve().parents[2]
                        / f"QUALITY_SCALING_{args.arm}_r5.json")
    info = device_info(args.device)
    result = {
        "what": f"scene-scaling arm {args.arm} (quality.multiscene, --stage train then "
                "--stage eval of the best val_point_iou checkpoint), "
                f"{args.runs} run(s) from seed 0",
        "arm": args.arm, "commands": commands, "data_seconds": round(data_s, 1),
        "nvidia_smi_name_power_limit": (f"{info['name']}, {info['power_limit']}"
                                        if info["power_limit"] else info["name"]),
        **{k: qualities[0][k] for k in (
            "protocol", "n_train", "n_val", "n_test", "scale_factor", "net_res", "precision",
            "steps", "batch_size", "flip_aug", "monitor")},
        "runs": runs,
        "iou": round(float(np.mean([r["iou"] for r in runs])), 4),
        "jax_reference": ref,
        "comparison": compare(runs, ref),
    }
    if args.serve:
        result["serving"] = serve(exps[0], root, args.device)
    Path(args.out).write_text(json.dumps(result, indent=2))
    print(json.dumps({k: result[k] for k in ("arm", "iou", "comparison")}), flush=True)


if __name__ == "__main__":
    main()
