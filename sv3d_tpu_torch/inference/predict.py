"""Serving CLI: RGB image -> reconstructed scene mesh (port of
sv3d_tpu/inference/predict.py).

    python -m sv3d_tpu_torch.inference.predict --device cuda \
        --checkpoint model.pt --rgb scene/rgb.png \
        --intrinsics scene/intrinsic.txt --out out/

--checkpoint is either a trainer's checkpoint (checkpoints/last or
checkpoints/step_<N> of a SceneNet run: {"model", "optimizer", "step"}, of
which serving reads the model) or a bare torch.save'd SceneNet state_dict
(as sv3d_tpu_torch.convert.from_flax makes it).  Multiple --rgb paths (or a
directory of *.png) are served in turn; --distance serves the GT-depth
pipeline from distance EXRs instead of the UNet.  Model flags must match the
checkpoint's architecture; --precision need not: the parameters are f32 at
both precisions, so a checkpoint trained at 32 or 16 serves at either
(16 runs the UNet and the IF-Net convs in bf16, and the sweep reads the
bf16 pyramid as it is).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    from sv3d_tpu_torch.config import DEFAULT_MAX_Z, DEFAULT_MIN_Z

    p = argparse.ArgumentParser(description="sv3d_tpu_torch image->mesh serving")
    p.add_argument("--checkpoint", required=True,
                   help="a SceneNet trainer checkpoint (checkpoints/last) or a "
                   "torch.save'd SceneNet state_dict (.pt)")
    p.add_argument("--rgb", nargs="+", default=[],
                   help="rgb image path(s), or a directory of *.png")
    p.add_argument("--distance", nargs="+", default=[],
                   help="distance EXR path(s) — serve the GT-depth pipeline "
                   "instead of the UNet")
    p.add_argument("--intrinsics", default=None,
                   help="intrinsic.txt (default: alongside the first input)")
    p.add_argument("--out", default="predictions")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="occupancy iso-level for marching cubes")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; fails if absent)")
    # architecture flags (must match the checkpoint)
    p.add_argument("--net_res", type=int, default=128)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--resize_input", action="store_true")
    p.add_argument("--scale_factor", type=int, default=1)
    p.add_argument("--inf_res", type=int, default=1)
    p.add_argument("--precision", type=int, default=32,
                   help="32: float32; 16: bf16 mixed precision (the UNet and "
                   "IF-Net convs in bf16); a checkpoint of either precision "
                   "serves at either")
    p.add_argument("--min_z", type=float, default=DEFAULT_MIN_Z)
    p.add_argument("--max_z", type=float, default=DEFAULT_MAX_Z)
    p.add_argument("--sigma", nargs="+", type=float, default=[1.5])
    p.add_argument("--kernel_size", nargs="+", type=int, default=[3, 3, 3])
    p.add_argument("--skip_unet", action="store_true",
                   help="the checkpoint was trained without a UNet; required "
                   "to match its parameters when serving --distance inputs")
    p.add_argument("--dump_depth", action="store_true",
                   help="also write the predicted depth map (.png + .exr)")
    return p


def _expand(paths, suffix):
    out = []
    for s in paths:
        q = Path(s)
        out.extend(sorted(q.glob(f"*{suffix}")) if q.is_dir() else [q])
    return out


def resolve_device(name: str) -> torch.device:
    """The serving device; a CUDA device without CUDA raises (no CPU
    fallback)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return device


def load_model(args):
    """Build (config, model) for serving from CLI args + checkpoint; the
    model is in eval mode on args.device."""
    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.geometry.camera import read_intrinsics
    from sv3d_tpu_torch.geometry.frustum import FrustumGrid
    from sv3d_tpu_torch.models.scene_net import SceneNet

    device = resolve_device(args.device)
    config = Config(
        net_res=args.net_res, W=args.W, resize_input=args.resize_input,
        scale_factor=args.scale_factor, inf_res=args.inf_res,
        precision=args.precision, min_z=args.min_z, max_z=args.max_z,
        sigma=args.sigma, kernel_size=args.kernel_size,
        skip_unet=args.skip_unet, seed=0,
    )
    intrinsics = read_intrinsics(args.intrinsics)
    frustum = FrustumGrid.create(intrinsics, voxel_size=0.05 * config.scale_factor)
    model = SceneNet(config, intrinsics, frustum, device=device)
    state = torch.load(args.checkpoint, map_location=device, weights_only=True)
    # a trainer's checkpoint (training/checkpoint.py) holds the state_dict
    # under "model"; its optimizer state is of no use to serving
    if isinstance(state.get("model"), dict):
        state = state["model"]
    model.load_state_dict(state)
    return config, model.eval()


def predict(config, model, rgb=None, distance=None, intrinsics=None):
    """One sample -> (voxel_occupancy (1, *dims, 1) on the model's device,
    depthmap (240, 320) numpy).

    rgb: (H, W, 3) normalized float32, or None with a distance map for the
    GT-depth pipeline.  Runs under inference_mode with TF32 off, so f32
    convs and matmuls are full f32 like the JAX package's.  A config of
    another decoder than the IF-Net raises ValueError."""
    from sv3d_tpu_torch.config import decoder_of
    from sv3d_tpu_torch.geometry.camera import distance_to_depth

    if decoder_of(config) != "ifnet":
        raise ValueError(f"predict serves the IF-Net's field; decoder {decoder_of(config)!r} "
                         "has no serving path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = model.project.sigma.device
    with torch.inference_mode():
        if rgb is not None:
            img = torch.as_tensor(np.asarray(rgb, np.float32), device=device)[None]
            depth = model.predict_depth(img)
        else:
            dist = torch.as_tensor(np.asarray(distance, np.float32), device=device)
            depth = distance_to_depth(dist, intrinsics.focal_length)[None]
        vox = model.project(model.project_depth(depth))
    return vox, depth[0].cpu().numpy()


def main(argv=None):
    args = build_parser().parse_args(argv)
    if bool(args.rgb) == bool(args.distance):
        sys.exit("pass exactly one of --rgb / --distance")
    if args.skip_unet and args.rgb:
        sys.exit(
            "--skip_unet builds the model without a UNet, so it cannot serve "
            "--rgb inputs; pass --distance EXRs instead"
        )
    inputs = _expand(args.rgb or args.distance, ".png" if args.rgb else ".exr")
    if not inputs:
        sys.exit("no input files found")
    if args.intrinsics is None:
        cand = inputs[0].parent / "intrinsic.txt"
        if not cand.exists():
            sys.exit(f"--intrinsics not given and {cand} not found")
        args.intrinsics = cand

    from sv3d_tpu_torch.geometry.camera import read_intrinsics
    from sv3d_tpu_torch.inference.dense_grid import implicit_to_mesh

    config, model = load_model(args)
    intrinsics = read_intrinsics(args.intrinsics)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    for path in inputs:
        t0 = time.perf_counter()
        if args.rgb:
            # PIL is imported only here: loading a PNG is the one step that needs it
            from sv3d_tpu_torch.data.datasets import _load_normalized_rgb

            rgb = _load_normalized_rgb(path, False, config.resize_input, config.W)
            vox, depth = predict(config, model, rgb=rgb)
        else:
            from sv3d_tpu_torch.io.exr import read_exr_channel

            vox, depth = predict(
                config, model, distance=read_exr_channel(path, "R"), intrinsics=intrinsics,
            )
        base = path.stem if path.stem not in ("rgb", "distance") else path.parent.name
        mesh_path = out_dir / f"{base}.obj"
        implicit_to_mesh(
            model.ifnet, vox, config.dims, args.threshold, mesh_path,
            res_increase=config.inf_res,
        )
        if args.dump_depth:
            from sv3d_tpu_torch.utils.visualize import visualize_depthmap

            visualize_depthmap(depth, out_dir / f"{base}_depth", flip=True)
        print(f"{path} -> {mesh_path}  ({time.perf_counter() - t0:.2f}s)")


if __name__ == "__main__":
    main()
