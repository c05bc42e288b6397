"""CLI flag parsing -> (Config, device) for the port's trainers.

The parser is a copy of sv3d_tpu/training/cli.py's build_parser, flag for
flag, plus --device and --decoder (Config.decoder: the IF-Net,
Convolutional Occupancy Networks' grid decoder at room_grid64's widths, or
3DShape2VecSet's transformer autoencoder at ae_d512_m512's).
A copy, not an import, because importing
sv3d_tpu.training.cli runs sv3d_tpu/training/__init__.py, which imports flax
and optax.  parse_config joins the process group first, as the JAX
package's joins its cluster: under torchrun, or with the three cluster
flags, it initializes torch.distributed (sv3d_tpu_torch.parallel; nccl for
--device cuda, gloo for the CPU) and gives each rank its own GPU.  Multi-GPU
training, one process a device:

    torchrun --nproc_per_node 8 -m sv3d_tpu_torch.training.trainer_scene_net \
        --dp 4 --sp 2 --fused_query ...
"""

from __future__ import annotations

import argparse

import torch

from sv3d_tpu_torch.config import DECODERS, DEFAULT_MAX_Z, DEFAULT_MIN_Z, Config
from sv3d_tpu_torch.parallel.mesh import check_world
from sv3d_tpu_torch.parallel.multihost import initialize_distributed, local_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="sv3d_tpu_torch trainer")
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--sanity_steps", type=int, default=2)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--splitsdir", type=str, default="overfit")
    p.add_argument("--datasetdir", type=str, default="data")
    p.add_argument("--val_check_percent", type=float, default=0.5)
    p.add_argument("--val_check_interval", type=float, default=0.25)
    p.add_argument("--max_epoch", type=int, default=100)
    p.add_argument("--save_epoch", type=int, default=1)
    p.add_argument("--monitor", type=str, default="",
                   help="checkpoint-ranking metric (default: the trainer's, "
                   "val_point_iou/max for the scene trainer); pass val_ce_loss "
                   "for the reference's monitor")
    p.add_argument("--monitor_mode", type=str, default="",
                   choices=["", "min", "max"])
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--experiment", type=str, default="scenes_net")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--sigma", nargs="+", type=float, default=[1.5])
    p.add_argument("--kernel_size", nargs="+", type=int, default=[3, 3, 3])
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--net_res", type=int, default=128)
    p.add_argument("--inf_res", type=int, default=1)
    p.add_argument("--precision", type=int, default=32,
                   help="32: float32; 16: bf16 mixed precision (the UNet and "
                   "IF-Net convs in bf16 on f32 parameters)")
    p.add_argument("--profiler", type=str, default=None)
    p.add_argument("--version", type=str, default=None)
    p.add_argument("--resize_input", action="store_true")
    p.add_argument("--flip_aug", action="store_true",
                   help="exact-mirror horizontal flip augmentation on the "
                   "end-to-end train split (see Config.flip_aug)")
    p.add_argument("--pretrain_unet", default=None)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--min_z", type=float, default=DEFAULT_MIN_Z)
    p.add_argument("--max_z", type=float, default=DEFAULT_MAX_Z)
    p.add_argument("--scale_factor", type=int, default=1)
    p.add_argument("--subsample_points", type=int, default=0)
    p.add_argument("--skip_unet", action="store_true")
    p.add_argument("--no_depth_sup", action="store_true")
    p.add_argument("--test", type=str, default=None)
    p.add_argument(
        "--fused_query", action="store_true",
        help="train through the point-query kernels (K4 forward, K7/K8 "
        "backward); f32, as exact as the default gather path",
    )
    p.add_argument("--dp", type=int, default=1, help="data-parallel mesh size")
    p.add_argument("--sp", type=int, default=1, help="point-sharding mesh size")
    # the cluster, when no torchrun environment names it: rank 0's host:port
    # (or an init URL such as file://...), the number of processes and this
    # one's rank; all three or none
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--decoder", type=str, default="ifnet", choices=DECODERS,
                   help="ifnet (the default); convonet_grid: Convolutional "
                   "Occupancy Networks' grid decoder on the back-projected depth; "
                   "vecset: 3DShape2VecSet's transformer autoencoder (ae_d512_m512) "
                   "on a lattice of it; both train only, at precision 32")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda; fails if absent)")
    return p


def parse_config(argv=None):
    """Parse trainer flags -> (Config, torch.device), joining the process
    group first when torchrun or the cluster flags name one.  A CUDA device
    without CUDA raises (no CPU fallback), and so does a --dp x --sp that
    is not the number of ranks (ValueError)."""
    args = vars(build_parser().parse_args(argv))
    cluster = [args.pop(k) for k in ("coordinator_address", "num_processes", "process_id")]
    device = torch.device(args.pop("device"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available")
    initialize_distributed(*cluster, backend="nccl" if device.type == "cuda" else "gloo")
    check_world(args["dp"], args["sp"])
    return Config(**args), local_device(device)
