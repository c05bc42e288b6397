"""Joining a torch.distributed process group (port of
sv3d_tpu/parallel/multihost.py).

One process a device, PyTorch's idiom: torchrun starts the processes and
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT, or the
caller names the cluster itself (--coordinator_address, --num_processes,
--process_id).  The (dp, sp) mesh (parallel/mesh.py) is laid out over the
world's ranks.  Single-process runs are the common case, and every helper
here degrades to a no-op or the identity without a process group, so the
trainers' code is the same in both.

Division of labour per rank:
  * DataLoader(process_index=dp coordinate, process_count=dp) loads its
    contiguous rows of every global batch (data/loader.py); the sp ranks of
    one dp row load the same rows, and each queries its own slice of their
    points (mesh.shard_batch, SceneNet.forward(point_slice=)).
  * Gradients are all-reduced once a step in one flat buffer
    (Mesh.mean_gradients); BatchNorm all-reduces its batch statistics over
    the ranks of its sp column, which together hold the whole batch.
  * Rank 0 writes the experiment directory, checkpoints and logs; every
    rank takes part in each collective, visualization and validation
    included, and waits at a barrier after each checkpoint save.

The backend is nccl for CUDA and gloo for the CPU, or what the caller names
(gloo for two ranks that share one GPU, which nccl refuses).  Nothing falls
back from one to the other.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

#: the environment torchrun sets for each process
TORCHRUN_ENV = ("RANK", "WORLD_SIZE")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the process group (before building a model).

    Returns True when this process is in a group.  With none of the three
    arguments and no torchrun environment it does nothing and returns
    False, so single-process entry points call it unconditionally.  A
    process already in a group of num_processes ranks as process_id (or
    any, when they are not given) stays in it.  The
    explicit form takes all three: coordinator_address is host:port (a TCP
    rendezvous on rank 0's host) or a URL with its scheme, e.g. file://...
    backend: "nccl", "gloo" or None (nccl when CUDA is available, else
    gloo)."""
    explicit = (coordinator_address, num_processes, process_id)
    torchrun = all(k in os.environ for k in TORCHRUN_ENV)
    if all(v is None for v in explicit) and not torchrun:
        return False
    if any(v is None for v in explicit) and not all(v is None for v in explicit):
        raise ValueError(
            "--coordinator_address, --num_processes and --process_id go together "
            f"(got {explicit}); or launch with torchrun, which sets RANK and WORLD_SIZE")
    if dist.is_initialized():
        if (num_processes not in (None, dist.get_world_size())
                or process_id not in (None, dist.get_rank())):
            raise RuntimeError(
                f"initialize_distributed: already rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, asked for {process_id} of {num_processes}")
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return True
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on the rank that writes checkpoints, logs and meshes."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def local_device(device) -> torch.device:
    """The device of this rank: cuda:<LOCAL_RANK> (torchrun's; else the rank
    modulo the visible GPUs) for a bare "cuda" in a group of several ranks;
    a device with an index, or the CPU, as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or process_count() == 1:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else process_index() % torch.cuda.device_count()
    return torch.device("cuda", index)
