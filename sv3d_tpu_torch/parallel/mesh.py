"""The (dp, sp) mesh over the ranks of a process group (port of
sv3d_tpu/parallel/mesh.py).

The JAX package lays its devices out as a 2-D jax.sharding.Mesh and lets
XLA emit the collectives from sharding annotations.  Here each device is one
process (torchrun), and the collectives are written out:

  * axis dp, data parallel: each dp row of ranks trains on its contiguous
    rows of the global batch (the loader slices them); the parameters are
    replicated (replicate_tree broadcasts rank 0's after a build or a
    restore), and the gradients are averaged over every rank once a step in
    one flat buffer (Mesh.mean_gradients).  BatchNorm's batch statistics
    are all-reduced over the ranks of one sp column (Mesh.column), which
    together hold the whole batch, so every statistic is the global batch's
    as GSPMD computes it.
  * axis sp, point parallel: the ranks of one dp row hold the same rows and
    each queries its own slice of their points (shard_batch,
    SceneNet.forward(point_slice=)); the conv pyramid is computed in each,
    replicated along sp as in JAX's shard_map.  The dense lattice's rows
    are split over sp (inference/dense_grid.py), and evaluate_points' tiles
    over every rank.

Rank r has coordinates (r // sp, r % sp): row-major, as make_mesh reshapes
the JAX package's device list.  A loss that is a mean over the rank's rows
and points (the end-to-end trainer's) is a mean of equal shares, so the
world mean of the gradients is the global batch's gradient; the sp shares
of one sample's points are summed by it, and no pyramid reduction is needed.
"""

from __future__ import annotations

from itertools import chain

import torch
import torch.distributed as dist
from torch import nn

from sv3d_tpu_torch.parallel.multihost import process_count, process_index

#: batch keys whose axis 1 is the query-point axis (B, N, ...): these are
#: sliced over sp besides the loader's dp rows
POINT_KEYS = ("points", "occupancies")


def check_world(dp: int, sp: int) -> None:
    """ValueError unless dp * sp is the number of ranks."""
    if dp < 1 or sp < 1:
        raise ValueError(f"dp and sp must be >= 1, got dp={dp} sp={sp}")
    n = process_count()
    if dp * sp == n:
        return
    if n == 1:
        raise ValueError(
            f"dp={dp} x sp={sp} needs {dp * sp} processes, one a device, and this one has no "
            f"process group: launch with torchrun --nproc_per_node {dp * sp} (or give every "
            "process --coordinator_address, --num_processes and --process_id)")
    raise ValueError(f"dp={dp} x sp={sp} = {dp * sp} differs from the {n} ranks of the "
                     "process group")


class Mesh:
    """This rank's place in a (dp, sp) mesh and its collectives.

    column: the process group of the ranks that share this rank's sp
    coordinate (size dp; None when dp == 1); row: of those that share its
    dp coordinate (size sp; None when sp == 1).  Every collective is a
    no-op on a mesh of one rank, so Mesh() stands for a single process."""

    def __init__(self, dp: int = 1, sp: int = 1, rank: int = 0, column=None, row=None):
        if dp < 1 or sp < 1 or not 0 <= rank < dp * sp:
            raise ValueError(f"no rank {rank} in a dp={dp} x sp={sp} mesh")
        self.dp, self.sp, self.rank = int(dp), int(sp), int(rank)
        self.dp_index, self.sp_index = divmod(self.rank, self.sp)
        self.column, self.row = column, row

    @property
    def size(self) -> int:
        return self.dp * self.sp

    def batch_rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch (its dp coordinate's)."""
        if batch_size % self.dp:
            raise ValueError(f"batch of {batch_size} does not split over dp={self.dp}")
        k = batch_size // self.dp
        return slice(self.dp_index * k, (self.dp_index + 1) * k)

    def point_slice(self, n: int) -> slice:
        """This rank's slice of n query points (its sp coordinate's)."""
        if n % self.sp:
            raise ValueError(f"{n} query points do not split over sp={self.sp}")
        k = n // self.sp
        return slice(self.sp_index * k, (self.sp_index + 1) * k)

    def sum_(self, t: torch.Tensor, over: str = "world") -> torch.Tensor:
        """t summed in place over the world's ranks, or over this rank's
        "row" (no autograd; BatchNorm differentiates its own)."""
        size, group = {"world": (self.size, None), "row": (self.sp, self.row)}[over]
        if size > 1:
            dist.all_reduce(t, group=group)
        return t

    def mean_gradients(self, parameters, divisor: int | None = None) -> None:
        """Each parameter's .grad replaced by the sum over the world's ranks
        divided by divisor (default: the world size, the mean), through one
        flat buffer.  Call it once a step, after every backward and before
        the optimizer step."""
        grads = [p.grad for p in parameters if p.grad is not None]
        if self.size == 1 or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(self.size if divisor is None else divisor)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def make_mesh(dp: int = 1, sp: int = 1) -> Mesh:
    """This rank's mesh over the process group's dp * sp ranks (ValueError
    for another count; a one-rank mesh without a group).  Every rank must
    call it: it makes the column and row groups, collectively."""
    check_world(dp, sp)
    if dp * sp == 1:
        return Mesh()
    i, j = divmod(process_index(), sp)
    columns = [dist.new_group([a * sp + b for a in range(dp)]) for b in range(sp)]
    rows = [dist.new_group([a * sp + b for b in range(sp)]) for a in range(dp)]
    return Mesh(dp, sp, process_index(), column=columns[j] if dp > 1 else None,
                row=rows[i] if sp > 1 else None)


def shard_batch(batch: dict, mesh: Mesh, point_keys=POINT_KEYS) -> dict:
    """The batch with axis 1 of its point_keys arrays (or tensors) cut to
    this rank's sp slice; the loader has already cut its dp rows.  Other
    entries pass as they are."""
    out = dict(batch)
    for k in point_keys:
        v = batch.get(k)
        if v is not None and getattr(v, "ndim", 0) >= 2:
            out[k] = v[:, mesh.point_slice(v.shape[1])]
    return out


def replicate_tree(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Broadcast rank 0's parameters and buffers into every rank's module,
    in place (after a build or a restore); one flat buffer a dtype."""
    if mesh.size == 1:
        return module
    tensors = [t.data for t in chain(module.parameters(), module.buffers())]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=0)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return module
