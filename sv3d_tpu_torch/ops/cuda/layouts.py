"""Memory layouts that the hand-written kernels read, made by torch ops.

  stage_channels_last  the channels-last (B, G, C) copy of a (B, C, G)
                       level that K4, K5, K7, K2 bf16 and K6 bf16 read
  mma_b_fragments      a weight in the register order of mma.m16n8k16's B
                       operand, as K2 bf16, K3 bf16 and K6 bf16 stream it
  tensor_record        what a layout made once for many calls records of
                       a tensor it was made from (matches_record checks it)
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch


def tensor_record(t: torch.Tensor) -> tuple:
    """What a layout made once for many calls (SweepPlan, MlpOperands)
    records of a tensor it was made from: the object (a weak reference), its
    data pointer, shape and dtype, and its version counter where it has one
    (an inference tensor, as the levels of a sweep under
    torch.inference_mode are, has none)."""
    return (weakref.ref(t), t.data_ptr(), tuple(t.shape), t.dtype,
            None if t.is_inference() else t._version)


def matches_record(record: tuple, t: torch.Tensor) -> bool:
    """Whether t is the tensor of tensor_record's record, unchanged since."""
    return record[0]() is t and record[1:] == tensor_record(t)[1:]


def stage_channels_last(flat: torch.Tensor) -> torch.Tensor:
    """The contiguous channels-last (B, G, C) level that K4, K5 and K7 read, from
    a (B, C, G) level in any memory layout: a view when the level already
    lies channels-last (C = 1 always does), else torch's transpose copy,
    counted in stage_channels_last.copies."""
    cl = flat.transpose(1, 2)
    if not cl.is_contiguous():
        stage_channels_last.copies += 1
    return cl.contiguous()


@functools.lru_cache(maxsize=16)
def fragment_order(n_out: int, k: int) -> np.ndarray:
    """mma_b_fragments' order as flat indices into an (n_out, k) matrix."""
    lane = np.arange(32)
    kk = 2 * (lane % 4)[:, None] + np.asarray([0, 1, 8, 9])  # (32, 4)
    n = (np.arange(n_out // 16)[:, None, None] * 16 + np.arange(2)[None, None, :] * 8
         + (lane // 4)[None, :, None])  # (P, 32, 2)
    chunk = np.arange(k // 16)[:, None, None, None, None] * 16
    flat = n[None, :, :, :, None] * k + chunk + kk[None, None, :, None, :]  # (K/16, P, 32, 2, 4)
    return flat.reshape(k // 16, n_out // 16, 32, 8)


def mma_b_fragments(w: torch.Tensor) -> torch.Tensor:
    """(N, K) weight -> (K/16, N/16, 32, 8): per 16-row chunk of K, per pair
    of 8-column n-tiles, per lane, the lane's two mma.m16n8k16 B fragment
    registers of each tile of the pair (B[k][n] = w[n, k]; lane l holds n =
    l // 4 of the tile and k = 2 (l % 4) + {0, 1, 8, 9})."""
    return w.reshape(-1)[_fragment_index(*w.shape, w.device)]


@functools.lru_cache(maxsize=16)
def _fragment_index(n_out: int, k: int, device) -> torch.Tensor:
    return torch.from_numpy(fragment_order(n_out, k)).to(device)


stage_channels_last.copies = 0
