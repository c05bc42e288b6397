"""The numbers that decide `correct`: gaps between what the program produced
and what the reference works out, each held against a limit of its own
(benchmark/limits/<cell>.json)."""

from __future__ import annotations

import statistics

import torch

#: the iso-level of the served mesh: occupancy 0.5, 127.5 in the uint8 pull
LEVEL = 0.5
LEVEL_U8 = 255.0 * (1.0 - LEVEL)


def edge_count(inside: torch.Tensor) -> int:
    """How many lattice edges join a point inside to one outside."""
    return sum(int((inside.narrow(a, 0, inside.shape[a] - 1)
                    != inside.narrow(a, 1, inside.shape[a] - 1)).sum()) for a in range(3))


def crossings(field_u8: torch.Tensor) -> int:
    """How many lattice edges the uint8 field crosses the iso-level along:
    the vertices that marching cubes makes of it, one an edge."""
    return edge_count(field_u8 > LEVEL_U8)


#: the names of mesh_numbers' gaps
MESH_NUMBERS = ("depth_gap", "vox_gap", "field_off", "vertex_gap")


def mesh_numbers(depth, vox, field_u8, n_verts: int, ref_depth, ref_vox, ref_occ) -> dict:
    """One served request's gaps: depth (metres) and voxel occupancy, the
    largest; the share of lattice points whose uint8 value lies more than
    OFF_STEPS steps from the reference's occupancy x 255 (rounding alone
    stays within half a step); the mesh's vertex count against the
    reference field's edge crossings, relative."""
    ref = ref_occ * 255.0
    return {
        "depth_gap": float((depth - ref_depth).abs().max()),
        "vox_gap": float((vox - ref_vox).abs().max()),
        "field_off": float(((field_u8.float() - ref).abs() > OFF_STEPS).float().mean()),
        "vertex_gap": abs(n_verts / max(crossings((ref + 0.5).floor()), 1) - 1.0),
    }


#: how far, in uint8 steps, a served value may lie from the reference's
#: before field_off counts it: half a step of rounding and 0.05 of error
OFF_STEPS = 0.55


def kept_leaves(ref_grad_norms: dict) -> list:
    """The leaves whose step-1 gradient in the reference is at least a
    thousandth of the median leaf's: the others move by round-off alone."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= 1e-3 * med]


def leaf_gaps(prog: dict, ref: dict, keep: list) -> dict:
    """Each kept leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def leaf_gap(prog: dict, ref: dict, keep: list, over=max) -> float:
    """The worst leaf's gap (over=max) or the median leaf's
    (over=statistics.median)."""
    return over(list(leaf_gaps(prog, ref, keep).values()))


#: what train_numbers compares for every architecture, and what it adds for
#: one with a scaled leaf (named for sigma, the one leaf scaled so far)
TRAIN_NUMBERS = ("loss_gap", "grad_gap", "change_gap", "window_loss_gap", "window_change_gap")
SCALED_NUMBER = "sigma_change_gap"


def train_names(scaled_leaf) -> tuple:
    """The names of train_numbers' gaps for an architecture's scaled leaf."""
    return TRAIN_NUMBERS + ((SCALED_NUMBER,) if scaled_leaf is not None else ())


def train_numbers(prog: dict, ref: dict, window: list, scaled_leaf=None) -> dict:
    """Gaps of a training run's compared steps.  The warm-up's from the
    seeded weights: step 1's loss (relative), and by the median leaf step
    1's gradient norms and the parameters' change after the compared steps
    (the later steps' losses, and the worst leaf's gaps, move with rounding
    alone: see PERF.md).  The window's, each one step from the same state
    (window: [(program's, reference's)], each {"loss", "change_norms"}),
    the worst step's: the loss (relative), the median leaf's change, and,
    where the architecture has a scaled leaf, that leaf's change against
    its own norm."""
    keep = kept_leaves(ref["grad_norms"])
    l_p, l_r = prog["losses"][0], ref["losses"][0]
    out = {
        "loss_gap": abs(l_p - l_r) / abs(l_r),
        "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"], keep, statistics.median),
        "change_gap": leaf_gap(prog["change_norms"], ref["change_norms"], keep, statistics.median),
        "window_loss_gap": max(abs(p["loss"] - r["loss"]) / abs(r["loss"]) for p, r in window),
        "window_change_gap": max(
            leaf_gap(p["change_norms"], r["change_norms"], kept_leaves(r["grad_norms"]),
                     statistics.median) for p, r in window),
    }
    if scaled_leaf is not None:
        out[SCALED_NUMBER] = max(
            abs(p["change_norms"][scaled_leaf] - r["change_norms"][scaled_leaf])
            / r["change_norms"][scaled_leaf] for p, r in window)
    return out
