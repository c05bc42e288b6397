"""A toy architecture for the harness's tests: no conv pyramid, no decoder
of IF-Net's widths, no scaled leaf.  A query point's logit is an MLP of the
point and the mean of the back-projected cloud.  The port has no such
model, so the two functions that would build and check it raise."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.lowp import EXACT, Precision

SCALED_LEAF = None


def check_config(data: dict) -> None:
    """The MLP takes a point and the cloud's mean (6) and gives one logit,
    through `layers` layers."""
    mlp = data["mlp"]
    if mlp[0] != 6 or mlp[-1] != 1 or len(mlp) != data["layers"] + 1:
        raise ValueError(f"mlp {mlp} is not 6 -> ... -> 1 in {data['layers']} layers")


def port_config(cfg: dict, **kw):
    raise NotImplementedError("the port has no toy_cloud model")


def check_widths(model, cfg: dict) -> None:
    raise NotImplementedError("the port has no toy_cloud model")


def uncounted_flops(cfg: dict, traffic: dict) -> float:
    return 0.0


def occupancy_logits(sd, cfg: dict, cloud, points, prec: Precision = EXACT):
    h = torch.cat([points, cloud.mean(1, keepdim=True).expand(-1, points.shape[1], -1)], -1)
    for i in range(cfg["layers"]):
        w = prec.operand(sd[f"toy.fc{i}.weight"])
        h = prec.result(F.linear(prec.operand(h), w, sd[f"toy.fc{i}.bias"]))
        if i < cfg["layers"] - 1:
            h = F.relu(h)
    return h[..., 0]
