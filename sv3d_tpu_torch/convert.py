"""Convert the JAX package's flax variables into this package's state_dict.

from_flax takes a {"params": ..., "batch_stats": ...} tree of nested dicts of
numpy arrays, for a whole SceneNet or any of its submodules (UNet, UNetMini,
IFNet, Projection), and returns the state_dict of the matching module here.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

# flax module name -> this package's attribute path; None drops the level
_MODULE_RULES = (
    (re.compile(r"_ConvDown_(\d+)"), r"down.\1"),
    (re.compile(r"_ConvSame_(\d+)"), r"same.\1"),
    (re.compile(r"_BN_(\d+)"), r"bn.\1"),
    (re.compile(r"stages_(\d+)"), r"stages.\1"),
)
_LEAF_NAMES = {
    "scale": "weight", "bias": "bias", "mean": "running_mean",
    "var": "running_var", "sigma": "sigma",
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_path(parts) -> list:
    out = []
    for i, name in enumerate(parts):
        parent = parts[i - 1] if i else ""
        for pat, repl in _MODULE_RULES:
            if pat.fullmatch(name):
                out.append(pat.sub(repl, name))
                break
        else:
            if name == "Conv_0" and re.fullmatch(r"_Conv(Down|Same)_\d+", parent):
                continue  # the conv inside a _ConvDown / _ConvSame wrapper
            if name == "BatchNorm_0" and parent.startswith("_BN_"):
                continue  # the BatchNorm inside a _BN wrapper
            m = re.fullmatch(r"Conv_(\d+)", name)
            if m:
                out.append(f"convs.{m.group(1)}")
            elif name == "BatchNorm_0":
                out.append("bn")
            else:
                out.append(name)
    return out


def _leaf(name: str, value: np.ndarray):
    """(torch leaf name, tensor) for one flax leaf."""
    m = re.fullmatch(r"(fc0|fc1|fc2|fc_out)_(kernel|bias)", name)
    if m:  # the point-conv MLP: kernels are already (out, in)
        return f"{m.group(1)}.{'weight' if m.group(2) == 'kernel' else 'bias'}", value
    if name == "kernel":
        if value.ndim == 4:  # HWIO -> OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 5:  # DHWIO -> OIDHW
            return "weight", value.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"unexpected conv kernel rank {value.ndim}")
    if name in _LEAF_NAMES:
        return _LEAF_NAMES[name], value
    raise ValueError(f"unknown flax leaf {name!r}")


def from_flax(variables: dict, dtype=np.float32) -> "OrderedDict[str, torch.Tensor]":
    """flax {"params", "batch_stats"} -> state_dict of dtype tensors (float64
    keeps a float64 tree, such as the gradients of a float64 step, exact).
    BatchNorm layers also get num_batches_tracked = 0."""
    state = OrderedDict()
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name, arr = _leaf(path[-1], value)
            key = ".".join(_module_path(list(path[:-1])) + name.split("."))
            state[key] = torch.tensor(np.asarray(arr, dtype=dtype))
            if key.endswith(".running_mean"):
                state[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return state
