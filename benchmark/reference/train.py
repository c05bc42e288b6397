"""Plain PyTorch reference of the end-to-end training step: its batches
worked out from the benchmark's rooms by the loader's documented rule, the
UNetMini depth and back-projection in train mode (reference/scene.py),
the architecture's occupancy forward (benchmark/arch/<arch>.py), BCE over
the query points plus the depth MSE, autograd, and Adam with the
architecture's scaled leaf, if any, at a higher learning rate."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import arch
from benchmark.reference import scene
from benchmark.reference.lowp import EXACT, Precision

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def is_parameter(name: str) -> bool:
    return name.rsplit(".", 1)[-1] not in BUFFERS


def _rng(*words) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(w) for w in words]))


def batch_at(rooms: dict, seed: int, batch_size: int, num_points: int, focal: float,
             step: int) -> dict:
    """The batch of training step `step` (counted from 0 over the epochs), as
    the loader defines it with drop_last: len(rooms) // batch_size batches an
    epoch, the split's order shuffled by SeedSequence([seed, epoch]), each
    row's supervision points drawn with replacement per sigma by
    SeedSequence([seed, epoch, row index]); RGB scaled to [-1, 1]; depth the
    planar depth of the rendered distances (integer half-size centre).
    rooms: {name: (rgb uint8, distance, [(points, occupancies)] per sigma)}
    in split order."""
    names = list(rooms)
    s = seed & 0x7FFFFFFF
    epoch, b = divmod(step, len(names) // batch_size)
    order = np.arange(len(names))
    _rng(s, epoch).shuffle(order)
    rgb, dep, pts, occ = [], [], [], []
    for idx in order[b * batch_size:(b + 1) * batch_size]:
        image, distance, sets = rooms[names[idx]]
        rng = _rng(s, epoch, idx)
        sel = [rng.integers(0, p.shape[0], num_points) for p, _ in sets]
        pts.append(np.concatenate([p[i] for (p, _), i in zip(sets, sel)]))
        occ.append(np.concatenate([o[i] for (_, o), i in zip(sets, sel)]))
        rgb.append(((image.astype(np.float32) / 255.0) - 0.5) / 0.5)
        h, w = distance.shape
        rr = ((np.arange(h) - h // 2)[:, None] ** 2 + (np.arange(w) - w // 2)[None] ** 2)
        dep.append(np.sqrt(distance.astype(np.float64) ** 2 / (rr / focal ** 2 + 1.0)))
    return {"rgb": np.stack(rgb), "depth": np.stack(dep).astype(np.float32),
            "points": np.stack(pts), "occupancies": np.stack(occ)}


def batches(rooms: dict, seed: int, batch_size: int, num_points: int, focal: float,
            steps: int) -> list:
    """The batches of the first `steps` training steps (batch_at)."""
    return [batch_at(rooms, seed, batch_size, num_points, focal, g) for g in range(steps)]


def loss(sd: dict, cfg: dict, batch: dict, cam: tuple, prec: Precision = EXACT):
    """Mean BCE-with-logits over the supervision points plus the mean squared
    depth error, for one batch of device tensors."""
    f, cx, cy, scale, shift = cam
    d = scene.depth(sd, cfg, batch["rgb"], True, prec)
    cloud = scene.back_project(d, cfg, f, cx, cy, scale, shift)
    logits = arch.load(cfg["arch"]).occupancy_logits(sd, cfg, cloud, batch["points"], prec)
    ce = F.binary_cross_entropy_with_logits(logits, batch["occupancies"])
    return ce + torch.mean((d - batch["depth"]) ** 2)


def _optimizer(params: dict, cfg: dict, project_lr_scale=None, state=None):
    """Adam over params by name, the architecture's scaled leaf, if any, at
    project_lr_scale (the configuration's by default) times the learning
    rate; state: Adam's moments and step count by parameter name to start
    from."""
    scaled = arch.load(cfg["arch"]).SCALED_LEAF
    groups = [{"params": [p for k, p in params.items() if k != scaled], "lr": cfg["lr"]}]
    if scaled is not None:
        scale = cfg["project_lr_scale"] if project_lr_scale is None else project_lr_scale
        groups.append({"params": [params[scaled]], "lr": cfg["lr"] * scale})
    opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    for k, p in params.items():
        if state and k in state:
            opt.state[p] = {n: v.detach().clone() for n, v in state[k].items()}
    return opt


def _step(sd: dict, params: dict, opt, cfg: dict, hb: dict, cam: tuple, device,
          prec: Precision, rows) -> tuple:
    """One Adam step on a host batch: (its loss, each leaf's gradient norm)."""
    sel = slice(None) if rows is None else rows
    batch = {k: torch.as_tensor(v[sel], device=device) for k, v in hb.items()}
    opt.zero_grad(set_to_none=True)
    value = loss(sd, cfg, batch, cam, prec)
    value.backward()
    grads = {k: float(p.grad.norm()) if p.grad is not None else 0.0 for k, p in params.items()}
    opt.step()
    return float(value.detach()), grads


def _leaves(sd0: dict, device) -> tuple:
    sd = {k: v.detach().to(device).clone() for k, v in sd0.items()}
    return sd, {k: v.requires_grad_(True) for k, v in sd.items() if is_parameter(k)}


def run(sd0: dict, cfg: dict, host_batches: list, cam: tuple, device,
        prec: Precision = EXACT, rows=None, project_lr_scale=None) -> dict:
    """Adam steps from the state dict sd0, one a batch: {"losses": [...],
    "grad_norms": {leaf: norm of step 1's gradient}, "change_norms": {leaf:
    norm of the parameters' change after the last step}}.  rows: a slice of
    each batch's rows to train on instead of all of them (a fault);
    project_lr_scale: the scaled leaf's learning-rate scale instead of the
    configuration's (a fault)."""
    sd, params = _leaves(sd0, device)
    opt = _optimizer(params, cfg, project_lr_scale)
    losses, grad_norms = [], {}
    for i, hb in enumerate(host_batches):
        value, grads = _step(sd, params, opt, cfg, hb, cam, device, prec, rows)
        losses.append(value)
        if i == 0:
            grad_norms = grads
    change = {k: float((p.detach() - sd0[k].to(device)).norm()) for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def step_from(sd: dict, adam: dict, cfg: dict, hb: dict, cam: tuple, device,
              prec: Precision = EXACT, rows=None, project_lr_scale=None) -> dict:
    """One Adam step from a given training state (sd: parameters and buffers
    by name; adam: Adam's moments and step count by parameter name), as
    run() takes it: {"loss", "grad_norms", "change_norms"} of that step."""
    sd1, params = _leaves(sd, device)
    opt = _optimizer(params, cfg, project_lr_scale, adam)
    value, grads = _step(sd1, params, opt, cfg, hb, cam, device, prec, rows)
    change = {k: float((p.detach() - sd[k].to(device)).norm()) for k, p in params.items()}
    return {"loss": value, "grad_norms": grads, "change_norms": change}
