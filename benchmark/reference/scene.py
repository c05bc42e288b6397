"""Plain PyTorch reference of SceneNet, the model of both configurations:
UNetMini depth, back-projection into the view frustum's voxel grid,
trilinear scatter and Gaussian blur, the IF-Net conv pyramid, its point
query and its dense-lattice sweep.

Written from the published description (reference repo model/unet.py,
model/projection.py, model/ifnet.py) in float32 with no kernel, cache or
batching of the program, and reading the weights from a state dict by the
checkpoint's key names.  BatchNorm is flax's (batch variance E[x^2] -
E[x]^2 in train mode, the running statistics in eval mode, epsilon 1e-5).
A Precision (lowp.py) names the operands that a control rounds."""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.lowp import EXACT, Precision

BN_EPS = 1e-5


def frustum_transform(cfg: dict, f: float, cx: float, cy: float):
    """The camera -> voxel-grid map of the view frustum: (scale (3,), shift
    (3,)) float32, grid = camera * scale + shift."""
    w, h = cfg["image_size"]
    k = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    corners = np.array([[0, 0, 1, 0], [0, h, 1, 0], [w, h, 1, 0], [w, 0, 1, 0]], np.float64)
    eight = np.concatenate([corners * cfg["depth_min"] + [0, 0, 0, 1.0],
                            corners * cfg["depth_max"] + [0, 0, 0, 1.0]])
    eight[:4, 2] = cfg["depth_min"]
    eight[4:, 2] = cfg["depth_max"]
    cam = (np.linalg.inv(k) @ eight.T).T[:, :3]
    mins = cam.min(axis=0) / cfg["voxel_size"]
    scale = np.full(3, 1.0 / cfg["voxel_size"], np.float32)
    return scale, (-mins).astype(np.float32)


def _bn(x, sd, name, train: bool):
    w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
    shape = [1, -1] + [1] * (x.ndim - 2)
    if train:
        dims = [0] + list(range(2, x.ndim))
        mean = x.double().mean(dims).to(x.dtype)
        ex2 = (x.double() * x.double()).mean(dims).to(x.dtype)
        var = (ex2 - mean * mean).clamp(min=0.0)
    else:
        mean, var = sd[f"{name}.running_mean"], sd[f"{name}.running_var"]
    return (x - mean.view(shape)) * (torch.rsqrt(var + BN_EPS) * w).view(shape) + b.view(shape)


def _conv(fn, x, sd, name, prec: Precision, **kw):
    w = prec.operand(sd[f"{name}.weight"])
    return prec.result(fn(prec.operand(x), w, sd[f"{name}.bias"], **kw))


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def depth(sd, cfg: dict, rgb: torch.Tensor, train: bool, prec: Precision = EXACT):
    """UNetMini: (B, 240, 320, 3) normalized RGB -> (B, 240, 320) depth in
    [min_z, max_z]."""
    x = rgb.permute(0, 3, 1, 2)
    down = lambda i, v: _conv(F.conv2d, v, sd, f"unet.down.{i}", prec, stride=2, padding=1)
    up = lambda i, v: _conv(F.conv2d, _up2(F.relu(v)), sd, f"unet.same.{i}", prec, padding=1)
    bn = lambda i, v: _bn(v, sd, f"unet.bn.{i}", train)
    lrelu = lambda v: F.leaky_relu(v, 0.2)
    e1 = down(0, x)
    e2 = bn(0, down(1, lrelu(e1)))
    e3 = bn(1, down(2, lrelu(e2)))
    e4 = down(3, lrelu(e3))
    d5 = torch.cat([bn(2, up(0, e4)), e3], 1)
    d6 = torch.cat([bn(3, up(1, d5)), e2], 1)
    d7 = torch.cat([bn(4, up(2, d6)), e1], 1)
    logits = up(3, d7)[:, 0]
    return torch.sigmoid(logits) * (cfg["max_z"] - cfg["min_z"]) + cfg["min_z"]


def back_project(d: torch.Tensor, cfg: dict, f, cx, cy, scale, shift):
    """(B, H, W) depth -> (B, H*W, 3) points in normed grid space."""
    b, h, w = d.shape
    u = torch.arange(w, dtype=d.dtype, device=d.device)[None, :]
    v = torch.arange(h, dtype=d.dtype, device=d.device)[:, None]
    cam = torch.stack([(u - cx) * d / f, -((v - cy) * d) / f, d], dim=-1).reshape(b, h * w, 3)
    kw = dict(dtype=d.dtype, device=d.device)
    grid = cam * torch.as_tensor(scale, **kw) + torch.as_tensor(shift, **kw)
    dims = torch.tensor(cfg["dims"], **kw)
    return (grid - dims / 2.0) / dims


def scatter(points: torch.Tensor, dims, eps: float = 1e-6):
    """Trilinear splat of (B, N, 3) normed points into (B, D0, D1, D2),
    clamped to [0, 1], the gradient passing strictly inside (0, 1).  Points
    within eps of the cube's faces are dropped."""
    b = points.shape[0]
    valid = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    base, frac = [], []
    for a, size in enumerate(dims):
        p = points[..., a]
        valid = valid & (p < 0.5 - eps) & (p > -0.5 + eps)
        g = (p + 0.5) * (size - 1.0)
        g0 = torch.floor(g)
        base.append(g0.long())
        frac.append(g - g0)
    n_vox = int(np.prod(dims))
    offset = torch.arange(b, device=points.device)[:, None] * n_vox
    out = torch.zeros(b * n_vox, dtype=points.dtype, device=points.device)
    for corner in itertools.product((0, 1), repeat=3):
        w = torch.ones_like(frac[0])
        lin = torch.zeros_like(base[0])
        for a, c in enumerate(corner):
            w = w * (frac[a] if c else 1.0 - frac[a])
            lin = lin * dims[a] + base[a] + c
        w = torch.where(valid, w, 0.0)
        lin = torch.where(valid, lin, 0) + offset
        out = out.index_add(0, lin.reshape(-1), w.reshape(-1))
    raw = out.reshape(b, *dims)
    inside = (raw > 0.0) & (raw < 1.0)
    return torch.where(inside, raw, raw.detach().clamp(0.0, 1.0))


def blur(vox: torch.Tensor, sigma: torch.Tensor, kernel_size, prec: Precision = EXACT):
    """Separable Gaussian blur of (B, D0, D1, D2), SAME zero padding, one
    learnable sigma per axis, clamped to [0, 1]."""
    x = vox
    for a, k in enumerate(kernel_size):
        if k % 2 != 1:
            raise ValueError("the reference blurs with odd kernel sizes only")
        taps = torch.arange(-(k // 2), k // 2 + 1, dtype=x.dtype, device=x.device)
        kern = torch.exp(-(taps ** 2) / (2.0 * sigma[a] ** 2))
        kern = prec.operand(kern / kern.sum())
        x = prec.operand(x)
        dim = a + 1
        pad = [0, 0] * (3 - a - 1) + [k // 2, k // 2]
        xp = F.pad(x, pad)
        x = prec.result(sum(kern[t] * xp.narrow(dim, t, x.shape[dim]) for t in range(k)))
    return x.clamp(0.0, 1.0)


def voxelize(points, sd, cfg: dict, prec: Precision = EXACT):
    return blur(scatter(points, cfg["dims"]), sd["project.sigma"], cfg["kernel_size"], prec)


def encode(sd, cfg: dict, grid: torch.Tensor, train: bool, prec: Precision = EXACT) -> list:
    """IF-Net conv pyramid: (B, D0, D1, D2) -> levels [(B, C, g0, g1, g2)],
    level 0 the input grid, then each stage's output before its 2x max-pool."""
    x = grid[:, None]
    levels = [x]
    stages = cfg["stages"]
    for i, convs in enumerate(stages):
        for j in range(len(convs)):
            x = F.relu(_conv(F.conv3d, x, sd, f"ifnet.stages.{i}.convs.{j}", prec, padding=1))
        x = _bn(x, sd, f"ifnet.stages.{i}.bn", train)
        levels.append(x)
        if i < len(stages) - 1:
            if min(x.shape[2:]) == 1:
                # a size-1 axis pools to 1, not 0 (the -inf pad of the source)
                pad = []
                for size in reversed(x.shape[2:]):
                    pad += [0, int(size == 1)]
                x = F.pad(x, pad, value=float("-inf"))
            x = F.max_pool3d(x, 2, 2)
    return levels


def _taps(coord: torch.Tensor, size: int, align_corners: bool):
    ix = (coord + 1.0) * 0.5 * (size - 1.0) if align_corners else ((coord + 1.0) * size - 1.0) * 0.5
    i0 = torch.floor(ix)
    return i0.long(), ix - i0


def _sample(vol: torch.Tensor, q, align_corners: bool):
    """Trilinear sample of (B, C, g0, g1, g2) at coordinates q (three (B, M)
    in [-1, 1]), zero outside: (B, C, M)."""
    b, c = vol.shape[:2]
    g = vol.shape[2:]
    flat = vol.reshape(b, c, -1)
    taps = [_taps(q[a], g[a], align_corners) for a in range(3)]
    out = 0.0
    for corner in itertools.product((0, 1), repeat=3):
        w = torch.ones_like(q[0])
        lin = torch.zeros_like(taps[0][0])
        ok = torch.ones_like(q[0], dtype=torch.bool)
        for a, cc in enumerate(corner):
            i, f = taps[a]
            ia = i + cc
            ok = ok & (ia >= 0) & (ia < g[a])
            w = w * (f if cc else 1.0 - f)
            lin = lin * g[a] + ia.clamp(0, g[a] - 1)
        w = torch.where(ok, w, 0.0)
        vals = torch.gather(flat, 2, lin[:, None, :].expand(b, c, lin.shape[1]))
        out = out + w[:, None, :] * vals
    return out


def _dense(h, sd, name, prec: Precision):
    w = prec.operand(sd[f"{name}.weight"])
    return prec.result(F.linear(prec.operand(h), w, sd[f"{name}.bias"]))


def query(sd, cfg: dict, levels: list, points: torch.Tensor, prec: Precision = EXACT):
    """Occupancy logits (B, N) of the IF-Net at (B, N, 3) normed points."""
    b, n, _ = points.shape
    d = cfg["displacement"]
    shifts = [(0, 0.0), (0, -d), (0, d), (1, -d), (1, d), (2, -d), (2, d)]
    q = [torch.cat([2.0 * points[..., a] + (s if ax == a else 0.0) for ax, s in shifts], 1)
         for a in range(3)]
    feats = torch.cat([_sample(v, q, cfg["align_corners"]) for v in levels], 1)
    feats = feats.reshape(b, feats.shape[1], 7, n).permute(0, 3, 2, 1).reshape(b, n, -1)
    h = F.relu(_dense(feats, sd, "ifnet.fc0", prec))
    h = F.relu(_dense(h, sd, "ifnet.fc1", prec))
    h = F.relu(_dense(h, sd, "ifnet.fc2", prec))
    return _dense(h, sd, "ifnet.fc_out", prec)[..., 0]


def _axis_matrix(r: int, g: int, shift: float, align_corners: bool) -> np.ndarray:
    """(r, g) 2-tap interpolation matrix of one lattice axis: linspace(-0.5,
    0.5, r) doubled into [-1, 1], shifted, zero weight outside the grid."""
    x = 2.0 * np.linspace(-0.5, 0.5, r) + shift
    ix = (x + 1.0) * 0.5 * (g - 1.0) if align_corners else ((x + 1.0) * g - 1.0) * 0.5
    i0 = np.floor(ix)
    f = ix - i0
    m = np.zeros((r, g))
    rows = np.arange(r)
    for idx, w in ((i0, 1.0 - f), (i0 + 1.0, f)):
        ok = (idx >= 0) & (idx < g)
        m[rows[ok], idx[ok].astype(int)] += w[ok]
    return m


def lattice_occupancy(sd, cfg: dict, levels: list, r, prec: Precision = EXACT,
                      block_bytes: float = 1e9) -> torch.Tensor:
    """Sigmoid occupancy (r0, r1, r2) of the IF-Net on the dense lattice over
    [-0.5, 0.5]^3 (batch 1), in blocks of axis-0 rows whose feature matrix
    stays under block_bytes.  prec.sweep rounds the levels, each block's
    features, the four weights and each hidden activation."""
    return torch.sigmoid(lattice_logits(sd, cfg, levels, r, prec, block_bytes))


def lattice_logits(sd, cfg: dict, levels: list, r, prec: Precision = EXACT,
                   block_bytes: float = 1e9) -> torch.Tensor:
    """The IF-Net's logits on the dense lattice (lattice_occupancy before its
    sigmoid)."""
    dev, dt = levels[0].device, levels[0].dtype
    d = cfg["displacement"]
    ac = cfg["align_corners"]
    vols = [prec.sweep(v[0]) for v in levels]
    mats = [[[torch.tensor(_axis_matrix(r[a], v.shape[1 + a], s, ac), dtype=dt, device=dev)
              for s in (0.0, -d, d)] for a in range(3)] for v in vols]
    layers = [(prec.sweep(sd[f"ifnet.{n}.weight"]), sd[f"ifnet.{n}.bias"])
              for n in ("fc0", "fc1", "fc2", "fc_out")]
    n_feat = layers[0][0].shape[1]
    rows = max(1, int(block_bytes // (4 * n_feat * r[1] * r[2])))
    out = torch.empty(tuple(r), dtype=dt, device=dev)
    for lo in range(0, r[0], rows):
        hi = min(lo + rows, r[0])
        per_d = [[] for _ in range(7)]
        for v, ((c0, m0, p0), (c1, m1, p1), (c2, m2, p2)) in zip(vols, mats):
            a0 = lambda m: torch.einsum("ai,cijk->cajk", m[lo:hi], v)
            a1 = lambda m, t: torch.einsum("xj,cajk->caxk", m, t)
            a2 = lambda m, t: torch.einsum("yk,caxk->caxy", m, t)
            t0 = a0(c0)
            t01 = a1(c1, t0)
            variants = [a2(c2, t01), a2(c2, a1(c1, a0(m0))), a2(c2, a1(c1, a0(p0))),
                        a2(c2, a1(m1, t0)), a2(c2, a1(p1, t0)), a2(m2, t01), a2(p2, t01)]
            for k, t in enumerate(variants):
                per_d[k].append(t.reshape(t.shape[0], -1))
        h = prec.sweep(torch.cat([x for fd in per_d for x in fd], 0))
        del per_d
        for i, (w, b) in enumerate(layers):
            h = w @ h + b[:, None]
            if i < 3:
                h = prec.sweep(F.relu(h))
        out[lo:hi] = h[0].reshape(hi - lo, r[1], r[2])
    return out
