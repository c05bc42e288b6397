"""SceneNet with Convolutional Occupancy Networks' grid decoder in the place
of the projection and the IF-Net: UNetMini depth, back-projection, then the
back-projected cloud through a local-pool PointNet into a 64^3 feature grid,
a 3D U-Net over it, and a ResNet decoder of the features sampled at the
query points.  The configuration convonet_grid64.

The reference's forward is written here from the published description
(Peng et al., ECCV 2020; github.com/autonomousvision/
convolutional_occupancy_networks: configs/pointcloud/room_grid64.yaml,
src/encoder/pointnet.py::LocalPoolPointnet, src/encoder/unet3d.py::UNet3D,
src/conv_onet/models/decoder.py::LocalDecoder, src/layers.py::ResnetBlockFC,
src/common.py::normalize_3d_coordinate and coordinate2index), in float32
with no kernel, channel-major as the source lays its features out, the
trilinear sample by gathers, and reading the weights by the port's key
names.  No leaf trains at a scaled learning rate."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.frozen import bounds
from benchmark.reference.lowp import EXACT, Precision

SCALED_LEAF = None
#: keys of a configuration file that hold widths, which no cut may change
WIDTHS = ("hidden_dim", "c_dim", "grid_resolution", "unet3d_f_maps", "unet3d_num_groups",
          "unet3d_in_channels", "unet3d_out_channels", "unet_filters")
#: the source's margin inside the unit cube's faces (its 10e-4) and GroupNorm's epsilon
EDGE, GN_EPS = 1e-3, 1e-5
P = "convonet"


def check_config(data: dict) -> None:
    """The U-Net takes the encoder's c_dim channels and gives the decoder as
    many; no width is cut."""
    widths = (data["c_dim"], data["unet3d_in_channels"], data["unet3d_out_channels"])
    if len(set(widths)) != 1:
        raise ValueError(f"c_dim {data['c_dim']}, the U-Net's in and out channels "
                         f"{widths[1:]}: the encoder's, the U-Net's and the decoder's widths "
                         f"must agree")
    cut = sorted(set(data["reduced"]) & set(WIDTHS))
    if cut:
        raise ValueError(f"reduced names widths: {cut}")


def port_config(cfg: dict, **kw):
    """The port's Config for a configuration file; kw (traffic settings)
    override it."""
    from sv3d_tpu_torch.config import Config, ConvONetConfig

    conv = ConvONetConfig(grid=cfg["grid_resolution"], unet_levels=cfg["unet3d_num_levels"],
                          unet_fmaps=cfg["unet3d_f_maps"])
    base = dict(decoder="convonet_grid", convonet=conv, precision=cfg["precision"],
                scale_factor=int(round(cfg["voxel_size"] / 0.05)), min_z=cfg["min_z"],
                max_z=cfg["max_z"], lr=cfg["lr"])
    return Config(**{**base, **kw})


def unet_convs(cfg: dict) -> list:
    """(in, out, grid side) of the U-Net's 3x3x3 convs, in order: two a
    level down (the first to max(out / 2, in)), two a level up (in ->
    out, out -> out)."""
    side, fmaps = cfg["grid_resolution"], _fmaps(cfg)
    chans = [cfg["unet3d_in_channels"], *fmaps]
    out = []
    for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
        mid = max(b // 2, a)
        out += [(a, mid, side >> i), (mid, b, side >> i)]
    rev = list(reversed(fmaps))
    for i, (a, b) in enumerate(zip(rev[:-1], rev[1:])):
        s = side >> (len(fmaps) - 2 - i)
        out += [(a + b, b, s), (b, b, s)]
    return out


def check_widths(model, cfg: dict) -> None:
    """Raise unless the port's model has the configuration's widths."""
    from sv3d_tpu_torch.models import convonet

    sd = model.state_dict()
    net = model.convonet
    h, c = cfg["hidden_dim"], cfg["c_dim"]
    got = {
        "fc_pos": tuple(sd[f"{P}.encoder.fc_pos.weight"].shape),
        "fc_c": tuple(sd[f"{P}.encoder.fc_c.weight"].shape),
        "encoder_blocks": len(net.encoder.blocks), "decoder_blocks": len(net.decoder.blocks),
        "decoder_fc_c": tuple(sd[f"{P}.decoder.fc_c.0.weight"].shape),
        "unet": [tuple(m.conv.weight.shape[:2]) for lv in (*net.unet3d.encoders,
                                                           *net.unet3d.decoders) for m in lv],
        "groups": {m.norm.num_groups for lv in net.unet3d.encoders for m in lv},
        "final": tuple(sd[f"{P}.unet3d.final_conv.weight"].shape[:2]),
        "grid": net.config.grid, "padding": convonet.PADDING,
        "dims": tuple(model.config.dims),
    }
    want = {
        "fc_pos": (2 * h, 3), "fc_c": (c, h), "encoder_blocks": cfg["encoder_blocks"],
        "decoder_blocks": cfg["decoder_blocks"], "decoder_fc_c": (h, c),
        "unet": [(b, a) for a, b, _ in unet_convs(cfg)],
        "groups": {cfg["unet3d_num_groups"]},
        "final": (cfg["unet3d_out_channels"], cfg["unet3d_f_maps"]),
        "grid": cfg["grid_resolution"], "padding": cfg["padding"], "dims": tuple(cfg["dims"]),
    }
    if got != want:
        raise RuntimeError(f"the port's model is not the configuration: "
                           f"{ {k: got[k] for k in got if got[k] != want[k]} }")


def uncounted_flops(cfg: dict, traffic: dict) -> float:
    """0: FlopCounterMode sees every conv and linear of the step, the wgrad
    kernel's through its registered formula, and the port has no other
    kernel here (the pools, scatters and the trilinear sample are aten's
    and, like the IF-Net's gather query, left uncounted)."""
    return 0.0


def wgrad_bound_s(cfg: dict, traffic: dict) -> float:
    """The least seconds a step's U-Net weight gradients take on the card:
    over the 3x3x3 convs, the larger of their bytes (x and dy read once,
    the gradient written once, f32) over the bandwidth and 2 Cout Cin 27
    B V operations over the f32 peak."""
    b = traffic["batch_size"]
    total = 0.0
    for cin, cout, side in unet_convs(cfg):
        v = b * side ** 3
        n_bytes = 4.0 * (v * (cin + cout) + 27 * cin * cout)
        flops = 2.0 * 27 * cin * cout * v
        total += max(n_bytes / bounds.PEAK_BYTES_PER_S, flops / bounds.PEAK_F32_FLOPS)
    return total


def _fmaps(cfg: dict) -> list:
    return [cfg["unet3d_f_maps"] * 2 ** i for i in range(cfg["unet3d_num_levels"])]


def _linear(h, sd, name, prec: Precision):
    w = prec.operand(sd[f"{name}.weight"])
    return prec.result(F.linear(prec.operand(h), w, sd.get(f"{name}.bias")))


def _resnet_block(x, sd, name, prec: Precision):
    dx = _linear(F.relu(_linear(F.relu(x), sd, f"{name}.fc_0", prec)), sd, f"{name}.fc_1", prec)
    xs = _linear(x, sd, f"{name}.shortcut", prec) if f"{name}.shortcut.weight" in sd else x
    return xs + dx


def _normalize(p, padding: float):
    n = p / (1.0 + padding + EDGE) + 0.5
    n = torch.where(n >= 1.0, torch.full_like(n, 1.0 - EDGE), n)
    return torch.where(n < 0.0, torch.zeros_like(n), n)


def _cells(n, g: int):
    c = torch.floor(n * g).long()
    return c[..., 0] + g * (c[..., 1] + g * c[..., 2])


def _gcr(x, sd, name, groups: int, prec: Precision):
    cin = x.shape[1]
    x = F.group_norm(x, groups if cin >= groups else 1, sd[f"{name}.norm.weight"],
                     sd[f"{name}.norm.bias"], GN_EPS)
    w = prec.operand(sd[f"{name}.conv.weight"])
    return F.relu(prec.result(F.conv3d(prec.operand(x), w, None, padding=1)))


def _unet3d(x, sd, cfg: dict, prec: Precision):
    groups, levels = cfg["unet3d_num_groups"], cfg["unet3d_num_levels"]
    skips = []
    for i in range(levels):
        if i:
            x = F.max_pool3d(x, 2)
        for j in range(2):
            x = _gcr(x, sd, f"{P}.unet3d.encoders.{i}.{j}", groups, prec)
        skips.append(x)
    for i, skip in enumerate(reversed(skips[:-1])):
        x = torch.cat([skip, F.interpolate(x, size=skip.shape[2:], mode="nearest")], 1)
        for j in range(2):
            x = _gcr(x, sd, f"{P}.unet3d.decoders.{i}.{j}", groups, prec)
    w = prec.operand(sd[f"{P}.unet3d.final_conv.weight"])
    return prec.result(F.conv3d(prec.operand(x), w, sd[f"{P}.unet3d.final_conv.bias"]))


def _sample(grid, n):
    """Trilinear sample of (B, C, g, g, g), laid out (z, y, x), at the
    normalized points n (B, N, 3) in [0, 1]: grid_sample's bilinear mode
    with align_corners (a point at n * (g - 1) cells) and border padding.
    (B, N, C)."""
    b, c, g = grid.shape[:3]
    flat = grid.reshape(b, c, g ** 3)
    ix = (n * (g - 1)).clamp(0.0, g - 1.0)
    i0 = torch.floor(ix).long().clamp(max=g - 1)
    f = ix - i0
    out = 0.0
    for corner in range(8):
        w = torch.ones_like(f[..., 0])
        lin = torch.zeros_like(i0[..., 0])
        for a in (2, 1, 0):
            up = (corner >> a) & 1
            w = w * (f[..., a] if up else 1.0 - f[..., a])
            lin = lin * g + (i0[..., a] + up).clamp(max=g - 1)
        vals = torch.gather(flat, 2, lin[:, None, :].expand(b, c, lin.shape[1]))
        out = out + w[:, None, :] * vals
    return out.transpose(1, 2)


def occupancy_logits(sd, cfg: dict, cloud, points, prec: Precision = EXACT):
    """The cloud (B, M, 3) encoded into the grid (the features of the
    points of a cell max-pooled between blocks, then their mean a cell), the
    U-Net, the decoder at the points (B, N, 3): logits (B, N)."""
    g, pad = cfg["grid_resolution"], cfg["padding"]
    cells = g ** 3
    b, m, _ = cloud.shape
    index = _cells(_normalize(cloud.detach(), pad), g)[:, None, :]
    net = _resnet_block(_linear(cloud, sd, f"{P}.encoder.fc_pos", prec), sd,
                        f"{P}.encoder.blocks.0", prec)
    for i in range(1, cfg["encoder_blocks"]):
        src = net.transpose(1, 2)
        idx = index.expand_as(src)
        table = src.new_zeros(b, src.shape[1], cells).scatter_reduce(2, idx, src, "amax",
                                                                     include_self=False)
        pooled = table.gather(2, idx).transpose(1, 2)
        net = _resnet_block(torch.cat([net, pooled], 2), sd, f"{P}.encoder.blocks.{i}", prec)
    c = _linear(net, sd, f"{P}.encoder.fc_c", prec).transpose(1, 2)
    idx = index.expand_as(c)
    sums = c.new_zeros(b, c.shape[1], cells).scatter_add(2, idx, c)
    counts = c.new_zeros(b, 1, cells).scatter_add(2, index, torch.ones_like(c[:, :1]))
    grid = (sums / counts.clamp(min=1.0)).reshape(b, c.shape[1], g, g, g)
    grid = _unet3d(grid, sd, cfg, prec)
    feats = _sample(grid, _normalize(points, pad))
    net = _linear(points, sd, f"{P}.decoder.fc_p", prec)
    for i in range(cfg["decoder_blocks"]):
        net = _resnet_block(net + _linear(feats, sd, f"{P}.decoder.fc_c.{i}", prec), sd,
                            f"{P}.decoder.blocks.{i}", prec)
    return _linear(F.relu(net), sd, f"{P}.decoder.fc_out", prec)[..., 0]
