"""SceneNet with 3DShape2VecSet's occupancy autoencoder in the place of the
projection and the IF-Net: UNetMini depth, back-projection, then a lattice
of the back-projected pixels through Fourier embeddings, a one-head
cross-attention into the latents seeded by the lattice's even rows and
columns, the latents' self-attention blocks, and a one-head cross-attention
from the query points to the latents.  The configuration vecset_ae_d512_m512.

The reference's forward is written here from the published code (Zhang et
al., SIGGRAPH 2023; github.com/1zb/3DShape2VecSet models_ae.py:
AutoEncoder, PointEmbed, Attention, FeedForward / GEGLU, PreNorm), in
float32 with no kernel: attention by explicit matmuls and softmax, the
Fourier basis by products, reading the weights by the port's key names
(the source's module names).  Every dense layer and both attention products
round through the precision's operand() and result(), so the training
control reaches them.  No leaf trains at a scaled learning rate."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.lowp import EXACT, Precision

SCALED_LEAF = None
#: keys of a configuration file that hold widths (and the token counts of
#: the inputs and latents, the state's size), which no cut may change
WIDTHS = ("dim", "heads", "dim_head", "ff_mult", "num_freqs", "queries_dim", "output_dim",
          "num_inputs", "num_latents", "input_lattice", "unet_filters")
P = "vecset"


def check_config(data: dict) -> None:
    """The heads fill the width, the lattice gives the inputs and its even
    rows and columns the latents, which are no more than the inputs; no
    width is cut."""
    if data["heads"] * data["dim_head"] != data["dim"]:
        raise ValueError(f"{data['heads']} heads of {data['dim_head']} are not the width "
                         f"{data['dim']}")
    rows, cols = data["input_lattice"]
    seeds = -(-rows // 2) * -(-cols // 2)
    if (rows * cols, seeds) != (data["num_inputs"], data["num_latents"]):
        raise ValueError(f"a {rows} x {cols} lattice gives {rows * cols} inputs and {seeds} "
                         f"seeds, not {data['num_inputs']} and {data['num_latents']}")
    if data["num_latents"] > data["num_inputs"]:
        raise ValueError(f"{data['num_latents']} latents exceed {data['num_inputs']} inputs")
    cut = sorted(set(data["reduced"]) & set(WIDTHS))
    if cut:
        raise ValueError(f"reduced names widths: {cut}")


def port_config(cfg: dict, **kw):
    """The port's Config for a configuration file; kw (traffic settings)
    override it."""
    from sv3d_tpu_torch.config import Config, VecSetConfig

    vec = VecSetConfig(dim=cfg["dim"], depth=cfg["depth"], heads=cfg["heads"],
                       lattice=tuple(cfg["input_lattice"]))
    base = dict(decoder="vecset", vecset=vec, precision=cfg["precision"],
                scale_factor=int(round(cfg["voxel_size"] / 0.05)), min_z=cfg["min_z"],
                max_z=cfg["max_z"], lr=cfg["lr"])
    return Config(**{**base, **kw})


def check_widths(model, cfg: dict) -> None:
    """Raise unless the port's model has the configuration's widths."""
    from torch import nn

    sd = model.state_dict()
    net = model.vecset
    shape = lambda k: tuple(sd[f"{P}.{k}.weight"].shape)
    attn = lambda k: (shape(f"{k}.fn.to_q"), shape(f"{k}.fn.to_kv"), shape(f"{k}.fn.to_out"))
    blocks = [f"layers.{i}" for i in range(len(net.layers))]
    got = {
        "embed": shape("point_embed.mlp"), "basis": tuple(net.point_embed.basis.shape),
        "basis_saved": f"{P}.point_embed.basis" in sd,
        "encoder": attn("cross_attend_blocks.0"),
        "encoder_heads": net.cross_attend_blocks[0].fn.heads,
        "encoder_ff": (shape("cross_attend_blocks.1.fn.net.0"),
                       shape("cross_attend_blocks.1.fn.net.2")),
        "depth": len(net.layers),
        "blocks": {attn(f"{b}.0") for b in blocks},
        "heads": {net.layers[i][0].fn.heads for i in range(len(net.layers))},
        "ff": {(shape(f"{b}.1.fn.net.0"), shape(f"{b}.1.fn.net.2")) for b in blocks},
        "decoder": attn("decoder_cross_attn"), "decoder_heads": net.decoder_cross_attn.fn.heads,
        "head": shape("to_outputs"),
        "eps": {m.eps for m in net.modules() if isinstance(m, nn.LayerNorm)},
        "inputs": (net.config.lattice, net.config.num_inputs, net.config.num_latents),
        "dims": tuple(model.config.dims),
    }
    d, inner, f = cfg["dim"], cfg["heads"] * cfg["dim_head"], cfg["ff_mult"] * cfg["dim"]
    one_head = ((d, cfg["queries_dim"]), (2 * d, d), (cfg["queries_dim"], d))
    want = {
        "embed": (d, 6 * cfg["num_freqs"] + 3), "basis": (3, 3 * cfg["num_freqs"]),
        "basis_saved": False,
        "encoder": ((d, d), (2 * d, d), (d, d)), "encoder_heads": 1,
        "encoder_ff": ((2 * f, d), (d, f)),
        "depth": cfg["depth"],
        "blocks": {((inner, d), (2 * inner, d), (d, inner))},
        "heads": {cfg["heads"]},
        "ff": {((2 * f, d), (d, f))},
        "decoder": one_head, "decoder_heads": 1,
        "head": (cfg["output_dim"], cfg["queries_dim"]),
        "eps": {cfg["layer_norm_eps"]},
        "inputs": (tuple(cfg["input_lattice"]), cfg["num_inputs"], cfg["num_latents"]),
        "dims": tuple(cfg["dims"]),
    }
    if got != want:
        raise RuntimeError(f"the port's model is not the configuration: "
                           f"{ {k: got[k] for k in got if got[k] != want[k]} }")


def uncounted_flops(cfg: dict, traffic: dict) -> float:
    """0: FlopCounterMode sees every dense layer and conv of the step and
    the attention calls forward and backward (aten's fused attention ops
    carry formulas of their own; step_flops is the same count, made from
    the shapes); LayerNorm, GEGLU, softmax outside a fused call and the
    residuals are left uncounted, as it leaves them."""
    return 0.0


def _linear_flops(rows: float, fan_in: int, fan_out: int) -> float:
    return 2.0 * rows * fan_in * fan_out


def block_flops(cfg: dict) -> dict:
    """One sample's forward operations of the encoder and of one latent
    block, by part: "dense" (the linear layers and the Fourier basis
    product), "attention" (the two products of each attention call).  As
    FlopCounterMode counts them: 2 m k n a product."""
    d, f, nf = cfg["dim"], cfg["ff_mult"] * cfg["dim"], cfg["num_freqs"]
    n, m, inner = cfg["num_inputs"], cfg["num_latents"], cfg["heads"] * cfg["dim_head"]
    ff = lambda rows: _linear_flops(rows, d, 2 * f) + _linear_flops(rows, f, d)
    embed = lambda rows: _linear_flops(rows, 3, 3 * nf) + _linear_flops(rows, 6 * nf + 3, d)
    cross = lambda rows_q, rows_c: (_linear_flops(rows_q, d, d) + _linear_flops(rows_c, d, 2 * d)
                                    + _linear_flops(rows_q, d, d))
    return {
        "encoder": {"dense": embed(n) + cross(m, n) + ff(m), "attention": 4.0 * m * n * d},
        "block": {"dense": _linear_flops(m, d, 3 * inner) + _linear_flops(m, inner, d) + ff(m),
                  "attention": 4.0 * m * m * inner},
    }


def latents_flops(cfg: dict, traffic: dict) -> float:
    """The forward operations of a step's latent blocks (all `depth` of
    them, the batch's samples)."""
    blk = block_flops(cfg)["block"]
    return traffic["batch_size"] * cfg["depth"] * (blk["dense"] + blk["attention"])


def unet_conv_flops(cfg: dict) -> list:
    """One sample's forward operations of each of UNetMini's convs at the
    image size, in order: four 4x4 stride-2 downs, then four 3x3 convs,
    each after a 2x upsampling."""
    w, h = cfg["image_size"]
    nf = cfg["unet_filters"]
    downs = [(3, nf), (nf, 2 * nf), (2 * nf, 4 * nf), (4 * nf, 8 * nf)]
    sames = [(8 * nf, 4 * nf), (8 * nf, 2 * nf), (4 * nf, nf), (2 * nf, 1)]
    out = [2.0 * a * b * 16 * (h >> (i + 1)) * (w >> (i + 1)) for i, (a, b) in enumerate(downs)]
    out += [2.0 * a * b * 9 * (h >> (3 - i)) * (w >> (3 - i)) for i, (a, b) in enumerate(sames)]
    return out


def attention_step_flops(cfg: dict, traffic: dict) -> float:
    """A training step's attention products as FlopCounterMode counts aten's
    fused attention: each call's two forward products and its backward's
    five (the scores recomputed, then the four gradient products)."""
    q, d, m = 2 * traffic["num_points"], cfg["dim"], cfg["num_latents"]
    blocks = block_flops(cfg)
    forward = (blocks["encoder"]["attention"] + cfg["depth"] * blocks["block"]["attention"]
               + 4.0 * q * m * d)
    return traffic["batch_size"] * 3.5 * forward


def step_flops(cfg: dict, traffic: dict) -> float:
    """A training step's operations as FlopCounterMode counts them, from the
    shapes: each dense layer and conv forward, its input gradient where its
    input needs one (not the RGB's, the query points' embedding or the
    Fourier product of the points) and its weight gradient, and the
    attention (attention_step_flops)."""
    q, d, nf, m = 2 * traffic["num_points"], cfg["dim"], cfg["num_freqs"], cfg["num_latents"]
    blocks = block_flops(cfg)
    dense = blocks["encoder"]["dense"] + cfg["depth"] * blocks["block"]["dense"]
    # the cloud's Fourier product: forward and the points' gradient (the
    # basis is a constant)
    basis = _linear_flops(cfg["num_inputs"], 3, 3 * nf)
    decoder = (_linear_flops(q, d, d) + _linear_flops(m, d, 2 * d) + _linear_flops(q, d, d)
               + _linear_flops(q, d, cfg["output_dim"]))
    queries = _linear_flops(q, 3, 3 * nf) + 2.0 * _linear_flops(q, 6 * nf + 3, d)
    unet = unet_conv_flops(cfg)
    per_sample = 3.0 * (dense + decoder) - basis + queries + 3.0 * sum(unet) - unet[0]
    return traffic["batch_size"] * per_sample + attention_step_flops(cfg, traffic)


def _linear(h, sd, name, prec: Precision):
    w = prec.operand(sd[f"{name}.weight"])
    return prec.result(F.linear(prec.operand(h), w, sd.get(f"{name}.bias")))


def _ln(x, sd, name, eps: float):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def _fourier(p, cfg: dict):
    """PE(p)'s input: the points' products with pi 2^k, k < num_freqs, an
    axis at a time (p B with B's zeros left out), their sines and cosines,
    the points."""
    freqs = (math.pi * 2.0 ** torch.arange(cfg["num_freqs"], dtype=torch.float64)).to(p)
    proj = torch.cat([p[..., a:a + 1] * freqs for a in range(3)], dim=-1)
    return torch.cat([proj.sin(), proj.cos(), p], dim=-1)


def _attention(y, c, sd, name, heads: int, prec: Precision):
    """softmax(q k^T / sqrt(dim_head)) v per head, q from y and k, v from c
    (both already normalized), the heads merged and the output layer."""
    q = _linear(y, sd, f"{name}.to_q", prec)
    k, v = _linear(c, sd, f"{name}.to_kv", prec).chunk(2, dim=-1)
    q, k, v = (t.unflatten(-1, (heads, -1)).transpose(1, 2) for t in (q, k, v))
    scores = prec.result(prec.operand(q) @ prec.operand(k).transpose(-1, -2))
    attn = (scores / math.sqrt(q.shape[-1])).softmax(dim=-1)
    out = prec.result(prec.operand(attn) @ prec.operand(v))
    return _linear(out.transpose(1, 2).flatten(2), sd, f"{name}.to_out", prec)


def _ff(y, sd, name, prec: Precision):
    a, g = _linear(y, sd, f"{name}.net.0", prec).chunk(2, dim=-1)
    return _linear(a * F.gelu(g), sd, f"{name}.net.2", prec)


def lattice(cfg: dict) -> tuple:
    """(the inputs' flat pixel indices, the seeds'): the pixel
    (floor(7.5 i + 3.75), 5 j + 2) at 320x240 and a 32 x 64 lattice, row
    i and column j; the seeds those with i and j both even."""
    w, h = cfg["image_size"]
    rows, cols = cfg["input_lattice"]
    r = [(2 * i + 1) * h // (2 * rows) for i in range(rows)]
    c = [(2 * j + 1) * w // (2 * cols) for j in range(cols)]
    inputs = [r[i] * w + c[j] for i in range(rows) for j in range(cols)]
    seeds = [r[i] * w + c[j] for i in range(0, rows, 2) for j in range(0, cols, 2)]
    return inputs, seeds


def occupancy_logits(sd, cfg: dict, cloud, points, prec: Precision = EXACT):
    """The cloud's lattice (B, num_inputs, 3 of the (B, H*W, 3) cloud)
    embedded and cross-attended into the latents seeded by its even rows
    and columns, the latent blocks, the query points (B, N, 3) attending to
    the latents: logits (B, N).  Coordinates doubled onto [-1, 1]."""
    w, h = cfg["image_size"]
    if cloud.shape[1] != w * h:
        raise ValueError(f"a cloud of {cloud.shape[1]} points is not a {w}x{h} image's")
    eps = cfg["layer_norm_eps"]
    inputs, seeds = (torch.as_tensor(i, device=cloud.device) for i in lattice(cfg))
    pe = lambda p: _linear(_fourier(2.0 * p, cfg), sd, f"{P}.point_embed.mlp", prec)
    e, s = pe(cloud[:, inputs]), pe(cloud[:, seeds])
    name = f"{P}.cross_attend_blocks"
    x = _attention(_ln(s, sd, f"{name}.0.norm", eps), _ln(e, sd, f"{name}.0.norm_context", eps),
                   sd, f"{name}.0.fn", 1, prec) + s
    x = _ff(_ln(x, sd, f"{name}.1.norm", eps), sd, f"{name}.1.fn", prec) + x
    for i in range(cfg["depth"]):
        name = f"{P}.layers.{i}"
        y = _ln(x, sd, f"{name}.0.norm", eps)
        x = _attention(y, y, sd, f"{name}.0.fn", cfg["heads"], prec) + x
        x = _ff(_ln(x, sd, f"{name}.1.norm", eps), sd, f"{name}.1.fn", prec) + x
    name = f"{P}.decoder_cross_attn"
    hq = _attention(_ln(pe(points), sd, f"{name}.norm", eps),
                    _ln(x, sd, f"{name}.norm_context", eps), sd, f"{name}.fn", 1, prec)
    return _linear(hq, sd, f"{P}.to_outputs", prec)[..., 0]
