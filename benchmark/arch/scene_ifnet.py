"""SceneNet with an IF-Net decoder: UNetMini depth, back-projection, K1's
trilinear scatter and the Gaussian blur of the projection (its sigma the one
leaf at a higher learning rate), the IF-Net conv pyramid and its point
query.  The configurations sv3d128 and sv3d32."""

from __future__ import annotations

from benchmark.frozen import bounds, scenes
from benchmark.reference import scene
from benchmark.reference.lowp import EXACT, Precision

#: the projection's Gaussian width, trained at project_lr_scale x lr
SCALED_LEAF = "project.sigma"
#: keys of a configuration file that hold widths, which no cut may change
WIDTHS = ("stages", "decoder", "hidden_dim", "unet_filters")


def check_config(data: dict) -> None:
    """The decoder takes the seven displaced samples of every level: its input
    is 7 x the channels summed over the input grid (1) and each stage."""
    chans = [1] + [s[-1] for s in data["stages"]]
    if data["decoder"][0] != 7 * sum(chans):
        raise ValueError(f"decoder input {data['decoder'][0]} is not 7 x {sum(chans)}, the "
                         f"channels of the input grid and the stages {data['stages']}")
    cut = sorted(set(data["reduced"]) & set(WIDTHS))
    if cut:
        raise ValueError(f"reduced names widths: {cut}")


def port_config(cfg: dict, **kw):
    """The port's Config for a configuration file; kw (traffic settings)
    override it."""
    from sv3d_tpu_torch.config import Config

    base = dict(net_res=cfg["net_res"], precision=cfg["precision"],
                scale_factor=int(round(cfg["voxel_size"] / 0.05)),
                kernel_size=cfg["kernel_size"], sigma=cfg["sigma"], min_z=cfg["min_z"],
                max_z=cfg["max_z"], lr=cfg["lr"])
    return Config(**{**base, **kw})


def check_widths(model, cfg: dict) -> None:
    """Raise unless the port's model has the configuration's widths."""
    sd = model.state_dict()
    dec = cfg["decoder"]
    got = [tuple(sd[f"ifnet.{n}.weight"].shape) for n in ("fc0", "fc1", "fc2", "fc_out")]
    want = [(b, a) for a, b in zip(dec[:-1], dec[1:])]
    stages = [[tuple(sd[f"ifnet.stages.{i}.convs.{j}.weight"].shape)[0] for j in range(len(s))]
              for i, s in enumerate(cfg["stages"])]
    if got != want or stages != cfg["stages"] or tuple(model.config.dims) != tuple(cfg["dims"]):
        raise RuntimeError(f"the port's model is not the configuration: decoder {got}, "
                           f"stages {stages}, dims {model.config.dims}")


def uncounted_flops(cfg: dict, traffic: dict) -> float:
    """K1's and K1b's operations over a step's projected points, one a pixel
    of each image of the batch."""
    points = traffic["batch_size"] * scenes.W * scenes.H
    return (bounds.K1_FLOPS_PER_POINT + bounds.K1B_FLOPS_PER_POINT) * points


def occupancy_logits(sd, cfg: dict, cloud, points, prec: Precision = EXACT):
    """Voxelize the cloud, encode the grid in train mode, query the points."""
    levels = scene.encode(sd, cfg, scene.voxelize(cloud, sd, cfg, prec), True, prec)
    return scene.query(sd, cfg, levels, points, prec)
