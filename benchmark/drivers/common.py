"""What the drivers share: the port's Config for a configuration file, and
a check that the port built the configuration's widths."""

from __future__ import annotations


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
