"""The architectures of the benchmark's configurations, one file each.

A configuration file names its architecture (`"arch"`), and the harness
takes everything that is particular to it from benchmark/arch/<arch>.py,
found by that name as drivers and metric readers are.  Such a file gives:

- SCALED_LEAF: the one parameter that trains at the configuration's
  `project_lr_scale` times the learning rate, or None where none does;
- check_config(data): raise ValueError unless a configuration file's
  widths keep to the architecture's own rule;
- port_config(cfg, **kw): the port's Config for a configuration file, kw
  (traffic settings) overriding it;
- check_widths(model, cfg): raise unless the port built the configuration;
- uncounted_flops(cfg, traffic): the operations of one training step that
  FlopCounterMode cannot see (hand-written kernels);
- occupancy_logits(sd, cfg, cloud, points, prec): the plain reference's
  occupancy forward in train mode, from the back-projected cloud (B, H*W, 3)
  and the query points (B, N, 3) to the logits (B, N).

Only port_config and check_widths touch the port, and import it inside
themselves: the reference reaches this file too, and imports nothing of the
program."""

from __future__ import annotations

import importlib
import re
from pathlib import Path

DIR = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}")
REQUIRED = ("SCALED_LEAF", "check_config", "port_config", "check_widths", "uncounted_flops",
            "occupancy_logits")


def load(name: str):
    """benchmark/arch/<name>.py, the architecture a configuration names."""
    if not isinstance(name, str) or not NAME.fullmatch(name) or not (DIR / f"{name}.py").is_file():
        raise ValueError(f"unknown architecture {name!r}: a configuration's \"arch\" names a "
                         f"file benchmark/arch/<arch>.py")
    mod = importlib.import_module(f"{__name__}.{name}")
    missing = [k for k in REQUIRED if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"architecture {name!r} lacks {', '.join(missing)}")
    return mod
