"""The port's measurement tools on the card: the headline benchmark
(headline.py, the port of the JAX package's bench.py; run it as python -m
sv3d_tpu_torch.bench), the train-step and op costs (measure_step.py, the
port of scripts/measure_step.py) and their timing helpers (timing.py)."""

import math


def bad_figures(values, key: str = "", none_ok: bool = False) -> list:
    """The (key, value) pairs of values (a number, or dicts and lists of
    them, walked) that are not finite numbers above 0.  None (a figure that
    only the card gives) counts as bad unless none_ok; booleans and strings
    are not figures."""
    if isinstance(values, dict):
        return [bad for k, v in values.items()
                for bad in bad_figures(v, f"{key}.{k}" if key else str(k), none_ok)]
    if isinstance(values, (list, tuple)):
        return [bad for i, v in enumerate(values)
                for bad in bad_figures(v, f"{key}[{i}]", none_ok)]
    if values is None:
        return [] if none_ok else [(key, None)]
    if isinstance(values, bool) or not isinstance(values, (int, float)):
        return []
    return [] if math.isfinite(values) and values > 0 else [(key, values)]
