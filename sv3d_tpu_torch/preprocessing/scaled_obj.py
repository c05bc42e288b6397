"""Normalize predicted voxel-space meshes into unit space for evaluation
(port of sv3d_tpu/preprocessing/scaled_obj.py): translate by -dims/2, scale
by 1/dims, write <name>_normed.obj beside each.

    python -m sv3d_tpu_torch.preprocessing.scaled_obj --root runs/x/vis
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from sv3d_tpu_torch.io.mesh import load_obj


def convert_to_scaled_obj(path: str | Path, dims=(139, 104, 112)) -> Path:
    mesh = load_obj(path)
    d = np.asarray(dims, dtype=np.float64)
    mesh.apply_translation(-d / 2).apply_scale(1.0 / d)
    out = Path(str(path)[:-4] + "_normed.obj")
    mesh.export(out)
    return out


def convert_tree(root: str | Path, pattern: str = "*_predicted.obj", dims=(139, 104, 112)):
    return [convert_to_scaled_obj(p, dims) for p in sorted(Path(root).rglob(pattern))]


def cli_main(argv=None):
    p = argparse.ArgumentParser(description="normalize meshes into unit space")
    p.add_argument("--root", required=True)
    p.add_argument("--pattern", default="*_predicted.obj")
    p.add_argument("--dims", nargs=3, type=int, default=[139, 104, 112])
    a = p.parse_args(argv)
    outs = convert_tree(a.root, a.pattern, tuple(a.dims))
    print(f"normalized {len(outs)} meshes")
    return outs


if __name__ == "__main__":
    cli_main()
