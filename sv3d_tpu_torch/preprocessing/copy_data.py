"""Data staging (port of sv3d_tpu/preprocessing/copy_data.py): collect the
per-view render outputs of a BlenderProc-style tree <src>/<scene>/<view>/
into <datasetdir>/raw/<splitsdir>/<scene>/<view>/, skipping views that lack
one of VIEW_FILES.

    python -m sv3d_tpu_torch.preprocessing.copy_data --src renders \
        --datasetdir data --splitsdir overfit
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

VIEW_FILES = ("rgb.png", "campose.npy", "distance.exr", "distance_field.df")


def copy_data(src_root: str | Path, dst_root: str | Path, splitsdir: str):
    src_root, dst = Path(src_root), Path(dst_root) / "raw" / splitsdir
    copied = []
    for scene in sorted(p for p in src_root.iterdir() if p.is_dir()):
        for view in sorted(p for p in scene.iterdir() if p.is_dir()):
            out = dst / scene.name / view.name
            files = [view / f for f in VIEW_FILES]
            if not all(f.exists() for f in files):
                continue
            out.mkdir(parents=True, exist_ok=True)
            for f in files:
                shutil.copyfile(f, out / f.name)
            copied.append(str(out))
    return copied


def cli_main(argv=None):
    p = argparse.ArgumentParser(description="stage render outputs into data/raw")
    p.add_argument("--src", required=True)
    p.add_argument("--datasetdir", default="data")
    p.add_argument("--splitsdir", required=True)
    a = p.parse_args(argv)
    copied = copy_data(a.src, a.datasetdir, a.splitsdir)
    print(f"copied {len(copied)} views")
    return copied


if __name__ == "__main__":
    cli_main()
