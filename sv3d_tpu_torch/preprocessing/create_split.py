"""Split file creation (port of sv3d_tpu/preprocessing/create_split.py):
percentage train/val/test splits, either of zero-padded sample ids or of a
<scene>/<view> directory tree, shuffled with a seed and optionally
subsampled.

    python -m sv3d_tpu_torch.preprocessing.create_split --datasetdir data \
        --rawdir data/raw/overfit --splitsdir overfit
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from sv3d_tpu_torch.data.splits import write_split


def create_split_from_count(
    datasetdir: str | Path,
    splitsdir: str,
    n_samples: int,
    train_frac: float = 0.8,
    val_frac: float = 0.1,
    pad: int = 5,
):
    ids = [str(i).zfill(pad) for i in range(n_samples)]
    n_train = int(n_samples * train_frac)
    n_val = int(n_samples * val_frac)
    write_split(datasetdir, splitsdir, "train", ids[:n_train])
    write_split(datasetdir, splitsdir, "val", ids[n_train : n_train + n_val])
    write_split(datasetdir, splitsdir, "test", ids[n_train + n_val :])
    # the subsets that validation visualizes
    write_split(datasetdir, splitsdir, "train_vis", ids[: min(4, n_train)])
    write_split(datasetdir, splitsdir, "val_vis", ids[n_train : n_train + min(4, n_val)])


def create_split_from_tree(
    datasetdir: str | Path,
    rawdir: str | Path,
    splitsdir: str,
    train_frac: float = 0.8,
    val_frac: float = 0.1,
    subsample: int | None = None,
    seed: int = 0,
):
    """Walk rawdir/<scene>/<view> and write 'scene/view' split entries,
    shuffled by random.Random(seed).  Returns the shuffled entries."""
    root = Path(rawdir)
    items = sorted(
        f"{scene.name}/{view.name}"
        for scene in root.iterdir() if scene.is_dir()
        for view in scene.iterdir() if view.is_dir()
    )
    rng = random.Random(seed)
    rng.shuffle(items)
    if subsample:
        items = items[:subsample]
    n = len(items)
    n_train, n_val = int(n * train_frac), int(n * val_frac)
    write_split(datasetdir, splitsdir, "train", items[:n_train])
    write_split(datasetdir, splitsdir, "val", items[n_train : n_train + n_val])
    write_split(datasetdir, splitsdir, "test", items[n_train + n_val :])
    return items


def cli_main(argv=None):
    p = argparse.ArgumentParser(description="write train/val/test split files")
    p.add_argument("--datasetdir", default="data")
    p.add_argument("--rawdir", default=None)
    p.add_argument("--splitsdir", required=True)
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--train_frac", type=float, default=0.8)
    p.add_argument("--val_frac", type=float, default=0.1)
    p.add_argument("--subsample", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if a.rawdir:
        create_split_from_tree(
            a.datasetdir, a.rawdir, a.splitsdir, a.train_frac, a.val_frac,
            a.subsample, a.seed,
        )
    elif a.n_samples is None:
        p.error("--n_samples or --rawdir required")
    else:
        create_split_from_count(a.datasetdir, a.splitsdir, a.n_samples, a.train_frac, a.val_frac)


if __name__ == "__main__":
    cli_main()
