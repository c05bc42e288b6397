"""Split-file handling (a copy of sv3d_tpu/data/splits.py).

The reference keeps plain-text id lists under data/splits/<splitsdir>/
{train,val,test,train_vis,val_vis,train_eval}.txt (reference
data_processing/create_split.py:31-62); datasets read them relative to the
dataset root.  One id per line; ids may be nested paths ("scene/view") for
3D-Front-style trees (reference data_processing/create_split_scenenet.py).
"""

from __future__ import annotations

from pathlib import Path


def split_path(datasetdir: str | Path, splitsdir: str, split: str) -> Path:
    return Path(datasetdir) / "splits" / splitsdir / f"{split}.txt"


def read_split(datasetdir: str | Path, splitsdir: str, split: str) -> list:
    path = split_path(datasetdir, splitsdir, split)
    return [line.strip() for line in path.read_text().splitlines() if line.strip()]


def write_split(datasetdir: str | Path, splitsdir: str, split: str, ids) -> Path:
    path = split_path(datasetdir, splitsdir, split)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"{i}\n" for i in ids))
    return path
