"""Checkpoint save/restore on torch.save, plus the UNet-only warm start (port
of sv3d_tpu/training/checkpoint.py).

A checkpoint is one torch.save file {"model": state_dict, "optimizer":
optimizer state_dict, "step": int}.  CheckpointManager keeps `last` plus the
best top_k `step_<N>` files ranked by a monitored metric, with the JAX
package's manifest.json: {"scores": [[metric, path], ...] best first,
"last_step", "monitor", "mode"}; a new manager in the same directory reloads
it so top-k tracking survives a resume, and prunes step files that dropped
out of it.  A manager made with primary=False (a multi-GPU run's ranks
other than 0) touches no file: its saves do nothing.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import torch

from sv3d_tpu_torch.training.state import TrainState


class CheckpointManager:
    def __init__(self, directory: str | Path, top_k: int = 2, mode: str = "min",
                 monitor: str = "", primary: bool = True):
        """mode "min" ranks lower-is-better metrics (losses), "max"
        higher-is-better ones; top_k < 0 keeps every ranked checkpoint.
        primary=False: no file is read or written."""
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min or max, got {mode!r}")
        self.directory = Path(directory)
        self.top_k = top_k
        self.mode = mode
        self.monitor = monitor
        self.primary = primary
        self._scores: list = []  # (metric, path), best first
        if primary:
            self.directory.mkdir(parents=True, exist_ok=True)
            self._load_manifest()

    def _load_manifest(self):
        manifest = self.directory / "manifest.json"
        if not manifest.exists():
            return
        try:
            data = json.loads(manifest.read_text())
        except (json.JSONDecodeError, OSError):
            return
        self._scores = [(float(m), str(p)) for m, p in data.get("scores", []) if Path(p).exists()]
        self._scores.sort(key=self._rank_key)
        keep = {Path(p).name for _, p in self._scores}
        for f in self.directory.glob("step_*"):
            if f.is_file() and f.name not in keep:
                f.unlink()

    def _rank_key(self, entry):
        return entry[0] if self.mode == "min" else -entry[0]

    @staticmethod
    def _save_file(path: Path, tree: dict):
        # write then rename, so a reader never opens a half-written checkpoint
        tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
        torch.save(tree, tmp)
        os.replace(tmp, path)

    def save(self, state: TrainState, metric: Optional[float] = None,
             step: Optional[int] = None):
        if not self.primary:
            return
        step = int(state.step) if step is None else int(step)
        tree = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": step,
        }
        self._save_file(self.directory / "last", tree)
        if metric is not None and self.top_k != 0:
            path = self.directory / f"step_{step}"
            self._save_file(path, tree)
            # re-saving one step replaces its score entry
            self._scores = [s for s in self._scores if s[1] != str(path)]
            self._scores.append((float(metric), str(path)))
            self._scores.sort(key=self._rank_key)
            if self.top_k > 0:
                while len(self._scores) > self.top_k:
                    _, worst = self._scores.pop()
                    Path(worst).unlink(missing_ok=True)
        (self.directory / "manifest.json").write_text(json.dumps({
            "scores": self._scores, "last_step": step, "monitor": self.monitor,
            "mode": self.mode,
        }))

    def best_path(self) -> Optional[str]:
        return self._scores[0][1] if self._scores else None


def restore_tree(path: str | Path, map_location="cpu") -> dict:
    return torch.load(Path(path), map_location=map_location, weights_only=True)


def load_state_from_checkpoint(state: TrainState, path: str | Path) -> TrainState:
    """Full resume: model (parameters and BatchNorm statistics), optimizer
    and step.  A checkpoint of another architecture (net_res, skip_unet,
    resize_input, W) fails in load_state_dict."""
    device = next(state.model.parameters()).device
    tree = restore_tree(path, map_location=device)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree.get("step", 0))
    return state


def load_pretrained_unet(state: TrainState, path: str | Path) -> TrainState:
    """Warm start: overwrite ONLY the unet's parameters and statistics from a
    checkpoint, leaving project / ifnet untouched.  A scene-net checkpoint
    nests the UNet under `unet.`; a depth-regressor checkpoint is the UNet
    itself at top level."""
    device = next(state.model.parameters()).device
    src = restore_tree(path, map_location=device)["model"]
    if any(k.startswith("unet.") for k in src):
        src = {k[len("unet."):]: v for k, v in src.items() if k.startswith("unet.")}
    state.model.unet.load_state_dict(src)
    return state
