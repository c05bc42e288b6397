"""RGB image loading and the input transforms used by the datasets (a copy
of sv3d_tpu/io/image.py).

Replaces the torchvision transform stack of the reference
(dataset/scene_net_data.py:13-20,34-45: SquarePad + Resize + ToTensor +
Normalize(0.5, 0.5)) with numpy/PIL equivalents.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


def load_rgb(path: str | Path, flip_lr: bool = False) -> np.ndarray:
    """Load an RGB image as (H, W, 3) float32 in [0, 1]."""
    img = Image.open(path).convert("RGB")
    if flip_lr:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img, dtype=np.float32) / 255.0


def square_pad_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad (H, W, C) to square then bilinear-resize to (size, size, C).

    Matches the reference SquarePad + Resize(W, W) transform
    (dataset/scene_net_data.py:13-20,36).
    """
    h, w = img.shape[:2]
    m = max(h, w)
    vp, hp = (m - h) // 2, (m - w) // 2
    padded = np.zeros((m, m, img.shape[2]), dtype=img.dtype)
    padded[vp : vp + h, hp : hp + w] = img
    pil = Image.fromarray((padded * 255.0).clip(0, 255).astype(np.uint8))
    resized = pil.resize((size, size), Image.BILINEAR)
    return np.asarray(resized, dtype=np.float32) / 255.0


def normalize_rgb(img: np.ndarray) -> np.ndarray:
    """(x - 0.5) / 0.5 channel normalization, CHW output
    (dataset/scene_net_data.py:41-44)."""
    return np.moveaxis((img - 0.5) / 0.5, -1, 0).astype(np.float32)
