"""Golden-image comparison against the reference's image_output/ captures.

The reference's goldens (image_{W}x{H}_a{alg}_spr{n}.png, myApp.cu:1209-1210)
are GL-window screenshots whose camera at capture time is not recorded, so
a pixel-exact comparison against them is impossible.  What can be checked:

  * geometry: the config encoded in the file name (:func:`parse_golden_name`),
  * palette: rendered colours come from the same material set
    (:func:`palette_distance`),
  * structure: a similarity score (:func:`similarity`) for qualitative
    regression tracking, and the share of foreground pixels
    (:func:`foreground_fraction`).

numpy only, as in the JAX package (harness/goldens.py).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

_NAME_RE = re.compile(r"image_(\d+)x(\d+)_a(\d+)_spr(\d+)\.png$")


def parse_golden_name(path: str) -> Optional[Dict[str, int]]:
    m = _NAME_RE.search(os.path.basename(path))
    if not m:
        return None
    w, h, alg, spr = (int(g) for g in m.groups())
    return {"width": w, "height": h, "algorithm": alg, "spr": spr}


def palette_distance(img: np.ndarray, palette: np.ndarray) -> float:
    """Mean distance of each pixel to its nearest palette colour: ``img``
    [H, W, 3] in [0, 1], ``palette`` [P, 3]."""
    flat = img.reshape(-1, 3)
    d = np.linalg.norm(flat[:, None, :] - palette[None, :, :], axis=-1)
    return float(d.min(axis=1).mean())


def similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Normalized cross-correlation of grayscale images in [0, 1]."""
    ga = a.mean(axis=-1) if a.ndim == 3 else a
    gb = b.mean(axis=-1) if b.ndim == 3 else b
    if ga.shape != gb.shape:
        return 0.0
    ga = ga - ga.mean()
    gb = gb - gb.mean()
    denom = np.sqrt((ga**2).sum() * (gb**2).sum())
    if denom == 0:
        return 1.0 if np.allclose(ga, gb) else 0.0
    return float((ga * gb).sum() / denom)


def foreground_fraction(img: np.ndarray, background=(0.2, 0.2, 0.2)) -> float:
    bg = np.asarray(background, np.float32)
    return float((np.abs(img[..., :3] - bg).max(axis=-1) > 0.05).mean())
