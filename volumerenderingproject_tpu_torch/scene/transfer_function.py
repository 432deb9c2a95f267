"""Transfer function: piecewise-constant intensity -> RGBA classification.

Replicates ``TransferFunction::getMaterial`` (TransferFunction.cu:46-55):

  * a linear scan over intervals with *inclusive* bounds,
  * the LAST matching interval wins,
  * no match falls back to interval 0's material.

The text format is ``name lower upper`` per line (registry colors) or
``name lower upper r g b a [hg_g]`` (explicit colors), '#' comments.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .materials import MaterialId, get_material

_f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TransferFunction:
    """Interval table: ``lower``/``upper`` [K] inclusive bounds (normalized
    intensity), ``colors`` [K, 4] RGBA, ``hg_g`` [K] Henyey-Greenstein g."""

    lower: torch.Tensor
    upper: torch.Tensor
    colors: torch.Tensor
    hg_g: torch.Tensor

    @property
    def num_intervals(self) -> int:
        return int(self.lower.shape[0])

    def to(self, device) -> "TransferFunction":
        return TransferFunction(*(t.to(device) for t in (
            self.lower, self.upper, self.colors, self.hg_g)))

    def classify_index(self, value: torch.Tensor) -> torch.Tensor:
        """Index (int64) of the winning interval per value (last match wins,
        fallback 0)."""
        idx = torch.zeros(value.shape, dtype=torch.int64, device=value.device)
        for k in range(1, self.num_intervals):
            idx.masked_fill_((value >= self.lower[k]) & (value <= self.upper[k]),
                             k)
        return idx

    def classify(self, value: torch.Tensor) -> torch.Tensor:
        """RGBA for normalized intensities, shape value.shape + (4,)."""
        return self.colors[self.classify_index(value)]

    def to_lut(self, resolution: int = 256) -> torch.Tensor:
        """Dense RGBA LUT [R, 4]: the classification of the R grid points
        i / (R - 1), which a LUT render reaches by rounding to nearest.

        The grid is the JAX package's ``jnp.linspace(0, 1, R, float32)`` bit
        for bit: XLA turns its division by the constant R - 1 into a product
        with the float32 reciprocal, so point i is f32(i) * f32(1 / (R - 1))
        and the last one is 1.  (``torch.linspace`` and the IEEE quotient
        each differ from it by an ulp at many points, and a point on an
        interval bound then takes another colour.)"""
        dev = self.colors.device
        if resolution == 1:
            grid = torch.zeros(1, dtype=_f32, device=dev)
        else:
            recip = np.float32(1.0) / np.float32(resolution - 1)
            grid = torch.cat([
                torch.arange(resolution - 1, dtype=_f32, device=dev)
                * torch.tensor(recip, device=dev),
                torch.ones(1, dtype=_f32, device=dev)])
        return self.classify(grid)


def _table(lowers, uppers, colors, gs, device) -> TransferFunction:
    dev = resolve_device(device)
    return TransferFunction(
        lower=torch.as_tensor(np.asarray(lowers, np.float32), device=dev),
        upper=torch.as_tensor(np.asarray(uppers, np.float32), device=dev),
        colors=torch.as_tensor(np.stack(colors).astype(np.float32), device=dev),
        hg_g=torch.as_tensor(np.asarray(gs, np.float32), device=dev),
    )


def from_pairs(
    pairs: Sequence[Tuple[MaterialId | int | str, float, float]], device=None
) -> TransferFunction:
    """Build from (material, lower, upper) triples (TransferFunction.cu:19-23)."""
    lowers, uppers, colors, gs = [], [], [], []
    for mid, lo, hi in pairs:
        m = get_material(mid)
        lowers.append(np.float32(lo))
        uppers.append(np.float32(hi))
        colors.append(np.asarray(m.rgba, np.float32))
        gs.append(np.float32(m.hg_g))
    return _table(lowers, uppers, colors, gs, device)


def default_transfer_function(device=None) -> TransferFunction:
    """The reference's hardcoded table (TransferFunction.cu:19-23)."""
    return from_pairs(
        [
            (MaterialId.empty, 0.0, 1.0),
            (MaterialId.bone, 30.0 / 255.0, 80.0 / 255.0),
            (MaterialId.muscle, 140.0 / 255.0, 160.0 / 255.0),
            (MaterialId.brain, 105.0 / 255.0, 120.0 / 255.0),
        ],
        device,
    )


def from_text(text: str, device=None) -> TransferFunction:
    """Parse the transfer-function text format (see the module docstring).
    Bounds above 1 are taken as [0, 255] values and divided by 255."""
    lowers, uppers, colors, gs = [], [], [], []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) not in (3, 7, 8):
            raise ValueError(f"bad transfer-function line: {line!r}")
        lo, hi = float(parts[1]), float(parts[2])
        if lo > 1.0 or hi > 1.0:
            lo, hi = lo / 255.0, hi / 255.0
        if len(parts) >= 7:
            rgba = np.asarray([float(v) for v in parts[3:7]], np.float32)
            g = float(parts[7]) if len(parts) == 8 else 0.0
        else:
            m = get_material(parts[0])
            rgba = np.asarray(m.rgba, np.float32)
            g = m.hg_g
        lowers.append(np.float32(lo))
        uppers.append(np.float32(hi))
        colors.append(rgba)
        gs.append(np.float32(g))
    if not lowers:
        raise ValueError("empty transfer function")
    return _table(lowers, uppers, colors, gs, device)


def to_text(tf: TransferFunction, names: Sequence[str] | None = None) -> str:
    """Serialize to the explicit-color text format (round-trips colors)."""
    lines = ["# volumerenderingproject_tpu transfer function",
             "# name lower upper r g b a hg_g"]
    lo = tf.lower.cpu().numpy()
    hi = tf.upper.cpu().numpy()
    cols = tf.colors.cpu().numpy()
    gs = tf.hg_g.cpu().numpy()
    for i in range(tf.num_intervals):
        name = names[i] if names else f"interval_{i}"
        c = " ".join(f"{float(v):.9g}" for v in cols[i])
        lines.append(
            f"{name} {float(lo[i]):.9g} {float(hi[i]):.9g} {c} {float(gs[i]):.9g}"
        )
    return "\n".join(lines) + "\n"
