"""Render configuration — the runtime replacement for the reference's
compile-time ``AppData`` struct (utils.h:24-82).

Every AppData field that affects output is represented; resolution / spr /
projection are plain constructor args instead of an edit-and-recompile cycle.
JSON round-trip supported for the CLI (harness/cli.py).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
from typing import Tuple


class Algorithm(enum.Enum):
    """Render algorithms (utils.h:13-18; a0/a1/a5 in golden filenames)."""

    POINT = 0  # voxel point splat
    VRC = 1  # octree/nearest-neighbor ray cast
    TEST = 5  # direct trilinear (color-space) ray cast


class Interp(enum.Enum):
    NEAREST = "nearest"  # a1 semantics (octree leaf sampling)
    TRILINEAR_COLOR = "trilinear_color"  # a5 semantics (interpolates TF colors)
    TRILINEAR = "trilinear"  # smooth extension: interpolate intensities


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable; safe as a jit static argument)."""

    width: int = 300  # SCR_WIDTH utils.h:36
    height: int = 300  # SCR_HEIGHT utils.h:37
    samples_per_ray: int = 300  # utils.h:72
    conic: bool = False  # utils.h:28
    # The reference's conic mode is latently broken: its top_left omits the
    # viewplane_distance*front term (utils.h:57 commented out; conic is
    # compile-time false so it never shows).  True (default) applies the
    # intended conic corner so perspective rendering works; False replicates
    # the reference bit-for-bit (rays in the screen plane, background-only).
    conic_corrected: bool = True
    view_angle: float = math.pi / 4  # utils.h:54
    viewplane_distance: float = 2.0  # utils.h:53
    front_clip: float = 0.0  # utils.h:73
    background: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 1.0)  # utils.h:38
    algorithm: Algorithm = Algorithm.VRC
    # --- new-framework extensions (no AppData counterpart) ---
    interp: Interp = Interp.NEAREST
    # empty-space skipping is consumed by the planned Pallas fast path
    # (DESIGN.md §4.3); the XLA scan path computes all samples by design
    empty_space_skipping: bool = True
    # per-tile early ray termination epsilon — pallas backend only (the XLA
    # scan has static control flow); 0 = off, exact vs mode="fast"
    early_termination: float = 0.0
    lighting: bool = False  # Phong gradient shading (upgrades C16's stub)
    # normal-estimation filter for lighting: "central" (default) or
    # "sobel" (smoother normals); optional Gaussian pre-smoothing of the
    # density before the gradient (BASELINE config 4's "pre-render
    # convolution gradient filter") — both feed ops/conv3d
    gradient_filter: str = "central"
    presmooth_sigma: float = 0.0
    density_scale: float = 1.0  # global opacity multiplier (differentiable knob)
    tf_sharpness: float = 200.0  # smooth-TF sigmoid sharpness (Interp.TRILINEAR)
    # compile the interval table to a dense round-to-nearest LUT of this many
    # entries for the a1 classify (0 = exact interval scan).  A LUT is the
    # classic fast path for large TF tables (BASELINE config 2 "TF LUT");
    # with the default 4-interval table the scan is already cheap.
    tf_lut: int = 0
    # single-scattering light transport (off by default): adds in-scattered
    # radiance — Henyey-Greenstein phase (per-material g, Material.h:14-23)
    # x per-voxel light transmittance (a sheared plane sweep along the
    # light direction) — to every sample.  Realizes the reference's
    # declared-but-stubbed radiative-transfer API (optical_depth /
    # inscattering / extinction, LightInteraction.h:10-35) for real, and
    # puts the HG phase function in an actual render path.
    scattering: bool = False
    scattering_strength: float = 1.0

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad image size {self.width}x{self.height}")
        if self.samples_per_ray <= 0:
            raise ValueError(f"samples_per_ray must be > 0, got {self.samples_per_ray}")
        if not 0.0 <= self.front_clip < self.viewplane_distance:
            raise ValueError(
                f"front_clip {self.front_clip} must be in [0, viewplane "
                f"{self.viewplane_distance})"
            )
        if self.density_scale < 0.0:
            raise ValueError(f"density_scale must be >= 0, got {self.density_scale}")

    @property
    def real_screen_width(self) -> float:
        """2*tan(view_angle) — utils.h:58 (same formula in conic mode: the
        conic variant at utils.h:57 is commented out in the reference)."""
        return 2.0 * math.tan(self.view_angle)

    @property
    def real_screen_height(self) -> float:
        return self.real_screen_width * self.height / self.width

    @property
    def sample_distance(self) -> float:
        """(viewplane - front_clip) / spr — utils.h:74."""
        return (self.viewplane_distance - self.front_clip) / self.samples_per_ray

    @property
    def num_rays(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    # -- JSON round trip -----------------------------------------------------
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["algorithm"] = self.algorithm.name
        d["interp"] = self.interp.value
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        d = json.loads(s)
        if "algorithm" in d:
            d["algorithm"] = Algorithm[d["algorithm"]]
        if "interp" in d:
            d["interp"] = Interp(d["interp"])
        if "background" in d:
            d["background"] = tuple(d["background"])
        return RenderConfig(**d)
