"""Material registry — constants from the reference (Material.h/Material.cpp).

Each material is (name, RGBA, Henyey-Greenstein g).  RGBA values replicate
``Material::getMaterialFromID`` (Material.cpp:5-67) exactly.  The reference
stores a HG coefficient but always sets it to 0; the lighting subsystem here
actually uses it (see ops/phong.py), defaulting to the reference's g = 0
(isotropic phase, myApp.cu:1721-1728).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Tuple

import numpy as np


class MaterialId(enum.IntEnum):
    """Material ids (Material.h:25-30)."""

    red = 0
    green = 1
    blue = 2
    bone = 3
    muscle = 4
    eye = 5
    brain = 6
    cerebelum = 7
    cerebrospinal_fluid = 8
    brain_stem = 9
    glass = 10
    empty = 11
    air = 12
    default = 13


@dataclasses.dataclass(frozen=True)
class Material:
    name: str
    rgba: Tuple[float, float, float, float]
    hg_g: float = 0.0


_BONE_TINT = (241.0 / 255.0, 218.0 / 255.0, 202.0 / 255.0)

_REGISTRY: Dict[MaterialId, Material] = {
    MaterialId.red: Material("RED", (1.0, 0.0, 0.0, 1.0)),
    MaterialId.green: Material("GREEN", (0.0, 1.0, 0.0, 1.0)),
    MaterialId.blue: Material("BLUE", (0.0, 0.0, 1.0, 1.0)),
    MaterialId.glass: Material("GLASS", (0.2, 0.2, 0.2, 0.1)),
    MaterialId.muscle: Material(
        "MUSCLE", (124.0 / 255.0, 9.0 / 255.0, 42.0 / 255.0, 0.3)
    ),
    MaterialId.empty: Material("EMPTY", (0.0, 0.0, 0.0, 0.0)),
    MaterialId.bone: Material("BONE", (*_BONE_TINT, 0.3)),
    MaterialId.brain: Material(
        "BRAIN", (223.0 / 255.0, 155.0 / 255.0, 141.0 / 255.0, 0.7)
    ),
    MaterialId.brain_stem: Material("BRAIN_STEM", (*_BONE_TINT, 0.9)),
    MaterialId.cerebelum: Material("CEREBELUM", (*_BONE_TINT, 0.9)),
    MaterialId.cerebrospinal_fluid: Material("CEREBROSPINAL_FLUID", (*_BONE_TINT, 0.9)),
    MaterialId.eye: Material("EYE", (*_BONE_TINT, 0.9)),
}

_DEFAULT = Material("DEFAULT", (1.0, 0.0, 1.0, 0.1))


def get_material(mid: MaterialId | int | str) -> Material:
    """Material::getMaterialFromID — unknown ids return DEFAULT (Material.cpp:61-63)."""
    if isinstance(mid, str):
        try:
            mid = MaterialId[mid.lower()]
        except KeyError:
            return _DEFAULT
    try:
        mid = MaterialId(mid)
    except ValueError:
        return _DEFAULT
    return _REGISTRY.get(mid, _DEFAULT)


def material_rgba(mid: MaterialId | int | str) -> np.ndarray:
    return np.asarray(get_material(mid).rgba, np.float32)
