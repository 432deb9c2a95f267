"""VolView ``.vvi`` sidecar reader (reference C21 datasets-and-goldens).

The reference checkout ships ``*.nii.vvi`` files next to its volumes —
``vtkKWOpenFileProperties`` XML fragments written by Kitware's VolView
(spacing / origin / extent / scalar-type metadata that VolView caches per
opened file).  The reference never parses them (they are viewer
sidecars), but they are part of its dataset inventory (SURVEY.md §2
C21), so the ingest layer can read them: useful as a cross-check of the
NIfTI header and as provenance for datasets whose ``.nii`` was stripped
from the checkout (.MISSING_LARGE_BLOBS).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

# VTK scalar type ids (vtkType.h) for the subset VolView writes
_VTK_SCALAR_TYPES = {
    2: "int8",
    3: "uint8",
    4: "int16",
    5: "uint16",
    6: "int32",
    7: "uint32",
    10: "float32",
    11: "float64",
}


@dataclasses.dataclass(frozen=True)
class VviProperties:
    """Parsed vtkKWOpenFileProperties attributes."""

    version: str
    spacing: Tuple[float, float, float]
    origin: Tuple[float, float, float]
    scalar_type: int
    whole_extent: Tuple[int, int, int, int, int, int]
    num_scalar_components: int
    independent_components: bool
    file_orientation: Tuple[int, int, int]
    big_endian: bool
    file_dimensionality: int

    @property
    def dims(self) -> Tuple[int, int, int]:
        """Voxel counts from the (inclusive) WholeExtent."""
        e = self.whole_extent
        return (e[1] - e[0] + 1, e[3] - e[2] + 1, e[5] - e[4] + 1)

    @property
    def dtype_name(self) -> Optional[str]:
        return _VTK_SCALAR_TYPES.get(self.scalar_type)


def _attrs(text: str) -> dict:
    return dict(re.findall(r'([A-Za-z]+)="([^"]*)"', text))


def parse_vvi(text: str) -> VviProperties:
    """Parse a ``.vvi`` XML fragment's attribute soup."""
    a = _attrs(text)
    if "WholeExtent" not in a:
        raise ValueError("not a vtkKWOpenFileProperties .vvi fragment")

    def floats(key, n, default="0"):
        vals = [float(v) for v in a.get(key, " ".join([default] * n)).split()]
        return tuple(vals)

    def ints(key, n, default="0"):
        vals = [int(float(v))
                for v in a.get(key, " ".join([default] * n)).split()]
        return tuple(vals)

    return VviProperties(
        version=a.get("Version", ""),
        spacing=floats("Spacing", 3, "1"),
        origin=floats("Origin", 3),
        scalar_type=int(a.get("ScalarType", "-1")),
        whole_extent=ints("WholeExtent", 6),
        num_scalar_components=int(a.get("NumberOfScalarComponents", "1")),
        independent_components=a.get("IndependentComponents", "1") == "1",
        file_orientation=ints("FileOrientation", 3),
        big_endian=a.get("BigEndianFlag", "0") == "1",
        file_dimensionality=int(a.get("FileDimensionality", "3")),
    )


def load_vvi(path: str) -> VviProperties:
    with open(path) as f:
        return parse_vvi(f.read())
