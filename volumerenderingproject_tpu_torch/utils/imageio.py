"""Image conversion and PNG output.

The canonical image layout is ``img[x, y, rgba]``: x = screen column, y =
screen row from the top, the reference's column-major screen buffer
(pixel id x*SCR_HEIGHT + y, kernel.cu:25).  :func:`to_display` turns it into
the top-down [H, W, C] array of the reference's saved PNGs (a 180° rotation
for a1, identity for a5; myApp.cu:933,1033).

PNG files are written with ``zlib`` and ``struct`` alone, so no imaging
package is needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .config import Algorithm


def _numpy(img) -> np.ndarray:
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img)


def to_uint8(img) -> np.ndarray:
    arr = _numpy(img)
    return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)


def to_display(img, algorithm: Algorithm = Algorithm.VRC) -> np.ndarray:
    """[W, H, C] canonical image -> [H, W, C] top-down display array."""
    arr = _numpy(img)
    if algorithm is Algorithm.VRC:
        # png[r][c] = img[W-1-c][r] (180° rotate; -1 accounts for raster offset)
        return arr[::-1, :, :].transpose(1, 0, 2)
    # identity rotate: png[r][c] = img[c][H-1-r]
    return arr[:, ::-1, :].transpose(1, 0, 2)


def encode_png(rgb: np.ndarray) -> bytes:
    """8-bit RGB PNG bytes of an [H, W, 3] uint8 array."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3], got {rgb.shape}")
    # filter type 0 (none) in front of every scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path, img, algorithm: Algorithm = Algorithm.VRC) -> None:
    """Save a canonical [W, H, 3/4] float image as PNG in display orientation."""
    disp = to_uint8(to_display(img, algorithm))[..., :3]
    with open(path, "wb") as f:
        f.write(encode_png(disp))

