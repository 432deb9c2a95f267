"""Image conversion and PNG output.

The canonical image layout is ``img[x, y, rgba]``: x = screen column, y =
screen row from the top, the reference's column-major screen buffer
(pixel id x*SCR_HEIGHT + y, kernel.cu:25).  :func:`to_display` turns it into
the top-down [H, W, C] array of the reference's saved PNGs (a 180° rotation
for a1, identity for a5; myApp.cu:933,1033); :func:`from_display` inverts it.

PNG files are written and read with ``zlib`` and ``struct`` alone, so no
imaging package is needed: 8-bit RGB out, 8-bit RGB or RGBA in, with all
five scanline filters.
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


def from_display(arr, algorithm: Algorithm = Algorithm.VRC) -> np.ndarray:
    """Inverse of :func:`to_display`: [H, W, C] -> canonical [W, H, C]."""
    arr = _numpy(arr)
    if algorithm is Algorithm.VRC:
        return arr.transpose(1, 0, 2)[::-1, :, :]
    return arr.transpose(1, 0, 2)[:, ::-1, :]


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


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec. 9.2) -> [h, stride] uint8."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for r in range(h):
        ftype = int(rows[r, 0])
        line = rows[r, 1:].astype(np.int64)
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub: a running sum per channel along the row
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif ftype == 2:  # Up
            cur = (line + prev) % 256
        elif ftype in (3, 4):  # Average, Paeth: byte by byte
            cur_l = [0] * stride
            ln, up = line.tolist(), prev.tolist()
            for i in range(stride):
                left = cur_l[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) // 2
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_l[i] = (ln[i] + pred) % 256
            cur = np.asarray(cur_l, np.int64)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[r] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 3 or 4] uint8 of an 8-bit RGB or RGBA, non-interlaced PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or ctype not in (2, 6) or interlace != 0:
        raise ValueError(f"only 8-bit RGB/RGBA non-interlaced PNGs are read "
                         f"(bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    c = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{h * (w * c + 1)}")
    return _unfilter(raw, h, w * c, c).reshape(h, w, c)


def load_png(path) -> np.ndarray:
    """Load a PNG as float32 [H, W, 3] in [0, 1] (display orientation)."""
    with open(path, "rb") as f:
        rgb = decode_png(f.read())[..., :3]
    return rgb.astype(np.float32) / 255.0
