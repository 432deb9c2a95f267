"""ctypes bindings of the native host library (``native/vrputils.cpp``),
built at first use by :mod:`.build`; a failed build raises.

Entry points: the NIfTI header and payload readers (``ingest/nifti.py``'s
``backend="native"``), the min/max pyramid's leaf grid and pooling, the
exact GL point rasterizer (``models/point_splat.render_points(exact=
True)``) and the zero-padded 3-D convolution.  All run on the host, on
numpy arrays.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from .build import build as _build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class _NiftiInfo(ctypes.Structure):
    _fields_ = [
        ("sizeof_hdr", ctypes.c_int32),
        ("datatype", ctypes.c_int32),
        ("bitpix", ctypes.c_int32),
        ("dim", ctypes.c_int64 * 8),
        ("pixdim", ctypes.c_double * 8),
        ("vox_offset", ctypes.c_int64),
        ("scl_slope", ctypes.c_double),
        ("scl_inter", ctypes.c_double),
        ("cal_max", ctypes.c_double),
        ("cal_min", ctypes.c_double),
        ("swapped", ctypes.c_int32),
    ]


def load() -> ctypes.CDLL:
    """The library, built and bound at the first call (one thread builds
    it, the others wait)."""
    with _lib_lock:
        return _bind() if _lib is None else _lib


def _bind() -> ctypes.CDLL:
    global _lib
    lib = ctypes.CDLL(str(_build()))
    fp, i, i64 = (ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                  ctypes.c_int64)
    info = ctypes.POINTER(_NiftiInfo)
    for name, args, res in (
            ("vrp_nifti_header", [ctypes.c_char_p, info], ctypes.c_int),
            ("vrp_nifti_read", [ctypes.c_char_p, info, fp, i64, i],
             ctypes.c_int),
            ("vrp_leaf_grid", [fp, i, i, i, i, fp, i], None),
            ("vrp_pool2", [fp, fp, i, fp, fp], None),
            ("vrp_point_rasterize", [fp, fp, i64, i, i, fp, fp], None),
            ("vrp_conv3d", [fp, i, i, i, fp, i, i, i, fp, i], None)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    _lib = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _nthreads() -> int:
    return max(1, os.cpu_count() or 1)


def _info_dict(info: _NiftiInfo) -> dict:
    return {
        "sizeof_hdr": info.sizeof_hdr,
        "datatype": info.datatype,
        "bitpix": info.bitpix,
        "dim": tuple(info.dim),
        "pixdim": tuple(info.pixdim),
        "vox_offset": info.vox_offset,
        "scl_slope": info.scl_slope,
        "scl_inter": info.scl_inter,
        "cal_max": info.cal_max,
        "cal_min": info.cal_min,
        "swapped": bool(info.swapped),
    }


def _header(lib, path: str) -> _NiftiInfo:
    info = _NiftiInfo()
    rc = lib.vrp_nifti_header(path.encode(), ctypes.byref(info))
    if rc:
        raise ValueError(f"native nifti header parse failed (code {rc}): "
                         f"{path}")
    return info


def nifti_header(path: str) -> dict:
    return _info_dict(_header(load(), path))


def nifti_read(path: str) -> Tuple[dict, np.ndarray]:
    """Header + float32 payload (flat, C-order x-major).  A file the native
    reader does not take (a datatype it does not convert, a short file)
    raises ValueError."""
    lib = load()
    info = _header(lib, path)
    count = 1
    for d in range(1, 1 + int(info.dim[0])):
        count *= int(info.dim[d])
    out = np.empty(count, np.float32)
    rc = lib.vrp_nifti_read(path.encode(), ctypes.byref(info), _fptr(out),
                            count, _nthreads())
    if rc:
        raise ValueError(f"native nifti payload read failed (code {rc}): "
                         f"{path}")
    return _info_dict(info), out


def leaf_grid(volume: np.ndarray, depth: int) -> np.ndarray:
    lib = load()
    vol = np.ascontiguousarray(volume, np.float32)
    d1, d2, d3 = vol.shape
    n = 2**depth
    out = np.empty((n, n, n), np.float32)
    lib.vrp_leaf_grid(_fptr(vol), d1, d2, d3, depth, _fptr(out), _nthreads())
    return out


def build_pyramid(volume: np.ndarray, depth: int):
    """Full min/max level stack, finest first."""
    lib = load()
    leaf = leaf_grid(volume, depth)
    mins, maxs = [leaf], [leaf]
    while mins[-1].shape[0] > 1:
        n = mins[-1].shape[0]
        m = n // 2
        omin = np.empty((m, m, m), np.float32)
        omax = np.empty((m, m, m), np.float32)
        lib.vrp_pool2(_fptr(mins[-1]), _fptr(maxs[-1]), n, _fptr(omin),
                      _fptr(omax))
        mins.append(omin)
        maxs.append(omax)
    return mins, maxs


def point_rasterize(ndc: np.ndarray, rgba: np.ndarray, width: int,
                    height: int, background) -> np.ndarray:
    """Exact GL-semantics point rasterization of [N, 3] ndc points with
    [N, 4] colours, in draw order -> [W, H, 4] image."""
    lib = load()
    ndc = np.ascontiguousarray(ndc, np.float32)
    rgba = np.ascontiguousarray(rgba, np.float32)
    bg = np.ascontiguousarray(background, np.float32)
    out = np.empty((width, height, 4), np.float32)
    lib.vrp_point_rasterize(_fptr(ndc), _fptr(rgba), ndc.shape[0], width,
                            height, _fptr(bg), _fptr(out))
    return out


def conv3d(volume: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    lib = load()
    vol = np.ascontiguousarray(volume, np.float32)
    k = np.ascontiguousarray(kernel, np.float32)
    out = np.empty_like(vol)
    lib.vrp_conv3d(_fptr(vol), *vol.shape, _fptr(k), *k.shape, _fptr(out),
                   _nthreads())
    return out
