"""Pure-Python/NumPy NIfTI-1 / NIfTI-2 reader.

Files are told apart by ``sizeof_hdr`` (348 = NIfTI-1, 540 = NIfTI-2;
BinaryLoader.cu:288-302) and the voxels are read at ``vox_offset``.  The
reader honours ``datatype``, converts to float32 and keeps a 4th axis as
channels.  No imaging package is needed: header fields are numpy reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

from .volume import Volume, make_volume

# nifti datatype codes (nifti1.h:136-180) -> numpy dtypes
_DTYPE_CODES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}

NIFTI1_HDR_SIZE = 348
NIFTI2_HDR_SIZE = 540


@dataclasses.dataclass(frozen=True)
class NiftiHeader:
    """The header fields the pipeline reads (cf. nifti2.h:59-96)."""

    sizeof_hdr: int
    datatype: int
    bitpix: int
    dim: Tuple[int, ...]  # dim[0..7]
    pixdim: Tuple[float, ...]  # pixdim[0..7]
    vox_offset: int
    scl_slope: float
    scl_inter: float
    cal_max: float
    cal_min: float
    magic: bytes
    byteorder: str  # '<' or '>'

    @property
    def ndim(self) -> int:
        return int(self.dim[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(d) for d in self.dim[1 : 1 + self.ndim])


def _scalar(buf: bytes, off: int, dtype, bo: str):
    return np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder(bo), count=1, offset=off)[0]


def _array(buf: bytes, off: int, dtype, count: int, bo: str):
    return np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder(bo), count=count, offset=off)


def parse_header(buf: bytes) -> NiftiHeader:
    """Parse a NIfTI-1/2 header from raw bytes (either byte order)."""
    if len(buf) < NIFTI1_HDR_SIZE:
        raise ValueError("file too small to hold a NIfTI header")
    raw_size = np.frombuffer(buf, dtype="<i4", count=1)[0]
    if raw_size in (NIFTI1_HDR_SIZE, NIFTI2_HDR_SIZE):
        bo = "<"
    else:
        raw_size_be = np.frombuffer(buf, dtype=">i4", count=1)[0]
        if raw_size_be in (NIFTI1_HDR_SIZE, NIFTI2_HDR_SIZE):
            bo = ">"
            raw_size = raw_size_be
        else:
            raise ValueError(
                f"file isn't in a valid NIfTI format (sizeof_hdr={int(raw_size)})"
            )

    if raw_size == NIFTI2_HDR_SIZE:
        return NiftiHeader(
            sizeof_hdr=int(raw_size),
            datatype=int(_scalar(buf, 12, np.int16, bo)),
            bitpix=int(_scalar(buf, 14, np.int16, bo)),
            dim=tuple(int(x) for x in _array(buf, 16, np.int64, 8, bo)),
            pixdim=tuple(float(x) for x in _array(buf, 104, np.float64, 8, bo)),
            vox_offset=int(_scalar(buf, 168, np.int64, bo)),
            scl_slope=float(_scalar(buf, 176, np.float64, bo)),
            scl_inter=float(_scalar(buf, 184, np.float64, bo)),
            cal_max=float(_scalar(buf, 192, np.float64, bo)),
            cal_min=float(_scalar(buf, 200, np.float64, bo)),
            magic=bytes(buf[4:12]),
            byteorder=bo,
        )
    return NiftiHeader(
        sizeof_hdr=int(raw_size),
        datatype=int(_scalar(buf, 70, np.int16, bo)),
        bitpix=int(_scalar(buf, 72, np.int16, bo)),
        dim=tuple(int(x) for x in _array(buf, 40, np.int16, 8, bo)),
        pixdim=tuple(float(x) for x in _array(buf, 76, np.float32, 8, bo)),
        vox_offset=int(_scalar(buf, 108, np.float32, bo)),
        scl_slope=float(_scalar(buf, 112, np.float32, bo)),
        scl_inter=float(_scalar(buf, 116, np.float32, bo)),
        cal_max=float(_scalar(buf, 124, np.float32, bo)),
        cal_min=float(_scalar(buf, 128, np.float32, bo)),
        magic=bytes(buf[344:348]),
        byteorder=bo,
    )


def load_nifti(
    path: str | os.PathLike,
    *,
    apply_scaling: bool = False,
    dtype_override: int | None = None,
    backend: str = "auto",
    device=None,
) -> Volume:
    """Load a ``.nii`` file into a :class:`Volume` on ``device`` (CUDA by
    default).

    ``apply_scaling`` applies ``scl_slope * v + scl_inter`` when the slope is
    not 0 (the reference ignores scaling).  ``dtype_override`` forces a
    datatype code (16 replicates the reference's float32 reinterpretation,
    BinaryLoader.cu:313-323).  ``backend``: ``"native"`` reads through the
    native library (``native/vrputils.cpp``, built at first use; its
    multithreaded conversion), ``"python"`` with numpy, ``"auto"`` (the
    default) natively unless ``dtype_override`` is given or the native
    reader does not take the file (a ValueError), as the JAX package's
    loader does (nifti.py:152-170).  A native library that cannot be
    built raises.
    """
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "python" and dtype_override is None:
        try:
            return _load_native(os.fspath(path), apply_scaling, device)
        except ValueError:
            if backend == "native":
                raise
    with open(path, "rb") as f:
        buf = f.read()
    hdr = parse_header(buf)

    code = dtype_override if dtype_override is not None else hdr.datatype
    np_dtype = _DTYPE_CODES.get(code)
    if np_dtype is None:
        raise ValueError(f"unsupported nifti datatype code {code}")

    ndim = hdr.ndim
    if ndim < 3:
        raise ValueError(f"need >= 3 spatial dims, got dim[0]={ndim}")
    shape = hdr.shape
    count = int(np.prod(shape))
    payload = np.frombuffer(
        buf,
        dtype=np.dtype(np_dtype).newbyteorder(hdr.byteorder),
        count=count,
        offset=int(hdr.vox_offset),
    )
    data = payload.astype(np.float32)
    if apply_scaling and hdr.scl_slope not in (0.0,):
        data = data * np.float32(hdr.scl_slope) + np.float32(hdr.scl_inter)

    return _volume(data, shape, hdr.cal_max, hdr.cal_min, hdr.pixdim, device)


def _volume(data: np.ndarray, shape, cal_max: float, cal_min: float, pixdim,
            device) -> Volume:
    """The Volume of a file's flat float32 payload.  The flat order is
    x-major (BinaryLoader.cu:234-238): C-order [X, Y, Z]; a 4-D file keeps
    its 4th axis as channels, last.  A ``cal_max`` of 0 becomes the data's
    maximum (1 where that is 0)."""
    if len(shape) == 3:
        arr = data.reshape(shape)
    else:
        spatial = shape[:3]
        chans = int(np.prod(shape[3:]))
        arr = data.reshape((chans,) + spatial).transpose(1, 2, 3, 0)
    if cal_max in (0.0,):
        cal_max = float(np.max(data) or 1.0)
    return make_volume(arr, cal_max=cal_max, cal_min=cal_min,
                       pixdim=tuple(pixdim[1:4]), device=device)


def _load_native(path: str, apply_scaling: bool, device) -> Volume:
    """The native reader's Volume (JAX nifti.py:207-228)."""
    from .. import native

    hdr, data = native.nifti_read(path)
    ndim = int(hdr["dim"][0])
    if ndim < 3:
        raise ValueError(f"need >= 3 spatial dims, got dim[0]={ndim}")
    shape = tuple(int(d) for d in hdr["dim"][1:1 + ndim])
    if apply_scaling and hdr["scl_slope"] not in (0.0,):
        data = (data * np.float32(hdr["scl_slope"])
                + np.float32(hdr["scl_inter"]))
    return _volume(data, shape, hdr["cal_max"], hdr["cal_min"],
                   hdr["pixdim"], device)
