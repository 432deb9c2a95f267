"""What each hand-written kernel of the port must do, counted from the work
its inputs need, whatever implements it: the float operations and the bytes
of a1's forward march (K1) and backward march (K4), plain and baked, and
the peaks they are held against.

The constants are the port's own counts (``chip_smoke.py``), each with its
source comment; the samples they multiply are counted by the benchmark's
reference (``gpubench/reference/a1.py``: samples inside the dataset on rays
not yet terminated), never by the program.  The table of kernel names maps
a profiler's kernel event to its kernel.
"""

from __future__ import annotations

import math
import re

# H100 SXM peaks (NVIDIA data sheet, at 700 W): float32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# float operations one march sample costs: position 9, nearest-voxel index
# 18, time step 2, compositing 9 (csrc/march.cu)
FLOPS_PER_SAMPLE = 38
# the baked variants add rgb * M + S, 6 operations, to every sample inside
# the volume
FLOPS_PER_BAKED_SAMPLE = 6
# float operations dL/dcolors needs, each counted once however a kernel
# schedules it.  A sample inside the volume: position 9, nearest-voxel index
# 18, time step 2; the chain w = T a, 1 - a, T (1 - a), w (g . c), its suffix
# sum, + T_N g_t, the division, T (g . c), da 9; w and da into its
# interval's sums 2 (g multiplies an interval's sum of w once per ray)
FLOPS_PER_BWD_SAMPLE = 40
# a sample off the volume takes id0's colour, whose g . c is per ray, and
# its alpha a0.  Where a0 != 0: the chain 9 and its two sums 2 (whether it
# is off the volume follows from the ray's clip against the box, as in the
# forward bounds)
FLOPS_PER_BWD_OUTSIDE_SAMPLE = 11
# where a0 == 0 such a sample leaves T and the suffix sum as they are, so
# every sample of a run of them has one dL/da, T gd0 - num: 2, times the
# run's length 1, into k0's sum 1, once a run; a ray has at most two runs
# (before and after the volume, whose samples are contiguous on a ray)
FLOPS_PER_BWD_OUTSIDE_RUN = 4
# and per ray: for every interval g . c_k 5 and g times its sum of w 3;
# T_N g_t 1
FLOPS_PER_BWD_RAY_PER_INTERVAL = 8
FLOPS_PER_BWD_RAY = 1
# K4 baked adds the shade c * M + S, 6 operations, and w M, 1, per sample
# inside the volume (each once however a kernel schedules it), and reads
# M and S at the voxels the samples touch, 8 bytes for each, at most the
# two grids
FLOPS_PER_BWD_BAKED_SAMPLE = 7

# a voxel's class is one byte (at most 256 intervals); an image's pixel and
# a cotangent's are 4 float32; a colour is 4 float32
CLASS_BYTES = 1
PIXEL_BYTES = 16
COLOR_BYTES = 16
BAKED_BYTES = 8  # M and S, float32 each

# the port's kernels by the name its CUDA source gives them
# (volumerenderingproject_tpu_torch/csrc/*.cu); K2, K5 and K7 are folded
# into K1, K4 and K6
KERNELS = {
    "K1": "march_a1_kernel",
    "K3": "march_a5_kernel",
    "K4": "march_bwd_a1_kernel",
    "K6": "march_bwd_a5_kernel",
    "K8": "smooth_fwd_kernel",
    "K9": "smooth_bwd_kernel",
}
_NAME = {v: k for k, v in KERNELS.items()}
_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def kernel_of(event_name: str) -> str | None:
    """The kernel (``"K1"`` ...) a profiler event of this name ran, or
    None for any other device operation."""
    for word in _WORD.findall(event_name):
        k = _NAME.get(word)
        if k is not None:
            return k
    return None


def read_bytes(grid_bytes: float, reads: float) -> float:
    """Bytes of a grid that the samples read: one read each, at most the
    whole grid (the work follows the data: count what it needs)."""
    return min(grid_bytes, reads)


def bwd_outside_ops(outside: float, rays: int, a0: float) -> float:
    """Float operations dL/dcolors needs for ``outside`` samples off the
    volume on ``rays`` rays, where those samples' alpha is ``a0``: each
    sample's chain where a0 != 0 (FLOPS_PER_BWD_OUTSIDE_SAMPLE), else one
    dL/da a run of them (FLOPS_PER_BWD_OUTSIDE_RUN), at most two a ray."""
    if a0 != 0.0:
        return outside * FLOPS_PER_BWD_OUTSIDE_SAMPLE
    return min(outside, 2 * rays) * FLOPS_PER_BWD_OUTSIDE_RUN


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: ``ops`` at its float32 peak
    against ``nbytes`` at its memory rate, whichever is longer."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def k1_work(needed: float, rays: int, dims, intervals: int,
            baked: bool) -> tuple[float, float]:
    """(float operations, bytes) of one a1 forward march: ``needed``
    samples inside the dataset on live rays, each read once; every class of
    the grid at most once; the colours; the image; with a baked light M and
    S at the sampled voxels, at most the two grids."""
    voxels = math.prod(dims)
    ops = needed * (FLOPS_PER_SAMPLE + (FLOPS_PER_BAKED_SAMPLE if baked
                                        else 0))
    nbytes = (read_bytes(voxels * CLASS_BYTES, needed * CLASS_BYTES)
              + intervals * COLOR_BYTES + rays * PIXEL_BYTES)
    if baked:
        nbytes += read_bytes(voxels * BAKED_BYTES, needed * BAKED_BYTES)
    return ops, nbytes


def k4_work(inside: float, total: float, rays: int, dims, intervals: int,
            baked: bool, a0: float) -> tuple[float, float]:
    """(float operations, bytes) of one a1 backward march at eps 0 (every
    sample of every ray): ``inside`` of the ``total`` samples lie in the
    dataset, the rest take alpha ``a0``; it reads the classes those
    samples need, the cotangent of every pixel and the colours, and writes
    dL/dcolors; baked, M and S at the sampled voxels."""
    voxels = math.prod(dims)
    ops = (inside * (FLOPS_PER_BWD_SAMPLE
                     + (FLOPS_PER_BWD_BAKED_SAMPLE if baked else 0))
           + bwd_outside_ops(total - inside, rays, a0)
           + rays * (intervals * FLOPS_PER_BWD_RAY_PER_INTERVAL
                     + FLOPS_PER_BWD_RAY))
    nbytes = (read_bytes(voxels * CLASS_BYTES, inside * CLASS_BYTES)
              + rays * PIXEL_BYTES + 2 * intervals * COLOR_BYTES)
    if baked:
        nbytes += read_bytes(voxels * BAKED_BYTES, inside * BAKED_BYTES)
    return ops, nbytes
