"""Scenes shared by the a5 span tests (test_torch_a5_range.py) and the K6
fold tests (test_torch_a5_fold.py): a seeded odd volume, the default TF
with a chosen TF(0).alpha, small a5 configurations (orbits, a camera inside
the volume, fronts along an axis, rays that miss, a step longer than a
voxel, a 512-deep volume), the units of a (2, 2, 1) mesh, and rays stepped
an ulp at a time across each face of the box.  No JAX."""

import numpy as np
import torch

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch.ops import a5
from volumerenderingproject_tpu_torch.utils.config import Algorithm


def odd(shape=(13, 17, 20)):
    """A seeded volume of ``shape``, intensities in [-30, 255), cal_max
    200.9."""
    rng = np.random.default_rng(1)
    return P.make_volume(rng.uniform(-30, 255, shape).astype(np.float32),
                         cal_max=200.9, device="cpu")


def tf(alpha0=0.0):
    """The default TF with TF(0).alpha = ``alpha0``."""
    d = P.default_transfer_function(device="cpu")
    c = d.colors.clone()
    c[0, 3] = alpha0
    return P.TransferFunction(d.lower, d.upper, c, d.hg_g)


def cfg(w, h, spr, **kw):
    """An a5 configuration of w x h rays of spr samples."""
    return P.RenderConfig(width=w, height=h, samples_per_ray=spr,
                          algorithm=Algorithm.TEST, **kw)


# name -> (camera position, volume shape, config)
SCENES = {
    "orbit": ((1.5 * np.cos(0.7), 0.4, 1.5 * np.sin(0.7)), (13, 17, 20),
              cfg(25, 17, 40)),
    "orbit_low": ((-1.2, -0.9, 0.5), (13, 17, 20), cfg(25, 17, 40)),
    "near": ((0.35, 0.45, 0.85), (13, 17, 20), cfg(31, 19, 30)),
    "inside": ((0.05, -0.1, 0.12), (13, 17, 20), cfg(21, 15, 32)),
    "front_z": ((0.0, 0.0, 1.5), (13, 17, 20), cfg(21, 15, 32)),
    "front_x": ((1.5, 0.0, 0.0), (13, 17, 20), cfg(21, 15, 32)),
    "miss": ((3.0, 2.5, -0.2), (13, 17, 20), cfg(21, 15, 32)),
    # 7 samples over the viewplane distance: a step of ~6 voxels
    "coarse_step": ((1.5 * np.cos(0.7), 0.4, 1.5 * np.sin(0.7)),
                    (13, 17, 20), cfg(25, 17, 7)),
    # L = 512: a voxel is 1/512 of the ray space
    "deep": ((0.004, 0.002, 1.5), (9, 11, 512),
             cfg(17, 13, 512, view_angle=0.012)),
}


def scene(name, alpha0=0.0, eps=0.0, **unit):
    """The a5 march input of scene ``name`` (``unit``: a work unit's
    keywords of ``a5.prepare_a5``)."""
    pos, shape, c = SCENES[name]
    return a5.prepare_a5(odd(shape), tf(alpha0),
                         P.Camera.initial(position=pos, device="cpu"), c,
                         eps, **unit)


def units(name):
    """The (2, 2, 1) mesh's units of scene ``name``: global columns and a
    window of samples each."""
    c = SCENES[name][2]
    w, spr = c.width, c.samples_per_ray
    hw, hs = w // 2, spr // 2
    return [dict(x_offset=xr * hw, local_width=hw if xr == 0 else w - hw,
                 s_start=sr * hs, s_count=hs if sr == 0 else spr - hs,
                 segment=True) for xr in (0, 1) for sr in (0, 1)]


def face_args(face: int, side: int, slope: float, alpha0=0.0, eps=0.0):
    """32x4 rays of 40 samples that cross face ``face`` (side 0: the low
    face p = 0, 1: the high one p = dim) of the odd volume's box, one ulp
    of the face's plane apart from column to column.  The stage matrices
    are set so that on axis ``face`` p2 = (px 2^-25 + (i s3) slope) + c,
    ``slope`` the axis's share of the rays' direction (0: parallel to the
    face), with the middle ray at the face at the middle sample; the next
    axis carries the rays through the volume, the third holds them inside
    it.  modelCam and toVolume keep their structural zeros."""
    w, spr = 32, 40
    a = a5.prepare_a5(odd(), tf(alpha0), P.Camera.initial(
        position=SCENES["orbit"][0], device="cpu"), cfg(w, 4, spr), eps)
    s = a.scal.clone()
    f32 = np.float32
    L = f32(max(a.dims))
    m3 = [f32(s[a5.S_TV + 4 * c + 3]) for c in range(3)]
    s1, s2, s3 = f32(2.0 ** -25), f32(1e-3), f32(-2.0 / spr)
    mc = np.zeros((3, 4), f32)
    mc[0, 0], mc[1, 1], mc[2, 2] = s1, s2, s3
    iv = np.zeros((3, 4), f32)
    nxt, third = (face + 1) % 3, (face + 2) % 3
    plane = (f32(a.dims[face]) if side else f32(0.0)) - m3[face]
    p2_face = f32(plane / L)  # p2 at the face, up to its rounding
    iv[face, 0] = 1.0
    iv[face, 2] = slope
    iv[face, 3] = f32(p2_face - f32(f32((w // 2) * s1) + f32(
        f32((spr // 2) * s3) * f32(slope))))
    iv[nxt, 2] = 1.0  # p2 runs from 1 to -1: across the whole box
    iv[nxt, 3] = 1.0
    iv[third, 1] = 1.0  # py 1e-3: inside, near the middle
    s[a5.S_MC:a5.S_MC + 12] = torch.from_numpy(mc.reshape(-1))
    s[a5.S_IV:a5.S_IV + 12] = torch.from_numpy(iv.reshape(-1))
    return a._replace(scal=s)


FACES = [(f, side, slope) for f in range(3) for side in (0, 1)
         for slope in (0.3, 1e-5, 1e-7, 0.0)]


# one slope for each face and side, each slope on two of them
FACE_CASES = [FACES[k * 4 + k % 4] for k in range(6)]
