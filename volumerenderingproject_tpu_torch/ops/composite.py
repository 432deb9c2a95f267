"""Alpha compositing: the "over" operator in reference and associative forms.

Back-to-front, seeded at the background, output alpha forced to 1
(blendSampleColors kernel.cu:194-225):

    F = background
    for i = spr-1 .. 0:  F.rgb = F.rgb * (1 - a_i) + c_i.rgb * a_i

Front-to-back (C, T) form, identical math, which allows early termination:

    C = 0; T = 1
    for i = 0 .. spr-1:  C += T * a_i * c_i.rgb ; T *= (1 - a_i)
    out = (C + T * background.rgb, 1)
"""

from __future__ import annotations

from typing import Tuple

import torch

_f32 = torch.float32


def over_step_btf(acc_rgb: torch.Tensor, rgba: torch.Tensor) -> torch.Tensor:
    """One back-to-front over step: acc*(1-a) + c*a (kernel.cu:211-215)."""
    a = rgba[..., 3:4]
    return acc_rgb * (1.0 - a) + rgba[..., :3] * a


def composite_back_to_front(samples: torch.Tensor,
                            background) -> torch.Tensor:
    """Composite materialized samples [..., S, 4] -> [..., 4], iterating
    i = S-1 .. 0 like the reference kernel, from the background; alpha
    forced to 1 (composite.py:40)."""
    bg = torch.as_tensor(background, dtype=_f32, device=samples.device)
    batch = samples.shape[:-2]
    acc = bg[..., :3].expand(batch + (3,))
    for i in range(samples.shape[-2] - 1, -1, -1):
        acc = over_step_btf(acc, samples[..., i, :])
    alpha = torch.ones(batch + (1,), dtype=_f32, device=samples.device)
    return torch.cat([acc, alpha], dim=-1)


def composite_front_to_back(samples: torch.Tensor,
                            background) -> torch.Tensor:
    """Transmittance-form composite of materialized samples [..., S, 4] ->
    [..., 4] (the same result, composite.py:57), i = 0 .. S-1."""
    bg = torch.as_tensor(background, dtype=_f32, device=samples.device)
    batch = samples.shape[:-2]
    c, t = segment_identity(batch, samples.device)
    for i in range(samples.shape[-2]):
        c, t = segment_update((c, t), samples[..., i, :])
    rgb = c + t * bg[..., :3]
    alpha = torch.ones(batch + (1,), dtype=_f32, device=samples.device)
    return torch.cat([rgb, alpha], dim=-1)


def segment_identity(batch_shape, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, T) identity element: C = 0, T = 1."""
    batch_shape = tuple(batch_shape)
    return (
        torch.zeros(batch_shape + (3,), dtype=_f32, device=device),
        torch.ones(batch_shape + (1,), dtype=_f32, device=device),
    )


def segment_update(carry, rgba: torch.Tensor):
    """Absorb one sample (front-to-back) into a (C, T) segment state."""
    c, t = carry
    a = rgba[..., 3:4]
    return (c + t * a * rgba[..., :3], t * (1.0 - a))


def segment_compose(front, back):
    """Compose two (C, T) segments, ``front`` closer to the camera
    (composite.py:93): (C_f + T_f C_b, T_f T_b)."""
    cf, tf_ = front
    cb, tb = back
    return (cf + tf_ * cb, tf_ * tb)


def fold_segments(segs_c, segs_t, reverse=False):
    """Fold K gathered segments front to back with :func:`segment_compose`,
    from the identity, in index order, or in reverse where ``reverse`` holds
    (render_dist.py:48-62).  ``reverse`` is a Python bool, or a per-ray
    bool mask [..., 1]: then both orders are folded and each ray takes its
    own (conic rays on the volume axis, render_dist.py:623-650)."""
    if isinstance(reverse, torch.Tensor):
        asc = fold_segments(segs_c, segs_t, False)
        desc = fold_segments(segs_c, segs_t, True)
        return (torch.where(reverse, desc[0], asc[0]),
                torch.where(reverse, desc[1], asc[1]))
    k = len(segs_c)
    seg = segment_identity(segs_c[0].shape[:-1], segs_c[0].device)
    for i in (range(k - 1, -1, -1) if reverse else range(k)):
        seg = segment_compose(seg, (segs_c[i], segs_t[i]))
    return seg


def segment_finalize(seg, background) -> torch.Tensor:
    """Resolve a (C, T) segment against the background; alpha forced to 1."""
    c, t = seg
    bg = torch.as_tensor(background, dtype=_f32, device=c.device)
    rgb = c + t * bg[:3]
    alpha = torch.ones(c.shape[:-1] + (1,), dtype=_f32, device=c.device)
    return torch.cat([rgb, alpha], dim=-1)
