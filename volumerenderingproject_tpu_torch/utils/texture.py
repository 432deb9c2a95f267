"""Render-to-texture display: an offscreen render drawn through a textured
fullscreen quad.

The reference scaffolds an offscreen render-to-texture path
(``rendering_to_a_texture`` myApp.cu:1732-1901: FBO, colour texture and a
fullscreen quad drawn with 3.3.texture_shader.*) whose fragment shader
ships as a stub (solid blue).  These functions complete it: the image is
sampled at the window's pixel centres with GL_LINEAR filtering and
CLAMP_TO_EDGE, which decouples the render's resolution from the window's
(``render --window WxH``).

Counterpart of ``volumerenderingproject_tpu/utils/texture.py``; divisions
are by tensors, so the result is the same on the CPU and the GPU.
"""

from __future__ import annotations

import torch

from .device import const, resolve_device

_f32 = torch.float32


def sample_bilinear(tex: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """GL_LINEAR + CLAMP_TO_EDGE texture fetch.

    ``tex``: [W, H, C] canonical image (x = column, y = row from the top);
    ``u``/``v``: texture coordinates in [0, 1] of one shape, u along W, v
    along H.  Texel centres sit at (i + 0.5) / size, GL's convention.
    """
    w, h = tex.shape[0], tex.shape[1]
    # clamp to the edge before the floor, so that coordinates outside
    # weight the edge texel fully
    x = (u * w - 0.5).clamp(0.0, w - 1.0)
    y = (v * h - 0.5).clamp(0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    t00 = tex[x0i, y0i]
    t10 = tex[x1i, y0i]
    t01 = tex[x0i, y1i]
    t11 = tex[x1i, y1i]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def texture_quad_display(img, out_w: int, out_h: int) -> torch.Tensor:
    """Draw ``img`` [W, H, C] on a fullscreen quad of ``out_w`` x ``out_h``
    window pixels (UVs 0..1 across the quad, sampled at pixel centres) ->
    [out_w, out_h, C] on ``img``'s device."""
    tex = torch.as_tensor(img).to(_f32)
    dev = tex.device
    xs = torch.arange(out_w, dtype=_f32, device=dev)[:, None].expand(
        out_w, out_h)
    ys = torch.arange(out_h, dtype=_f32, device=dev)[None, :].expand(
        out_w, out_h)
    u = (xs + 0.5) / const(float(out_w), dev)
    v = (ys + 0.5) / const(float(out_h), dev)
    return sample_bilinear(tex, u, v)


def stub_blue(out_w: int, out_h: int, device=None) -> torch.Tensor:
    """The reference texture shader's shipped behaviour: a solid blue quad
    (3.3.texture_shader.fs stub) -> [out_w, out_h, 4] on ``device`` (CUDA
    unless given)."""
    img = torch.zeros((out_w, out_h, 4), dtype=_f32,
                      device=resolve_device(device))
    img[..., 2] = 1.0
    img[..., 3] = 1.0
    return img
