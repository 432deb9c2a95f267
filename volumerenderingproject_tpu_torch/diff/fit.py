"""Differentiable rendering: fit TF colours, a density scale and, in smooth
mode, the TF interval bounds, and the light's parameters, to a target image
by gradient descent through the renderer.

Counterpart of ``volumerenderingproject_tpu/diff/fit.py`` on its fused a1
routes (fit.py:173-194, 212-215: plain, lit, LUT and scattered colour fits,
and light fits), its multichannel route (fit.py:160-172: the alpha column
of a 4-D volume's fit), its smooth-mode route (fit.py:195-211) and its
unlit a5 route (fit.py:134-145): the loss renders through
``ops/march_vjp.render_vrc_diff`` (forward the march kernel K1 at eps 0,
backward the backward march kernel K4 on the GPU, in its plain, baked-light,
LUT, LUT + baked-light or channel variant; with a light, K4 baked plus 11
tangent marches of K1 baked; with scattering, ``render_vrc_scatter_diff``:
K4 baked plus 1 + K tangent marches of K1 baked), with ``Interp.TRILINEAR``
through ``ops/smooth_vjp.render_vrc_smooth_diff`` (K8 and K9, no volume
gradient),
or, with ``Algorithm.TEST``, through ``ops/a5_vjp.render_test_diff`` (K3
and K6).  The optimizer is ``torch.optim.Adam`` with optax's defaults.
Checkpoints are ``torch.save`` files holding the parameters and the
optimizer state, so a resumed fit continues bit for bit where an
uninterrupted one would be.

``fit_bounds=True`` adds ``tf_lower``/``tf_upper`` to the parameters.  Only
the smooth classify gives them a gradient: with nearest-voxel sampling
their gradient is zero almost everywhere, here and in the JAX package, and
they do not move.  ``light`` (an ``ops.phong.Light``) adds its six fields,
the 10 light parameters.

With ``mesh`` (a ``parallel.mesh.Mesh``; JAX fit.py:85-121, 229-247) every
rank of a process group renders its work unit of the image through
``parallel/render_dist.render_vrc_sharded(differentiable=True)`` (K1 and
K4 at the unit's offsets, or K3 and K6; the TF colours, the density and,
on the rays and samples axes, the light's 10 parameters train), holds the
whole target and computes the same loss; after ``loss.backward()`` each
parameter's gradient is summed over the mesh (``Mesh.all_reduce_``), so
every rank takes the same Adam step and the parameters stay replicated.

``mode="auto"`` (the default) takes the kernels wherever they
differentiate the config (:func:`diff_refusal`) and the scan route
otherwise, as the JAX package's ``_render_with_density`` does, and logs the
route once a call (``models/raycast.resolve_mode``).  ``mode="scan"`` is
the scan route: every config, the kernels' ones
included, renders through the plain scans (``models/raycast.render_vrc``
/ ``render_test``, the JAX package's XLA scan fallback, fit.py:124-226)
under autograd, checkpointed in chunks of samples, and with ``mesh``
through the scan segments and the volume-axis slab scan.  ``mode="fast"``
runs the kernels above and raises, naming ``mode='scan'``,
for what only the JAX package's XLA scan fits: conic lit fits, light fits
of a5, smooth, 4-D, conic, LUT or scattered renders or from a non-uniform
light colour, scattered fits of a5, smooth, conic or LUT renders, lit a5
fits, 4-D fits other than the ortho, unlit, nearest-voxel a1 alpha-column
fit, smooth fits with lighting, scattering, a LUT or ``density_scale !=
1``, fits of more than 16 intervals and ``Interp.TRILINEAR_COLOR`` fits.
The scan route follows the JAX scan: a light fit shades each channel with
its own light colour, where the fused route bakes with the mean colour.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import raycast
from ..ops import a5_vjp, march_vjp, smooth
from ..ops.a5_vjp import render_test_diff
from ..parallel import render_dist
from ..parallel.render_dist import render_vrc_sharded
from ..ops.march_vjp import render_vrc_diff, render_vrc_scatter_diff
from ..ops.phong import Light
from ..ops.smooth_vjp import render_vrc_smooth_diff
from ..scene.transfer_function import TransferFunction
from ..utils.config import Algorithm, Interp, RenderConfig
from ..utils.device import resolve_device

_f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class FitParams:
    """The optimisable render parameters, leaf tensors that require grad:
    ``tf_colors`` [K, 4], the scalar ``density_scale``, for a bound fit
    ``tf_lower``/``tf_upper`` [K], and for a light fit ``light``, an
    ``ops.phong.Light`` whose six fields are leaves (``None`` where not
    fitted)."""

    tf_colors: torch.Tensor
    density_scale: torch.Tensor
    tf_lower: Optional[torch.Tensor] = None
    tf_upper: Optional[torch.Tensor] = None
    light: Optional[Light] = None

    @staticmethod
    def init(tf: TransferFunction, *, fit_bounds: bool = False,
             light: Optional[Light] = None) -> "FitParams":
        dev = tf.colors.device

        def leaf(t):
            return t.detach().to(dev, _f32).clone().requires_grad_()

        return FitParams(
            tf_colors=leaf(tf.colors),
            density_scale=torch.tensor(1.0, dtype=_f32, device=dev,
                                       requires_grad=True),
            tf_lower=leaf(tf.lower) if fit_bounds else None,
            tf_upper=leaf(tf.upper) if fit_bounds else None,
            light=None if light is None else Light(
                *(leaf(t) for t in light.fields())))

    def parameters(self) -> List[torch.Tensor]:
        """The parameter tensors, in the JAX pytree's leaf order (the
        light's fields last, in ``Light``'s field order)."""
        light = () if self.light is None else self.light.fields()
        return [p for p in (self.tf_colors, self.density_scale,
                            self.tf_lower, self.tf_upper, *light)
                if p is not None]


def _apply_params(tf: TransferFunction, params: FitParams
                  ) -> TransferFunction:
    return TransferFunction(
        lower=tf.lower if params.tf_lower is None else params.tf_lower,
        upper=tf.upper if params.tf_upper is None else params.tf_upper,
        colors=params.tf_colors, hg_g=tf.hg_g)


def _check_mode(mode: str) -> None:
    if mode not in ("auto", "fast", "scan"):
        raise ValueError(f"unknown mode {mode!r}: a fit takes 'auto', "
                         "'fast' or 'scan'")


def diff_refusal(volume, tf: TransferFunction, config: RenderConfig,
                 light: Optional[Light] = None) -> Optional[str]:
    """Why :func:`_render_with_density`'s ``mode="fast"`` would refuse this
    fit (the message of the differentiable march's check that raises), or
    None where kernels differentiate it, by the same dispatch: a 4-D a1
    volume, a scattered render or a fitted ``light`` through
    ``ops/march_vjp`` (``check_scatter_fit_supported``,
    ``check_light_fit_supported``, ``check_diff_supported``), then a5
    (``ops/a5_vjp.check_diff_supported``), smooth mode
    (``ops/smooth.check_smooth_supported``) and the nearest-voxel a1
    march."""
    ch, k = volume.channels, tf.num_intervals
    test = config.algorithm is Algorithm.TEST
    try:
        if (ch > 1 and not test) or config.scattering or light is not None:
            if config.scattering:
                march_vjp.check_scatter_fit_supported(config, ch, k, light)
            elif light is not None:
                march_vjp.check_light_fit_supported(config, ch, k, light)
            else:
                march_vjp.check_diff_supported(config, ch, k)
        elif test:
            a5_vjp.check_diff_supported(config, ch, k)
        elif config.interp is Interp.TRILINEAR:
            smooth.check_smooth_supported(config, k, None, ch)
        else:
            march_vjp.check_diff_supported(config, ch, k)
    except NotImplementedError as e:
        return str(e)
    return None


def render_loss(params: FitParams, tf: TransferFunction, volume, camera,
                target: torch.Tensor, config: RenderConfig,
                mesh=None, mode: str = "auto") -> torch.Tensor:
    """MSE between the differentiable render and the target image, on the
    device that holds the volume; with ``mesh``, the sharded render of this
    rank's mesh; ``mode`` the route (the module docstring; ``"auto"``
    resolved and logged once a call)."""
    _check_mode(mode)
    if mesh is None:
        mode = raycast.resolve_mode(
            mode, lambda: diff_refusal(volume, tf, config, params.light),
            "fit")
    tf2 = _apply_params(tf, params)
    zero = torch.zeros((), dtype=_f32, device=params.density_scale.device)
    density = torch.maximum(params.density_scale, zero)  # jnp.clip(d, 0, None)
    if mesh is None:
        img = _render_with_density(volume, tf2, camera, config, density,
                                   params.light, mode)
    else:
        # fit.py:97-119: the density folds into the alphas, and the sharded
        # render differentiates through the kernels' work units
        colors = torch.cat([tf2.colors[:, :3], tf2.colors[:, 3:4] * density],
                           dim=1)
        tf3 = TransferFunction(lower=tf2.lower, upper=tf2.upper,
                               colors=colors, hg_g=tf2.hg_g)
        img = render_vrc_sharded(volume, tf3, camera, config, mesh,
                                 mode=mode, differentiable=True,
                                 light=params.light)
    return torch.mean((img[..., :3] - target[..., :3]) ** 2)


def _render_with_density(volume, tf: TransferFunction, camera,
                         config: RenderConfig, density: torch.Tensor,
                         light=None, mode: str = "fast") -> torch.Tensor:
    """Scale the TF alphas by the (differentiable) density, then render.
    ``mode="scan"`` renders every config through the plain scan
    (``render_test`` for a5, ``render_vrc`` otherwise, with ``light``;
    fit.py:152-153, 171-172, 185-186, 193-194, 226), under autograd and
    checkpointed in chunks of samples.  ``mode="fast"`` renders through the
    differentiable march of ``config.algorithm`` and ``config.interp``
    (fit.py:124-215): nearest-voxel a1 folds
    ``config.density_scale`` in as well and takes lit and LUT configs, and
    with ``light`` shades with it, differentiably; scattered configs take
    the scatter route first (a1 ortho, no LUT, the light static), except
    that an a1 4-D volume takes the multichannel route before it, as in
    the JAX package (fit.py:160-172); smooth
    a1 takes it only at 1 (the JAX package's smooth kernels do too), with
    no volume gradient; a5 reads none and samples its own way whatever
    ``config.interp`` says.  A config the fused marches do not fit raises,
    naming ``mode='scan'``."""
    colors = torch.cat([tf.colors[:, :3], tf.colors[:, 3:4] * density], dim=1)
    tf2 = TransferFunction(lower=tf.lower, upper=tf.upper, colors=colors,
                           hg_g=tf.hg_g)
    if mode == "scan":
        scan = (raycast.render_test if config.algorithm is Algorithm.TEST
                else raycast.render_vrc)
        return scan(volume, tf2, camera, config, light=light)
    if volume.channels > 1 and config.algorithm is Algorithm.VRC:
        # fit.py:160-172; render_vrc_diff checks what it fits
        return render_vrc_diff(volume, tf2, camera, config,
                               device=volume.data.device, light=light)
    if config.scattering:  # fit.py:173-186, before the light's route
        return render_vrc_scatter_diff(volume, tf2, camera, config,
                                       device=volume.data.device, light=light)
    if light is not None:  # fit.py:187-194; render_vrc_diff checks it
        return render_vrc_diff(volume, tf2, camera, config,
                               device=volume.data.device, light=light)
    if config.algorithm is Algorithm.TEST:
        diff = render_test_diff
    elif config.interp is Interp.TRILINEAR:
        diff = render_vrc_smooth_diff
    else:
        diff = render_vrc_diff
    return diff(volume, tf2, camera, config, device=volume.data.device)


def make_optimizer(params: FitParams, learning_rate: float
                   ) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(params.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, foreach=False)


def make_train_step(tf: TransferFunction, config: RenderConfig,
                    optimizer: torch.optim.Optimizer, mesh=None,
                    mode: str = "auto"):
    """A train step ``(params, volume, camera, target) -> loss``: one
    forward and one backward march (or scan, with ``mode="scan"``), then
    one update of ``optimizer``, which holds ``params``' tensors and its own
    state.  With ``mesh`` every gradient is summed over the mesh before the
    update."""

    def step(params: FitParams, volume, camera, target) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = render_loss(params, tf, volume, camera, target, config, mesh,
                           mode)
        loss.backward()
        if mesh is not None:
            # every rank builds the same graph, so a gradient is None on
            # every rank or on none
            for p in params.parameters():
                if p.grad is not None:
                    mesh.all_reduce_(p.grad)
        optimizer.step()
        return loss.detach()

    return step


def fit_transfer_function(volume, camera, target, tf: TransferFunction,
                          config: RenderConfig, *, steps: int = 100,
                          learning_rate: float = 1e-2, mesh=None,
                          checkpoint_dir: Optional[str] = None,
                          checkpoint_every: int = 0, resume: bool = False,
                          fit_bounds: bool = False, light=None,
                          device=None, mode: str = "auto"
                          ) -> Tuple[FitParams, list]:
    """Optimise TF colours and density (and with ``fit_bounds`` the interval
    bounds, with ``light`` the light's parameters, starting from it) against
    ``target`` [W, H, 4] on ``device`` (CUDA unless given) -> (params,
    per-step losses), through the kernels (``mode="fast"``) or the scan
    route (``mode="scan"``; the module docstring).

    ``resume=True`` restores the latest checkpoint in ``checkpoint_dir``
    (parameters and optimizer state) and continues up to ``steps`` steps in
    all; every ``checkpoint_every`` steps a checkpoint is written.  With
    ``mesh`` every rank of it calls this with the whole target, and the rank
    at (0, 0, 0) writes the checkpoints (the parameters are replicated)."""
    _check_mode(mode)
    dev = resolve_device(device)
    volume, camera, tf = volume.to(dev), camera.to(dev), tf.to(dev)
    if not isinstance(target, torch.Tensor):
        target = torch.tensor(np.asarray(target), dtype=_f32)
    target = target.to(device=dev, dtype=_f32)
    params = FitParams.init(tf, fit_bounds=fit_bounds,
                            light=None if light is None else light.to(dev))
    opt_state = None
    start = 0
    if resume and checkpoint_dir:
        latest = latest_checkpoint_step(checkpoint_dir)
        if latest is not None:
            params, opt_state = load_checkpoint(
                checkpoint_dir, latest, with_optimizer=True, device=dev)
            start = latest
    optimizer = make_optimizer(params, learning_rate)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    if mesh is None:
        refusal = (lambda: diff_refusal(volume, tf, config, params.light))
    else:
        refusal = (lambda: render_dist.sharded_refusal(
            volume, tf, config, mesh.shape, params.light, True))
    mode = raycast.resolve_mode(mode, refusal, "fit")
    train_step = make_train_step(tf, config, optimizer, mesh, mode)

    losses = []
    for i in range(start, steps):
        loss = train_step(params, volume, camera, target)
        losses.append(float(loss))
        if (checkpoint_dir and checkpoint_every
                and (i + 1) % checkpoint_every == 0
                and (mesh is None or mesh.coords == (0, 0, 0))):
            save_checkpoint(checkpoint_dir, i + 1, params, optimizer)
    return params, losses


# -- checkpoint / resume -----------------------------------------------------


def _checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}.pt")


def save_checkpoint(directory: str, step: int, params: FitParams,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Write the parameters (the bounds too in a bound fit, the light's
    fields under ``light`` in a light fit, as the JAX package's checkpoint
    does) and the optimizer's state at ``step``."""
    os.makedirs(directory, exist_ok=True)
    state = {"params": {
        name: getattr(params, name).detach().cpu()
        for name in ("tf_colors", "density_scale", "tf_lower", "tf_upper")
        if getattr(params, name) is not None}}
    if params.light is not None:
        state["params"]["light"] = {
            f.name: getattr(params.light, f.name).detach().cpu()
            for f in dataclasses.fields(Light)}
    if optimizer is not None:
        state["opt"] = optimizer.state_dict()
    path = _checkpoint_path(directory, step)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)


def latest_checkpoint_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)\.pt", f))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, with_optimizer: bool = False,
                    device=None):
    """Read a checkpoint -> FitParams on ``device`` (CUDA unless given),
    or (FitParams, the optimizer's state dict) with ``with_optimizer``."""
    dev = resolve_device(device)
    state = torch.load(_checkpoint_path(directory, step), map_location=dev,
                       weights_only=True)
    p = dict(state["params"])
    light = p.pop("light", None)
    if light is not None:
        light = Light(**{k: t.to(dev).requires_grad_()
                         for k, t in light.items()})
    params = FitParams(**{name: t.to(dev).requires_grad_()
                          for name, t in p.items()}, light=light)
    if not with_optimizer:
        return params
    return params, state["opt"]
