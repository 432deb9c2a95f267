"""Differentiable rendering: fit TF colours and a density scale to a target
image by gradient descent through the renderer.

Counterpart of ``volumerenderingproject_tpu/diff/fit.py`` on its plain a1
route (fit.py:212-215): the loss renders through
``ops/march_vjp.render_vrc_diff``, whose forward is the march kernel (K1) at
eps 0 and whose backward is the backward march kernel (K4) on the GPU.  The
optimizer is ``torch.optim.Adam`` with optax's defaults.  Checkpoints are
``torch.save`` files holding the parameters and the optimizer state, so a
resumed fit continues bit for bit where an uninterrupted one would be.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
item): fits of TF bounds (smooth mode, item 12), of light parameters (item
9), a5 fits (item 8), multichannel fits (item 10) and sharded fits over a
mesh (item 14).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.march_vjp import render_vrc_diff
from ..scene.transfer_function import TransferFunction
from ..utils.config import RenderConfig
from ..utils.device import resolve_device

_f32 = torch.float32


def _not_ported_bounds():
    return NotImplementedError(
        "fitting TF interval bounds is not ported yet: ROADMAP.md item 12 "
        "(smooth mode)")


def _not_ported_light():
    return NotImplementedError(
        "fitting light parameters is not ported yet: ROADMAP.md item 9 "
        "(lighting, LUT and scattering)")


@dataclasses.dataclass(frozen=True)
class FitParams:
    """The optimisable render parameters: ``tf_colors`` [K, 4] and the
    scalar ``density_scale``, leaf tensors that require grad.  The JAX
    package's ``tf_lower``/``tf_upper``/``light`` fields stay ``None``."""

    tf_colors: torch.Tensor
    density_scale: torch.Tensor
    tf_lower: Optional[torch.Tensor] = None
    tf_upper: Optional[torch.Tensor] = None
    light: Optional[object] = None

    def __post_init__(self):
        if self.tf_lower is not None or self.tf_upper is not None:
            raise _not_ported_bounds()
        if self.light is not None:
            raise _not_ported_light()

    @staticmethod
    def init(tf: TransferFunction, *, fit_bounds: bool = False,
             light=None) -> "FitParams":
        if fit_bounds:
            raise _not_ported_bounds()
        if light is not None:
            raise _not_ported_light()
        return FitParams(
            tf_colors=tf.colors.detach().to(_f32).clone().requires_grad_(),
            density_scale=torch.tensor(1.0, dtype=_f32,
                                       device=tf.colors.device,
                                       requires_grad=True))

    def parameters(self) -> List[torch.Tensor]:
        return [self.tf_colors, self.density_scale]


def _apply_params(tf: TransferFunction, params: FitParams
                  ) -> TransferFunction:
    return TransferFunction(lower=tf.lower, upper=tf.upper,
                            colors=params.tf_colors, hg_g=tf.hg_g)


def render_loss(params: FitParams, tf: TransferFunction, volume, camera,
                target: torch.Tensor, config: RenderConfig,
                mesh=None) -> torch.Tensor:
    """MSE between the differentiable render and the target image, on the
    device that holds the volume."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded fits are not ported yet: ROADMAP.md item 14 (parallel)")
    tf2 = _apply_params(tf, params)
    zero = torch.zeros((), dtype=_f32, device=params.density_scale.device)
    density = torch.maximum(params.density_scale, zero)  # jnp.clip(d, 0, None)
    img = _render_with_density(volume, tf2, camera, config, density,
                               params.light)
    return torch.mean((img[..., :3] - target[..., :3]) ** 2)


def _render_with_density(volume, tf: TransferFunction, camera,
                         config: RenderConfig, density: torch.Tensor,
                         light=None) -> torch.Tensor:
    """Scale the TF alphas by the (differentiable) density, then render
    through the differentiable march (fit.py:124-131, 212-215)."""
    if light is not None:
        raise _not_ported_light()
    colors = torch.cat([tf.colors[:, :3], tf.colors[:, 3:4] * density], dim=1)
    tf2 = TransferFunction(lower=tf.lower, upper=tf.upper, colors=colors,
                           hg_g=tf.hg_g)
    return render_vrc_diff(volume, tf2, camera, config,
                           device=volume.data.device)


def make_optimizer(params: FitParams, learning_rate: float
                   ) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(params.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, foreach=False)


def make_train_step(tf: TransferFunction, config: RenderConfig,
                    optimizer: torch.optim.Optimizer, mesh=None):
    """A train step ``(params, volume, camera, target) -> loss``: one
    forward and one backward march, then one update of ``optimizer``, which
    holds ``params``' tensors and its own state."""

    def step(params: FitParams, volume, camera, target) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = render_loss(params, tf, volume, camera, target, config, mesh)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit_transfer_function(volume, camera, target, tf: TransferFunction,
                          config: RenderConfig, *, steps: int = 100,
                          learning_rate: float = 1e-2, mesh=None,
                          checkpoint_dir: Optional[str] = None,
                          checkpoint_every: int = 0, resume: bool = False,
                          fit_bounds: bool = False, light=None,
                          device=None) -> Tuple[FitParams, list]:
    """Optimise TF colours and density against ``target`` [W, H, 4] on
    ``device`` (CUDA unless given) -> (params, per-step losses).

    ``resume=True`` restores the latest checkpoint in ``checkpoint_dir``
    (parameters and optimizer state) and continues up to ``steps`` steps in
    all; every ``checkpoint_every`` steps a checkpoint is written."""
    dev = resolve_device(device)
    volume, camera, tf = volume.to(dev), camera.to(dev), tf.to(dev)
    if not isinstance(target, torch.Tensor):
        target = torch.tensor(np.asarray(target), dtype=_f32)
    target = target.to(device=dev, dtype=_f32)
    params = FitParams.init(tf, fit_bounds=fit_bounds, light=light)
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
    train_step = make_train_step(tf, config, optimizer, mesh)

    losses = []
    for i in range(start, steps):
        loss = train_step(params, volume, camera, target)
        losses.append(float(loss))
        if checkpoint_dir and checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, i + 1, params, optimizer)
    return params, losses


# -- checkpoint / resume -----------------------------------------------------


def _checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}.pt")


def save_checkpoint(directory: str, step: int, params: FitParams,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Write the parameters (and the optimizer's state) at ``step``."""
    os.makedirs(directory, exist_ok=True)
    state = {"params": {"tf_colors": params.tf_colors.detach().cpu(),
                        "density_scale": params.density_scale.detach().cpu()}}
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
    p = state["params"]
    params = FitParams(
        tf_colors=p["tf_colors"].to(dev).requires_grad_(),
        density_scale=p["density_scale"].to(dev).requires_grad_())
    if not with_optimizer:
        return params
    return params, state["opt"]
