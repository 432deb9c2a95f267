"""The multi-device dry run: a sharded render and a full sharded training
step on tiny shapes, each held to the single-device one.

Counterpart of ``dryrun_multichip`` (the JAX package's
``__graft_entry__.py:39-211``), its two configs and its gates, on the
ranks of ``parallel/launch.spawn`` joined by gloo: on the CPU
(``device="cpu"``), or sharing the GPUs round robin (one card: every rank
on ``cuda:0``, the gathers through the host).

  * **Config A**: a mesh of ``_factorize(n)`` over (rays, samples,
    volume), the centred sphere of 8 planes a volume shard, 8 columns a
    rays shard, 8 rows, 4 samples a samples shard.  The sharded render
    within 1e-5 of the single-device scan; one Adam step (lr 1e-2) of the
    TF colours, the density and the default light's 10 parameters, its
    loss finite; every ``FitParams`` gradient of the sharded loss (summed
    over the mesh) within ``1e-4 * scale + 1e-7`` of the unsharded loss's,
    ``scale`` the largest magnitude of that leaf's unsharded gradient.
  * **Config B**: mesh ``_axes_b(n)``, a sphere of ``6 * max(volume, 3)``
    planes, 32 columns a rays shard, 16 rows, 24 samples a samples shard,
    smooth (``Interp.TRILINEAR``) and lit at ``tf_sharpness`` 40: the
    render within 1e-4, and the colour, density and interval-bound
    gradients within the same gate.

Every render and loss takes the default route, ``mode="auto"``: config A's
render the kernels' work units where they compute it, its light fit and
all of config B (smooth lit, which no kernel computes) the scan route, as
the JAX default takes its XLA scan there.  The single-device references
are the plain scan route, as the JAX dry run's are its XLA scan
(``render_vrc(mode="fast")``, ``render_loss`` without a mesh, on the
CPU): the render, and ``render_loss(mode="scan")``, which shades each
channel with its own light colour where the fused light fit bakes with
the mean colour (ROADMAP.md §3).  A failed gate raises on rank 0 and fails
the run; rank 0 prints the JAX package's ``OK`` lines.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from ..diff.fit import FitParams, make_optimizer, make_train_step, render_loss
from ..ingest import synthetic
from ..models.raycast import render
from ..ops.phong import default_light
from ..scene.camera import Camera
from ..scene.transfer_function import default_transfer_function
from ..utils.config import Interp, RenderConfig
from . import launch
from .mesh import make_mesh
from .render_dist import render_vrc_sharded

_f32 = torch.float32


def _factorize(n: int):
    """n -> (rays, samples, volume): 8 -> (2, 2, 2), 16 -> (4, 2, 2), 6 ->
    (3, 2, 1), a prime p -> (p, 1, 1) (__graft_entry__.py:67-77)."""
    axes = [1, 1, 1]
    slot = 2
    m = n
    for p in (2, 3, 5, 7, 11, 13):
        while m % p == 0 and slot >= 0:
            axes[slot] *= p
            m //= p
            slot = slot - 1 if slot > 0 else 0
    axes[0] *= m  # leftover primes go to rays
    return tuple(axes)


def _axes_b(n: int):
    """Config B's mesh (__graft_entry__.py:148-155)."""
    if n % 8 == 0:
        return (n // 8, 2, 4)
    if n % 4 == 0:
        return (n // 4, 2, 2)
    if n % 2 == 0:
        return (n // 2, 2, 1)
    return (n, 1, 1)


def _tiny_scene(n, width, height, spr, device):
    """__graft_entry__.py:8-23: the centred sphere, the default TF, the
    camera at (0.3, 0.4, 0.9)."""
    return (synthetic.centered_sphere(n, device=device),
            default_transfer_function(device),
            Camera.initial(position=(0.3, 0.4, 0.9), device=device),
            RenderConfig(width=width, height=height, samples_per_ray=spr))


def _grads(params: FitParams, loss: torch.Tensor, mesh=None) -> dict:
    """Every leaf's gradient by its field name (the light's as
    ``light.<field>``), summed over ``mesh``; zeros where none flowed."""
    loss.backward()
    names = ["tf_colors", "density_scale", "tf_lower", "tf_upper"]
    leaves = [getattr(params, k) for k in names]
    if params.light is not None:
        names += [f"light.{k}" for k in ("direction", "color", "ambient",
                                         "diffuse", "specular", "shininess")]
        leaves += list(params.light.fields())
    out = {}
    for name, p in zip(names, leaves):
        if p is None:
            continue
        g = torch.zeros_like(p) if p.grad is None else p.grad.detach()
        if mesh is not None:
            mesh.all_reduce_(g)
        out[name] = g
    return out


def _gate(label: str, g_mesh: dict, g_single: dict) -> None:
    """gerr <= 1e-4 * scale + 1e-7 for every leaf (__graft_entry__.py:
    123-131)."""
    for name, gs in g_single.items():
        gerr = float((g_mesh[name] - gs).abs().max())
        scale = float(gs.abs().max()) + 1e-8
        if not gerr <= 1e-4 * scale + 1e-7:
            raise AssertionError(f"{label}grad mismatch at {name}: err "
                                 f"{gerr} scale {scale}")


def _shape_dict(mesh) -> dict:
    return dict(zip(("rays", "samples", "volume"), mesh.shape))


def _rank(rank: int, world: int, device, out_path: str) -> None:
    dev = launch.rank_device(rank, "gloo", device)
    lead = rank == 0
    result = {}

    # ---- config A: the whole optimisable set, light included -----------
    t0 = time.perf_counter()
    rays, samples, vol = _factorize(world)
    mesh = make_mesh(rays=rays, samples=samples, volume=vol)
    volume, tf, camera, config = _tiny_scene(8 * vol, 8 * rays, 8,
                                             4 * samples, dev)
    img = render_vrc_sharded(volume, tf, camera, config, mesh)
    if tuple(img.shape) != (config.width, config.height, 4):
        raise AssertionError(f"sharded image shape {tuple(img.shape)}")
    err = None
    if lead:
        single = render(volume, tf, camera, config, mode="scan", device=dev)
        err = float((img - single).abs().max())
        if not err < 1e-5:
            raise AssertionError(f"sharded render mismatch: max err {err}")
    target = torch.zeros((config.width, config.height, 4), dtype=_f32,
                         device=dev)
    params = FitParams.init(tf, light=default_light(dev))
    step = make_train_step(tf, config, make_optimizer(params, 1e-2),
                           mesh=mesh)
    loss = float(step(params, volume, camera, target))
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"train step loss {loss}")
    params = FitParams.init(tf, light=default_light(dev))
    g_mesh = _grads(params, render_loss(params, tf, volume, camera, target,
                                        config, mesh), mesh)
    if lead:
        params = FitParams.init(tf, light=default_light(dev))
        _gate("", g_mesh, _grads(params, render_loss(
            params, tf, volume, camera, target, config, mode="scan")))
        result["a"] = dict(img=img.cpu(), err=err, loss=loss,
                           grads={k: g.cpu() for k, g in g_mesh.items()},
                           seconds=time.perf_counter() - t0)
        print(f"dryrun_multichip OK: mesh {_shape_dict(mesh)}, img "
              f"{tuple(img.shape)}, render max err {err:.2e}, grads match "
              f"unsharded, loss {loss:.6f}", flush=True)

    # ---- config B: smooth and lit, the halos and segments carry data ----
    t0 = time.perf_counter()
    rays_b, samples_b, vol_b = _axes_b(world)
    mesh_b = make_mesh(rays=rays_b, samples=samples_b, volume=vol_b)
    volume2, tf2, camera2, config2 = _tiny_scene(
        6 * max(vol_b, 3), 32 * rays_b, 16, 24 * samples_b, dev)
    config2 = config2.replace(interp=Interp.TRILINEAR, lighting=True,
                              tf_sharpness=40.0)
    img_b = render_vrc_sharded(volume2, tf2, camera2, config2, mesh_b)
    err_b = None
    if lead:
        single = render(volume2, tf2, camera2, config2, mode="scan",
                        device=dev)
        err_b = float((img_b - single).abs().max())
        if not err_b < 1e-4:
            raise AssertionError(f"config B sharded render mismatch: {err_b}")
    target_b = torch.zeros((config2.width, config2.height, 4), dtype=_f32,
                           device=dev)
    params_b = FitParams.init(tf2, fit_bounds=True)
    gb_mesh = _grads(params_b, render_loss(params_b, tf2, volume2, camera2,
                                           target_b, config2, mesh_b), mesh_b)
    if lead:
        params_b = FitParams.init(tf2, fit_bounds=True)
        _gate("config B ", gb_mesh, _grads(params_b, render_loss(
            params_b, tf2, volume2, camera2, target_b, config2,
            mode="scan")))
        result["b"] = dict(img=img_b.cpu(), err=err_b,
                           grads={k: g.cpu() for k, g in gb_mesh.items()},
                           seconds=time.perf_counter() - t0)
        print(f"dryrun_multichip config B OK: mesh {_shape_dict(mesh_b)}, "
              f"img {tuple(img_b.shape)} (2 ray tiles/dev), volume "
              f"{volume2.dims} ({vol_b} slabs, trilinear+lit halos), spr "
              f"{config2.samples_per_ray} ({samples_b} segments), render max "
              f"err {err_b:.2e}, bounds/colors/density grads match",
              flush=True)
        torch.save(result, out_path)


def dryrun_multichip(n_devices: int = 8, *, device=None) -> dict:
    """Run both configs on ``n_devices`` spawned gloo ranks (on the CPU
    with ``device="cpu"``, else sharing the GPUs) -> rank 0's results:
    ``{"a": {"img", "err", "loss", "grads", "seconds"}, "b": {...}}`` on
    the CPU, ``grads`` the sharded gradients by leaf.  A failed gate
    raises."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        launch.spawn(_rank, n_devices, "gloo", device, out)
        return torch.load(out, weights_only=True)


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     device=sys.argv[2] if len(sys.argv) > 2 else None)
