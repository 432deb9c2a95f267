"""Breaks planted under the timed path, for the tests that show the
comparison failing them.  Each is a context manager that patches the
program's module attributes which the drivers call through:
``volumerenderingproject_tpu_torch.render`` (orbit) and
``diff.fit.fit_transfer_function`` / ``make_optimizer`` / ``render_loss``
(fit).  The control, the benchmark's reference in bfloat16, is each
driver's ``control_answers``.

Kinds: ``stale`` a step that returns its state unchanged (the previous
frame again; an optimizer step that moves nothing); ``half`` half of the
batch left out (half of a frame's rays left at the background; a loss
whose mean is over half of the pixels); ``altered`` an answer altered where
it is produced (one pixel of every frame; the first loss of every job).
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("stale", "half", "altered")
PIXEL_STEP = 0.05  # ``altered``: added to one channel of one pixel
LOSS_FACTOR = 1.1  # ``altered``: one loss of a job scaled by this


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def orbit(kind: str):
    """Break ``render`` as ``kind`` says, for as long as the block runs."""
    import volumerenderingproject_tpu_torch as P

    orig = P.render
    last = {}

    def broken(volume, tf, camera, config, **kw):
        img = orig(volume, tf, camera, config, **kw)
        if kind == "stale":
            prev = last.get("img")
            last["img"] = img
            return img if prev is None else prev
        img = img.clone()
        if kind == "half":
            w = img.shape[0] // 2
            img[w:] = torch.tensor(config.background, device=img.device)
        elif kind == "altered":
            img[img.shape[0] // 2, img.shape[1] // 2, 0] += PIXEL_STEP
        return img

    with _patched(P, "render", broken):
        yield


@contextlib.contextmanager
def fit(kind: str):
    """Break a fit job as ``kind`` says, for as long as the block runs."""
    from volumerenderingproject_tpu_torch.diff import fit as F
    from volumerenderingproject_tpu_torch.models import raycast

    if kind == "stale":
        orig_opt = F.make_optimizer

        def still(params, lr):
            opt = orig_opt(params, lr)
            opt.step = lambda *a, **k: None
            return opt

        with _patched(F, "make_optimizer", still):
            yield
    elif kind == "half":
        render_with_density = F._render_with_density

        def half_loss(params, tf, volume, camera, target, config, mesh=None,
                      mode="auto"):
            mode = raycast.resolve_mode(mode, lambda: F.diff_refusal(
                volume, tf, config, params.light), "fit")
            density = torch.clamp_min(params.density_scale, 0.0)
            img = render_with_density(volume, F._apply_params(tf, params),
                                      camera, config, density, params.light,
                                      mode)
            w = img.shape[0] // 2
            return torch.mean((img[:w, :, :3] - target[:w, :, :3]) ** 2)

        with _patched(F, "render_loss", half_loss):
            yield
    elif kind == "altered":
        orig_fit = F.fit_transfer_function

        def altered(*a, **k):
            params, losses = orig_fit(*a, **k)
            losses = list(losses)
            losses[0] *= LOSS_FACTOR
            return params, losses

        with _patched(F, "fit_transfer_function", altered):
            yield
    else:
        raise ValueError(f"unknown fault {kind!r}")

