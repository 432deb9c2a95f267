"""The multi-device dry run (``parallel/dryrun.dryrun_multichip``, the
counterpart of ``__graft_entry__.dryrun_multichip``) on 8 spawned gloo
ranks on the CPU: both configs pass their gates, and rank 0's sharded
render and gradients (summed over the mesh) are held, at the dry run's own
gates, against the JAX package's single-device XLA scan and ``jax.grad``
of its ``render_loss`` on the same scenes: render within 1e-5 (config A)
and 1e-4 (config B), every gradient leaf within ``1e-4 * scale + 1e-7``.
The loss of config A's first Adam step equals the JAX dry run's within
rtol 1e-5 (MULTICHIP_r05.json: 0.039831)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.diff import fit as jfit
from volumerenderingproject_tpu.ingest import synthetic as jsynthetic
from volumerenderingproject_tpu.models.raycast import render_vrc
from volumerenderingproject_tpu.ops import phong as jphong

from volumerenderingproject_tpu_torch.parallel import dryrun

LIGHT_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
                "shininess")


def _jax_scene(n, width, height, spr):
    return (jsynthetic.centered_sphere(n), J.default_transfer_function(),
            J.Camera.initial(position=(0.3, 0.4, 0.9)),
            J.RenderConfig(width=width, height=height, samples_per_ray=spr))


def _jax_grads(params, tf, volume, camera, config):
    target = jnp.zeros((config.width, config.height, 4), jnp.float32)
    g = jax.grad(jfit.render_loss)(params, tf, volume, camera, target, config)
    out = {"tf_colors": g.tf_colors, "density_scale": g.density_scale}
    if g.tf_lower is not None:
        out.update(tf_lower=g.tf_lower, tf_upper=g.tf_upper)
    if g.light is not None:
        out.update({f"light.{k}": getattr(g.light, k) for k in LIGHT_FIELDS})
    return {k: np.asarray(v) for k, v in out.items()}


def _gate(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        err = float(np.abs(got[name].numpy() - w).max())
        scale = float(np.abs(w).max()) + 1e-8
        assert err <= 1e-4 * scale + 1e-7, (name, err, scale)


def test_dryrun_multichip_8_gloo_ranks_against_jax():
    out = dryrun.dryrun_multichip(8, device="cpu")
    assert dryrun._factorize(8) == (2, 2, 2)
    assert dryrun._axes_b(8) == (1, 2, 4)

    jv, jtf, jc, jcfg = _jax_scene(16, 16, 8, 8)
    want = np.asarray(render_vrc(jv, jtf, jc, jcfg, mode="fast"))
    a = out["a"]
    np.testing.assert_allclose(a["img"].numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(a["loss"], 0.039831, rtol=1e-5)
    _gate(a["grads"], _jax_grads(
        jfit.FitParams.init(jtf, light=jphong.default_light()), jtf, jv, jc,
        jcfg))

    jv, jtf, jc, jcfg = _jax_scene(24, 32, 16, 48)
    jcfg = dataclasses.replace(jcfg, interp=J.Interp.TRILINEAR,
                               lighting=True, tf_sharpness=40.0)
    want = np.asarray(render_vrc(jv, jtf, jc, jcfg, mode="fast"))
    b = out["b"]
    np.testing.assert_allclose(b["img"].numpy(), want, rtol=0, atol=1e-4)
    _gate(b["grads"], _jax_grads(jfit.FitParams.init(jtf, fit_bounds=True),
                                 jtf, jv, jc, jcfg))
    assert a["err"] == 0.0 and b["err"] < 1e-4
