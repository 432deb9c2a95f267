"""Port parity, the scan route for fits (diff/fit.py ``mode="scan"``), a5
and smooth-mode configs: ``render_loss(mode="scan")`` and its gradients
(the TF colours, the density, the smooth bounds, the light) against
``jax.value_and_grad`` of the JAX package's ``render_loss`` on each family
of a5 and smooth configs that no differentiable kernel computes, ``fast``
raising on each, naming ``mode='scan'`` (tests/_torch_scan_scenes.py: the
scene, the cases, the tolerances)."""

import pytest

import _torch_scan_scenes as S


@pytest.mark.parametrize("name", sorted(S.A5_SMOOTH_CASES))
def test_scan_loss_and_grads_match_jax(name):
    """The loss and every parameter's gradient through the port's scan route
    against ``jax.value_and_grad`` of the JAX ``render_loss``; the fast
    route raises, naming ``mode='scan'``."""
    S.check_case(name)
