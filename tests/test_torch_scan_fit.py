"""Port parity, the scan route for fits (diff/fit.py ``mode="scan"``,
models/raycast.py's checkpointed scan), a1 nearest-voxel and
``Interp.TRILINEAR_COLOR`` configs: ``render_loss(mode="scan")`` and its
gradients against ``jax.value_and_grad`` of the JAX package's
``render_loss`` on each family of configs that no differentiable kernel
computes, ``fast`` raising on each, naming ``mode='scan'``
(tests/_torch_scan_scenes.py: the scene, the cases, the tolerances).  The
a5 and smooth families are in tests/test_torch_scan_fit_a5_smooth.py;
3-step fits, the checkpointed scan against the unchunked one,
``Interp.TRILINEAR_COLOR`` renders and the CLI in
tests/test_torch_scan_fit_steps.py."""

import pytest

import _torch_scan_scenes as S

A1_CASES = sorted(n for n in S.CASES if n not in S.A5_SMOOTH_CASES)


@pytest.mark.parametrize("name", A1_CASES)
def test_scan_loss_and_grads_match_jax(name):
    """The loss and every parameter's gradient through the port's scan route
    against ``jax.value_and_grad`` of the JAX ``render_loss``; the fast
    route raises, naming ``mode='scan'``."""
    S.check_case(name)
