"""Space-to-depth first-conv equivalence (models/net.py _s2d_stride).

The Mnih-style strided first conv over few stacked frames is re-expressed
as a stride-1 conv over s*s-blocked channels (deeper contraction). Same index
set summed in a different order: forward and parameter gradients must
match the direct conv to fp tolerance, for both the flat-CHW input path
and the pre-shaped NHWC path, f32 and bf16.

Reference conv semantics: Conv2D_Descriptor (Definitions.h:60-69) /
Conv2DLayer valid-padding strided conv.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smarties_tpu.models.net import Conv2DDesc, NetSpec, _s2d_stride, \
    apply_net, init_params

CONV = (Conv2DDesc(12, 12, 4, 8, 4, 2), Conv2DDesc(5, 5, 8, 8, 3, 1))


def _spec(**kw):
    return NetSpec(n_in=12 * 12 * 4, hidden=(16,), n_out=3,
                   conv=CONV, **kw)


def _run(spec, x):
    params = init_params(jax.random.PRNGKey(0), spec)

    def f(p):
        return jnp.sum(jnp.sin(apply_net(p, spec, x)[0]))

    y, g = jax.value_and_grad(f)(params)
    return apply_net(params, spec, x)[0], y, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2d_matches_direct_conv(dtype):
    spec = _spec(compute_dtype=dtype)
    assert _s2d_stride(CONV[0]) == 2
    x = jax.random.normal(jax.random.PRNGKey(1), (6, spec.n_in))
    out_s2d, y_s2d, g_s2d = _run(spec, x)
    os.environ["SMT_NO_S2D"] = "1"
    try:
        assert _s2d_stride(CONV[0]) == 0
        out_ref, y_ref, g_ref = _run(spec, x)
    finally:
        del os.environ["SMT_NO_S2D"]
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out_s2d, out_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(y_s2d, y_ref, rtol=tol, atol=tol)
    for a, b in zip(jax.tree_util.tree_leaves(g_s2d),
                    jax.tree_util.tree_leaves(g_ref)):
        np.testing.assert_allclose(a, b, rtol=5 * tol, atol=5 * tol)


def test_s2d_nhwc_input_bit_matches_flat():
    """The rank-4 NHWC input path and the flat-CHW path block into the
    SAME tensor (pure permutations), so with s2d on they stay bitwise
    identical — the invariant tests/test_nhwc_gather.py relies on."""
    spec = _spec()
    params = init_params(jax.random.PRNGKey(0), spec)
    c0 = CONV[0]
    xn = jax.random.normal(jax.random.PRNGKey(2),
                           (6, c0.in_h, c0.in_w, c0.in_c))
    # flat layout is [frame0; frame1; ...] == CHW
    xf = jnp.transpose(xn, (0, 3, 1, 2)).reshape(6, -1)
    out_n = apply_net(params, spec, xn)[0]
    out_f = apply_net(params, spec, xf)[0]
    np.testing.assert_array_equal(np.asarray(out_n), np.asarray(out_f))


def test_s2d_not_applied_when_indivisible():
    assert _s2d_stride(Conv2DDesc(13, 13, 4, 8, 4, 2)) == 0   # 13 % 2
    assert _s2d_stride(Conv2DDesc(12, 12, 4, 8, 3, 2)) == 0   # 3 % 2
    assert _s2d_stride(Conv2DDesc(12, 12, 4, 8, 3, 1)) == 0   # unstrided
    assert _s2d_stride(Conv2DDesc(12, 12, 32, 8, 4, 2)) == 0  # deep in_c
