"""Advantage-function parameterizations for the RACER family and NAF.

JAX re-expressions of source/smarties/Math/{Zero_advantage,
Discrete_advantage, Gaus_advantage, Quadratic_advantage}.h. All functions
are batched over leading axes; gradients wrt network outputs come from
jax.grad of these compute functions — with the policy-dependent factors
stop-gradient'd exactly where the reference's hand-written gradients treat
them as constants (the reference never backprops an advantage into the
policy head).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.ops.softplus import softplus

# ---------------------------------------------------------------------------
# Zero advantage (V-RACER): A == 0, no outputs (Zero_advantage.h:18-45)
# ---------------------------------------------------------------------------

def zero_n_outputs(n_act: int) -> int:
    return 0


# ---------------------------------------------------------------------------
# Discrete advantage (RACER-discrete): per-option head centered by the
# policy expectation (Discrete_advantage.h:25-80)
# ---------------------------------------------------------------------------

def discrete_n_outputs(n_opts: int) -> int:
    return n_opts


def discrete_advantage(adv_out, option, probs):
    """A(option) = adv[option] - sum_j pi_j adv_j.

    probs is stop-gradient'd: the reference grad is Qer*(onehot - probs)
    with probs constant (Discrete_advantage.h:49-57).
    """
    probs = jax.lax.stop_gradient(probs)
    a_sel = jnp.take_along_axis(adv_out, option[..., None], axis=-1)[..., 0]
    return a_sel - jnp.sum(probs * adv_out, axis=-1)


# ---------------------------------------------------------------------------
# Gaussian advantage (RACER-continuous): asymmetric Gaussian bump
# (Gaus_advantage.h:17-128); nL = 1 + 2*nA outputs [coef, p_hi, p_lo]
# ---------------------------------------------------------------------------

def gaussian_n_outputs(n_act: int) -> int:
    return 1 + 2 * n_act


def gaussian_initial_bias(n_act: int):
    """setInitial pushes [-1, 1, 1, ...] (Gaus_advantage.h:33-36)."""
    return [-1.0] + [1.0] * (2 * n_act)


def gaussian_advantage(adv_out, action, pol_mean, pol_var,
                       stop_policy_grad: bool = True):
    """A(a) = coef * (exp(-0.5 sum (a-m)^2/p_side) - mixRatio).

    adv_out: [..., 1+2nA] raw net outputs; action/pol_mean/pol_var [..., nA].
    pol_mean is the policy's effective (clamped) mean; by default both
    policy factors are stop-gradient'd — the reference's grad() writes
    only the advantage slice (Gaus_advantage.h:93-115; RACER trains the
    mean through the policy gradient instead). stop_policy_grad=False
    lets the gradient flow through the bump CENTER (but never the
    mix-ratio variance): the Gaussian-NAF mode, where Q-learning is the
    only mean-training signal (algos/naf.py, DEVIATIONS #21).
    """
    m = jax.lax.stop_gradient(pol_mean) if stop_policy_grad else pol_mean
    v = jax.lax.stop_gradient(pol_var)
    nA = m.shape[-1]
    coef = softplus(adv_out[..., 0])
    p_hi = softplus(adv_out[..., 1:1 + nA])
    p_lo = softplus(adv_out[..., 1 + nA:1 + 2 * nA])
    d = action - m
    p_side = jnp.where(d > 0, p_hi, p_lo)
    shape = -0.5 * jnp.sum(d * d / p_side, axis=-1)
    mix = (jnp.sqrt(p_hi / (p_hi + v)) + jnp.sqrt(p_lo / (p_lo + v))) / 2
    ratio = jnp.prod(mix, axis=-1)
    return coef * (jnp.exp(shape) - ratio)


# ---------------------------------------------------------------------------
# Quadratic advantage (NAF): -(a-m)^T L L^T (a-m) / 2 with lower-triangular
# L, SoftPlus diagonal (Quadratic_term.h, Quadratic_advantage.h)
# ---------------------------------------------------------------------------

def quadratic_n_outputs(n_act: int) -> int:
    """nL = nA*(nA+1)/2 matrix entries; the mean is a separate slice."""
    return n_act * (n_act + 1) // 2


def _build_L(l_out, n_act: int):
    """Pack the tril entries; diagonal through SoftPlus
    (Quadratic_term.h extract_L)."""
    idx = np.tril_indices(n_act)
    L = jnp.zeros(l_out.shape[:-1] + (n_act, n_act), l_out.dtype)
    L = L.at[..., idx[0], idx[1]].set(l_out)
    diag = softplus(jnp.diagonal(L, axis1=-2, axis2=-1))
    eye = jnp.eye(n_act, dtype=bool)
    return jnp.where(eye, diag[..., None, :] * jnp.eye(n_act), L)


def quadratic_advantage(l_out, mean_out, action, n_act: int,
                        pol_mean=None, pol_var=None):
    """A(a) = -0.5 (a-m)^T P (a-m) [+ centering when a policy is given],
    P = L L^T (Quadratic_advantage.h computeAdvantage).

    NAF uses the no-policy ctor (own mean, policy == nullptr); the optional
    centering matches the policy != nullptr branch.
    """
    L = _build_L(l_out, n_act)
    P = L @ jnp.swapaxes(L, -1, -2)
    d = (action - mean_out)[..., None]
    quad = (jnp.swapaxes(d, -1, -2) @ P @ d)[..., 0, 0]
    ret = -quad
    if pol_mean is not None:
        dp = (jax.lax.stop_gradient(pol_mean) - mean_out)[..., None]
        ret = ret + (jnp.swapaxes(dp, -1, -2) @ P @ dp)[..., 0, 0]
        ret = ret + jnp.sum(jnp.diagonal(P, axis1=-2, axis2=-1)
                            * jax.lax.stop_gradient(pol_var), axis=-1)
    return 0.5 * ret


def batched_adv_grad(adv_fn, adv_out, *args):
    """d(adv)/d(adv_out) per sample: vmapped grad of a scalar advantage."""
    g = jax.vmap(jax.grad(adv_fn))(adv_out, *args)
    return g
