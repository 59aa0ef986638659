"""Categorical policy over discrete options.

JAX re-expression of the reference's Discrete_policy_t<Func>
(source/smarties/Math/Discrete_policy.h): probabilities are *not* a softmax
but a Func-normalization: p_i = f(o_i) / sum_j f(o_j) with f = cheap SoftPlus
by default (Discrete_policy) or exp (Boltzmann variant used by soft DQN,
DQN.cpp:15-37).

All functions are batched with the option axis last; `option` action inputs
are int32 arrays of leading shape.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.ops.softplus import softplus, softplus_diff

_EPS = float(np.finfo(np.float32).eps)


def probs_of(outputs, fn="softplus"):
    """Net outputs -> (unnorm, norm, probs).

    Reference: extract_unnorm/compute_norm/extract_probabilities
    (Discrete_policy.h:56-77).
    """
    if fn == "softplus":
        un = softplus(outputs)
    elif fn == "exp":
        # subtract max for numerical stability: probs are scale-invariant in
        # exp space, and the reference's Exp variant is only used through
        # ratios, so this is exact for probs (not for unnorm itself).
        un = jnp.exp(outputs - jax.lax.stop_gradient(
            jnp.max(outputs, axis=-1, keepdims=True)))
    else:
        raise ValueError(fn)
    norm = jnp.maximum(jnp.sum(un, axis=-1, keepdims=True), _EPS)
    return un, norm, un / norm


def imp_weight(option, probs, mu):
    """rho = pi(option)/mu(option) (importanceWeight, :83-89)."""
    p = jnp.take_along_axis(probs, option[..., None], axis=-1)[..., 0]
    m = jnp.take_along_axis(mu, option[..., None], axis=-1)[..., 0]
    return p / m


def logprob(option, probs):
    p = jnp.take_along_axis(probs, option[..., None], axis=-1)[..., 0]
    return jnp.log(p)


def kl_mu_pi(mu, probs):
    """Reference KLDivergence(beta) computes sum_i p_i log(p_i/beta_i)
    which is DKL(pi || mu) for the discrete case (Discrete_policy.h:120-124).
    We keep the reference's exact formula."""
    return jnp.sum(probs * jnp.log(probs / jnp.maximum(mu, _EPS)), axis=-1)


def pol_grad(option, outputs, unnorm, norm, probs, coef, fn="softplus"):
    """Analytic d(coef * log pi(option)) / d(net outputs) [..., nO].

    Reference: policyGradient (Discrete_policy.h:126-137):
    g_i = f'(o_i) * coef * ( 1{i==option}/f(o_option) - 1/norm ).
    """
    nO = probs.shape[-1]
    onehot = jax.nn.one_hot(option, nO, dtype=probs.dtype)
    un_opt = jnp.take_along_axis(unnorm, option[..., None], axis=-1)
    g = coef[..., None] * (onehot / un_opt - 1.0 / norm)
    return g * _fn_diff(outputs, unnorm, fn)


def kl_grad(mu, outputs, unnorm, norm, probs, coef, fn="softplus"):
    """Analytic d(coef * KL) / d(net outputs).

    Reference: KLDivGradient (Discrete_policy.h:146-157):
    for each j: tmp_j = coef*(1+log(p_j/mu_j))/norm;
    g_i = f'(o_i) * sum_j tmp_j * (1{i==j} - p_j).
    """
    tmp = coef[..., None] * (1 + jnp.log(probs / jnp.maximum(mu, _EPS))) / norm
    # sum_j tmp_j * (delta_ij - p_j) = tmp_i - (sum_j tmp_j * p_j)
    g = tmp - jnp.sum(tmp * probs, axis=-1, keepdims=True)
    return g * _fn_diff(outputs, unnorm, fn)


def _fn_diff(outputs, unnorm, fn):
    if fn == "softplus":
        return softplus_diff(outputs)
    # d/do exp(o - c) = exp(o - c) (c is stop-gradient)
    return unnorm


def sample(key, probs):
    """Categorical draw over probs (Discrete_policy.h:169-177)."""
    return jax.random.categorical(key, jnp.log(jnp.maximum(probs, 1e-38)),
                                  axis=-1)


def select(key, probs, train: bool):
    """Sample when training, argmax otherwise (selectAction, :188-191)."""
    if train:
        return sample(key, probs)
    return jnp.argmax(probs, axis=-1)
