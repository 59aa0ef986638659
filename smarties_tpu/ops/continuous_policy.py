"""Diagonal Gaussian policy, with optionally tanh-squashed (bounded) dims.

JAX re-expression of the reference's Continuous_policy
(source/smarties/Math/Continuous_policy.h): per-dim NormalPolicy (:68-210)
for unbounded action dims and SquashedNormalPolicy (:212-390) for bounded
dims, selected per-dim by jnp.where on a static bounded mask.

Everything is batched over arbitrary leading axes; the action-dim axis is
last. Network outputs a raw mean vector and a raw stdev vector; the stdev is
mapped through the reference's cheap SoftPlus (softplus.py).

Gradients of the training objective wrt the *network outputs* are computed
analytically — exactly the formulas of gradLogP / gradKLdiv
(Continuous_policy.h:146-175, :303-338) including the squashed-policy
anti-NaN clamps — and are then pulled back through the network with jax.vjp.
This mirrors the reference's mechanism (setGradient on the output layer then
backProp, Network.h:155-193) one-to-one.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.ops.softplus import softplus, softplus_diff, softplus_inv

# tanh(MEAN_MAX) == 1 - float32 eps; squashed-policy mean is clamped here
# (Continuous_policy.h:218-223 "anti NaN").
MEAN_MAX = 8.31776613503286
# Gaussian exploration noise is clipped to +-NORMDIST_MAX (Bund.h:100).
NORMDIST_MAX = 3.0
# log(2 pi)/2 (Continuous_policy.h:93)
_LOG_SQRT_2PI = 0.9189385332046727
_F32_TINY = float(np.finfo(np.float32).tiny)
# importance-weight log clip (Continuous_policy.h:648-653)
_LOGW_CLIP = 7.0


def sigma_of(sigma_raw):
    """Raw net output -> stdev via cheap SoftPlus (Continuous_policy.h:79)."""
    return softplus(sigma_raw)


def initial_sigma_raw(expl_noise):
    """Net bias producing stdev == explNoise (initial_Stdev, :179,:343).
    explNoise == 0 (pure-deterministic, e.g. CMA without action noise) is
    clamped to float eps like the reference's setInitial_Stdev guard
    (Continuous_policy.h:603-608)."""
    import numpy as _np
    return softplus_inv(max(float(expl_noise), float(_np.finfo(_np.float32).eps)))


def eff_mean(mean, bounded):
    """Mean used for logprob/sampling: clamped for squashed dims
    (SquashedNormalPolicy::getMean, Continuous_policy.h:218-223)."""
    b = jnp.asarray(bounded)
    return jnp.where(b, jnp.clip(mean, -MEAN_MAX, MEAN_MAX), mean)


def _logprob_dims(act, m_eff, sigma, bounded):
    """Per-dim log pi(a). Squashed dims add the -log J Jacobian term
    (SquashedNormalPolicy::logProb, Continuous_policy.h:241-249)."""
    inv_s = 1.0 / sigma
    arg = -jnp.square((act - m_eff) * inv_s) / 2
    base = arg + jnp.log(inv_s) - _LOG_SQRT_2PI
    squash = jnp.tanh(act)
    jac = jnp.maximum(1 - squash * squash, _F32_TINY)
    b = jnp.asarray(bounded)
    return jnp.where(b, base - jnp.log(jac), base)


def logprob(act, mean, sigma, bounded):
    """Total log pi(a) summed over dims (evalLogProbability, :675-680)."""
    m_eff = eff_mean(mean, bounded)
    return jnp.sum(_logprob_dims(act, m_eff, sigma, bounded), axis=-1)


def logprob_mu(act, mu, bounded):
    """log mu(a) for a stored behavior vector mu=[means, stdevs].

    Stored means are already clamped (getVector uses getMean, :745-752)."""
    n = mu.shape[-1] // 2
    m, s = mu[..., :n], mu[..., n:]
    return jnp.sum(_logprob_dims(act, m, s, bounded), axis=-1)


def imp_weight(act, mean, sigma, mu, bounded):
    """rho = pi(a)/mu(a) with log-space clip to +-7
    (importanceWeight, Continuous_policy.h:648-653)."""
    logw = logprob(act, mean, sigma, bounded) - logprob_mu(act, mu, bounded)
    return jnp.exp(jnp.clip(logw, -_LOGW_CLIP, _LOGW_CLIP))


# The reference compiles with SMARTIES_OPPOSITE_KL defined (Bund.h:43), so
# the penalized divergence is DKL(pi || mu). Both directions are provided;
# OPPOSITE_KL selects the reference default.
OPPOSITE_KL = True


def kl_div(mu, mean, sigma, opposite=OPPOSITE_KL):
    """KL divergence between pi and the stored behavior mu.

    opposite=True  -> DKL(pi||mu) (reference default, Bund.h:43 defines
                      SMARTIES_OPPOSITE_KL; Continuous_policy.h:135-138)
    opposite=False -> DKL(mu||pi) (Continuous_policy.h:131-134)
    Uses the *unclamped* mean, as the reference does.
    """
    n = mu.shape[-1] // 2
    m_mu, s_mu = mu[..., :n], mu[..., n:]
    if opposite:
        c = jnp.square(sigma / s_mu)
        dm = jnp.square((mean - m_mu) / s_mu)
    else:
        inv_s = 1.0 / sigma
        c = jnp.square(s_mu * inv_s)
        dm = jnp.square((mean - m_mu) * inv_s)
    return jnp.sum((c - 1 + dm - jnp.log(c)) / 2, axis=-1)


def pol_grad(act, mean, sigma, sigma_raw, coef, bounded):
    """Analytic d(coef * log pi(a)) / d(net outputs).

    Returns (d_mean_out, d_sigma_raw_out), each [..., nA]. coef is [...].
    Reference: NormalPolicy::gradLogP (:146-154) and
    SquashedNormalPolicy::gradLogP (:303-322) incl. anti-NaN gating of the
    mean gradient when the mean has saturated.
    """
    coef = coef[..., None]
    inv_s = 1.0 / sigma
    m_eff = eff_mean(mean, bounded)
    b = jnp.asarray(bounded)
    # mean grad uses the raw mean for squashed dims (:308)
    d_mean = coef * (act - mean) * inv_s * inv_s
    # stdev grad uses the effective (clamped) mean for squashed dims (:309)
    u = (act - m_eff) * inv_s
    d_sig = softplus_diff(sigma_raw) * coef * (u * u - 1) * inv_s
    # anti-NaN: zero the mean grad if it would push a saturated mean further
    sat_hi = jnp.logical_and(mean >= MEAN_MAX, d_mean > 0)
    sat_lo = jnp.logical_and(mean <= -MEAN_MAX, d_mean < 0)
    gated = jnp.where(jnp.logical_or(sat_hi, sat_lo), 0.0, d_mean)
    d_mean = jnp.where(b, gated, d_mean)
    return d_mean, d_sig


def kl_grad(mu, mean, sigma, sigma_raw, coef, opposite=OPPOSITE_KL):
    """Analytic d(coef * KL) / d(net outputs).

    Reference: gradKLdiv (Continuous_policy.h:156-170, :324-338); the
    opposite branch (DKL(pi||mu)) is the compile default (Bund.h:43). Same
    formula for both per-dim variants.
    """
    n = mu.shape[-1] // 2
    m_mu, s_mu = mu[..., :n], mu[..., n:]
    coef = coef[..., None]
    dm = mean - m_mu
    if opposite:
        inv_var_mu = 1.0 / (s_mu * s_mu)
        d_mean = coef * dm * inv_var_mu
        d_sig = (softplus_diff(sigma_raw) * coef
                 * (inv_var_mu - 1.0 / (sigma * sigma)) * sigma)
    else:
        inv_s = 1.0 / sigma
        var, var_mu = sigma * sigma, s_mu * s_mu
        d_mean = coef * dm * inv_s * inv_s
        d_sig = (softplus_diff(sigma_raw) * coef
                 * (var - var_mu - dm * dm) * inv_s * inv_s * inv_s)
    return d_mean, d_sig


def clipped_normal(key, shape, dtype=jnp.float32):
    """N(0,1) noise; draws beyond +-NORMDIST_MAX are replaced by a uniform
    draw in [-NORMDIST_MAX, NORMDIST_MAX]
    (sampleClippedGaussian, Continuous_policy.h:184-191)."""
    k1, k2 = jax.random.split(key)
    z = jax.random.normal(k1, shape, dtype)
    u = jax.random.uniform(k2, shape, dtype,
                           minval=-NORMDIST_MAX, maxval=NORMDIST_MAX)
    return jnp.where(jnp.abs(z) > NORMDIST_MAX, u, z)


def sample(key, mean, sigma, bounded, share_agents: int = 1):
    """Draw a learner-space action. Squashed dims clip to +-MEAN_MAX
    (SquashedNormalPolicy::sample, Continuous_policy.h:355-359).

    share_agents > 1: consecutive groups of that many leading rows share
    ONE noise draw — the reference's bAgentsShareNoise tic/toc scheme
    (Agent::sampleActionNoise, Agent.h:315-342) for multi-agent envs."""
    m_eff = eff_mean(mean, bounded)
    if share_agents > 1:
        g = mean.shape[0] // share_agents
        z = clipped_normal(key, (g, 1) + mean.shape[1:], mean.dtype)
        z = jnp.broadcast_to(z, (g, share_agents) + mean.shape[1:]
                             ).reshape(mean.shape)
    else:
        z = clipped_normal(key, mean.shape, mean.dtype)
    a = m_eff + sigma * z
    b = jnp.asarray(bounded)
    return jnp.where(b, jnp.clip(a, -MEAN_MAX, MEAN_MAX), a)


def sample_with_noise(noise, mean, sigma, bounded):
    """Same as sample() given precomputed noise (shared-noise mode,
    Agent::sampleActionNoise, Agent.h:315-342)."""
    m_eff = eff_mean(mean, bounded)
    a = m_eff + sigma * noise
    b = jnp.asarray(bounded)
    return jnp.where(b, jnp.clip(a, -MEAN_MAX, MEAN_MAX), a)


def sample_ou(noise, ou_state, mean, sigma, bounded):
    """Ornstein-Uhlenbeck correlated exploration
    (sample_OrnsteinUhlenbeck, Continuous_policy.h:198-205): the persistent
    per-agent state accumulates 0.85 * previous. Returns (action, new_state).
    """
    force = 0.85 * ou_state
    new_state = noise + force
    m_eff = eff_mean(mean, bounded)
    a = m_eff + sigma * new_state
    b = jnp.asarray(bounded)
    a = jnp.where(b, jnp.clip(a, -MEAN_MAX, MEAN_MAX), a)
    return a, new_state


def mu_vector(mean, sigma, bounded):
    """Behavior-policy vector stored into replay: [means..., stdevs...]
    with squashed means clamped (getVector, Continuous_policy.h:745-752)."""
    return jnp.concatenate([eff_mean(mean, bounded), sigma], axis=-1)
