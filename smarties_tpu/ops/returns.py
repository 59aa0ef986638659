"""Return estimators: Retrace, Retrace+exploration-bonus, GAE.

JAX re-expression of the reference's backward recursions
(source/smarties/ReplayMemory/MemoryProcessing.cpp:391-458):

  Retrace:  Qret[t] = rr[t+1] + g*( V[t+1]
                      + lam * min(1, rho[t+1]) * (Qret[t+1]-A[t+1]-V[t+1]) )
  GAE:      Qret[t] = rr[t+1] + g*( V[t+1] + lam * (Qret[t+1]-V[t+1]) )

with Qret[T] = 0 for terminal episodes and V[T] for truncated ones
(updateReturnEstimator, MemoryProcessing.cpp:23-44). rr is the scaled reward.

The reference walks pointer-linked episodes with OpenMP; here a single
masked reverse lax.scan handles one fixed-length episode slot, vmapped over
the slot axis of the replay ring — variable episode lengths are handled with
a static max length L and per-slot length T.

Array layout (state-indexed, length L+1 along time):
  r[t]   : reward received on arriving at state t (r[0] == 0)
  V[t]   : V(s_t); == 0 at a terminal state T (Episode.h assertions)
  A[t]   : advantage of the taken action; == 0 at t == T
  rho[t] : importance weight pi/mu; == 0 at t == T (Episode::finalize
           sets offPolicImpW.back()=0, Episode.cpp:255-256)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from functools import partial


def episode_return_estimate(r_scaled, value, advantage, rho, length,
                            terminal, gamma, lam, mode="retrace",
                            err_baseline=0.0):
    """Backward return recursion for ONE episode slot.

    Args:
      r_scaled:  [L+1] scaled rewards (already (r - mean) * scale)
      value:     [L+1] V(s_t)
      advantage: [L+1] A(s_t, a_t)
      rho:       [L+1] importance weights
      length:    scalar int32, number of transitions T (states 0..T valid)
      terminal:  scalar bool, episode reached a true terminal state
      mode:      'retrace' | 'retraceExplore' | 'GAE' (static)
      err_baseline: scalar for retraceExplore (stats.maxAbsError)
    Returns:
      qret: [L+1]; qret[t] for t>T is 0.
    """
    L = r_scaled.shape[0] - 1
    bootstrap = jnp.where(terminal, 0.0, value[length])

    if mode in ("retrace", "GAE"):
        # The recursion is affine in Qret[t+1]:
        #   Qret[t] = a_t + b_t * Qret[t+1]
        # with (retrace)  a_t = rr[t+1] + g*(V[t+1] - lam*c[t+1]*(A+V)[t+1]),
        #                 b_t = g*lam*c[t+1]
        #      (GAE)      a_t = rr[t+1] + g*(1-lam)*V[t+1],  b_t = g*lam.
        # Affine maps compose associatively, so the whole backward sweep is
        # a log-depth suffix composition (associative_scan reverse=True)
        # instead of an O(L) sequential scan — the latency-critical path at
        # episode commit time (rollout hot loop).
        idx = jnp.arange(L + 1)
        if mode == "GAE":
            a = r_scaled + gamma * (1 - lam) * value
            b = jnp.full((L + 1,), gamma * lam, r_scaled.dtype)
        else:
            c_w = jnp.minimum(rho, 1.0)
            a = r_scaled + gamma * (value - lam * c_w * (advantage + value))
            b = gamma * lam * c_w
        # element t holds the map for Qret[t-1] -> uses entries at t; shift
        # so elem_t maps Qret[t] from Qret[t+1]:
        a = jnp.roll(a, -1)
        b = jnp.roll(b, -1)
        # boundary & masking: at t == length the map is (bootstrap, 0);
        # beyond the episode it is (0, 0)
        a = jnp.where(idx < length, a, jnp.where(idx == length,
                                                 bootstrap, 0.0))
        b = jnp.where(idx < length, b, 0.0)

        # flip so the suffix composition becomes a prefix scan; the operator
        # composes the NEWER (higher-t, i.e. inner) map on the right:
        # out_k = g_k o out_{k-1} with g_k = f_{L-k}
        af, bf = jnp.flip(a), jnp.flip(b)

        def compose(left, right):
            a_l, b_l = left
            a_r, b_r = right
            return a_r + b_r * a_l, b_r * b_l

        qf, _ = jax.lax.associative_scan(compose, (af, bf))
        qret = jnp.flip(qf)
        return jnp.where(idx <= length, qret, 0.0)

    def body(carry, t):
        # value at t+1 of the recursion; at the episode tail use bootstrap
        q_tp1 = jnp.where(t + 1 == length, bootstrap, carry)
        c_w = jnp.minimum(rho[t + 1], 1.0)  # clippedOffPolW (Episode.h:191-194)
        if mode == "GAE":
            q = r_scaled[t + 1] + gamma * (
                value[t + 1] + lam * (q_tp1 - value[t + 1]))
        else:
            q = r_scaled[t + 1] + gamma * (
                value[t + 1]
                + lam * c_w * (q_tp1 - advantage[t + 1] - value[t + 1]))
            if mode == "retraceExplore":
                # MemoryProcessing.cpp:402-408
                e = (jnp.abs(q_tp1 - advantage[t + 1] - value[t + 1])
                     - err_baseline)
                q = (1 - gamma) * e + q
        q = jnp.where(t < length, q, 0.0)
        return q, q

    ts = jnp.arange(L - 1, -1, -1)
    _, qs_rev = jax.lax.scan(body, jnp.float32(0.0), ts)
    qret = jnp.flip(qs_rev)  # qs_rev is ordered t=L-1..0
    qret = jnp.concatenate([qret, jnp.zeros((1,), qret.dtype)])
    # write the bootstrap at t == T (returnEstimator.back(), MP.cpp:32-35)
    qret = jnp.where(jnp.arange(L + 1) == length, bootstrap, qret)
    return qret


def batched_return_estimate(r_scaled, value, advantage, rho, length,
                            terminal, gamma, lam, mode="retrace",
                            err_baseline=0.0):
    """Batched backward recursion over the episode-slot axis: the
    per-episode estimator vmapped over slots (retrace/GAE as a log-depth
    associative scan, retraceExplore as the sequential scan)."""
    fn = partial(episode_return_estimate, gamma=gamma, lam=lam, mode=mode,
                 err_baseline=err_baseline)
    return jax.vmap(fn)(r_scaled, value, advantage, rho, length, terminal)
