"""Common learner machinery shared by all algorithms.

Factorization of what the reference spreads across Learner /
Learner_approximator / MiniBatch (source/smarties/Learners/Learner*.cpp,
ReplayMemory/MiniBatch.h): minibatch gather, per-step replay write-backs,
and the per-grad-step ReF-ER/annealing bookkeeping.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from smarties_tpu.models.net import apply_net, init_carry
from smarties_tpu.replay import buffer as rb

F32 = jnp.float32


# ----------------------------------------------------------------------
# Truncated-BPTT window machinery shared by every recurrent learner
# (the reference builds per-sample windows [t - nnBPTTseq, t + 2) with a
# zeroed recurrent context at the window start for ALL algorithms via
# MemoryBuffer::sampleMinibatch + Network::backProp,
# MemoryBuffer.cpp:393-402, Network.h:155-193).


def bptt_window(rs: rb.ReplayState, ep, t, W: int):
    """Standardized state inputs over the window [t-W+1, t+1].

    Returns (xs [B, W+1+1=window, dimS], active [B, window]) where the
    last two positions are the sampled step t and its successor t+1;
    positions before the episode start are masked inactive (each replay
    slot holds exactly one episode, so t < 0 is the only boundary).
    """
    offs = jnp.arange(-W + 1, 2)
    tw = t[:, None] + offs[None, :]                   # [B, W+1]
    active = tw >= 0
    twc = jnp.clip(tw, 0, rs.max_len)
    xs = (rs.states[ep[:, None], twc]
          - rs.state_mean) * rs.state_scale           # [B, W+1, dimS]
    xs = jnp.where(active[..., None], xs, 0.0)
    return xs, active


def seq_outputs(params, spec, xs, active):
    """Scan a recurrent net over a [B, T] window from a zero carry,
    holding the carry where `active` is False. Differentiable (usable
    inside loss closures). Returns (out_t, out_t1) — the outputs at the
    last two window positions (the sampled step and its successor)."""
    carry0 = init_carry(spec, (xs.shape[0],))
    xs_t = jnp.moveaxis(xs, 1, 0)                     # [T, B, d]
    m_t = jnp.moveaxis(active, 1, 0)                  # [T, B]

    def step(c, inp):
        x, m = inp
        y, c2 = apply_net(params, spec, x, c)
        c2 = jax.tree_util.tree_map(
            lambda a, b: jnp.where(m[:, None], a, b), c2, c)
        return c2, y

    _, ys = jax.lax.scan(step, carry0, (xs_t, m_t))
    return ys[-2], ys[-1]


def seq_forward_vjp(params, spec, xs, active):
    """vjp wrapper of seq_outputs: returns (out_t, stop_grad(out_t1),
    pullback) where pullback(g) backpropagates a cotangent at the sampled
    step t through the whole window (reverse BPTT, Network.h:155-193)."""
    (out_t, out_t1), vjp_fn = jax.vjp(
        lambda p: seq_outputs(p, spec, xs, active), params)

    def pullback(g):
        return vjp_fn((g, jnp.zeros_like(out_t1)))[0]

    return out_t, jax.lax.stop_gradient(out_t1), pullback


class MiniBatch(NamedTuple):
    """Gathered view of B sampled transitions (MiniBatch.h:60-123)."""
    ep: jnp.ndarray          # [B] episode slot
    t: jnp.ndarray           # [B] time index
    s_t: jnp.ndarray         # [B, dimS] standardized state
    s_t1: jnp.ndarray        # [B, dimS] standardized next state
    action: jnp.ndarray      # [B, dimA]
    mu: jnp.ndarray          # [B, dimPol]
    qret: jnp.ndarray        # [B] stored return estimate
    reward_next: jnp.ndarray  # [B] scaled reward r_{t+1}
    is_last: jnp.ndarray     # [B] t+1 == T
    terminal_next: jnp.ndarray   # [B] t+1 is a true terminal state
    truncated_next: jnp.ndarray  # [B] t+1 is a truncation point
    per_w: jnp.ndarray       # [B] PER importance weight (1 for uniform)
    # sample points at a stored transition; False only when a replay SHARD
    # is empty (multi-device) — such rows contribute zero gradient and no
    # write-backs (the reference never samples invalid data; per-shard
    # starvation is additionally curbed by buffer.rebalance_shards)
    valid: jnp.ndarray = None   # [B] bool
    # stored values at gather time, riding along in the same packed-record
    # gather: rho for the incremental far-count delta in write_back, V for
    # PPO's acting-time baseline (both were separate gathers pre-packing)
    rho_old: jnp.ndarray = None  # [B]
    value_old: jnp.ndarray = None  # [B]
    # the full gathered records at t and t+1 — write_back/write_next_value
    # re-emit their fixed channels so the hot writes stay FULL-row
    # scatters (see replay/buffer.py layout notes)
    row_t: jnp.ndarray = None    # [B, R]
    row_t1: jnp.ndarray = None   # [B, R]


def presample_uniform(keys, rs: rb.ReplayState, batch: int,
                      axis_name=None):
    """Precompute per-step uniform sample indices for a whole train
    chunk OUTSIDE the scan body: one vmapped batch of RNG draws instead
    of per-iteration split + randint inside it. Bit-identical to
    the in-body path: same key-derivation chain
    (fold_in by shard -> split(key, 1)[0] -> sample_uniform), and the
    sampling inputs (samp_cl) only change at commit/refresh boundaries,
    never inside a train chunk. Returns (ep [n, B], t [n, B])."""

    def one(k):
        if axis_name is not None:
            k = jax.random.fold_in(k, jax.lax.axis_index(axis_name))
        ks, = jax.random.split(k, 1)
        return rb.sample_uniform(ks, rs, batch)

    return jax.vmap(one)(keys)


def stacked_states(rs: rb.ReplayState, ep, t, n_appended: int):
    """Standardized net input with appended past observations
    (Episode::standardizedState, Episode.h:171-183): frames ordered
    [obs_t, obs_{t-1}, ...], clamped at the episode start."""
    if n_appended == 0:
        return (rs.states[ep, t] - rs.state_mean) * rs.state_scale
    offs = jnp.arange(n_appended + 1)
    tj = jnp.maximum(t[:, None] - offs[None, :], 0)       # [B, k+1]
    frames = (rs.states[ep[:, None], tj]
              - rs.state_mean) * rs.state_scale           # [B, k+1, dimS]
    return frames.reshape(frames.shape[0], -1)


def nhwc_probe_hw(spec, mdp):
    """(H, W) when the NHWC-direct conv gather probe is enabled
    (SMT_NHWC_GATHER=1), else None. Opt-in until measured against the
    flat path on the GPU (ROADMAP D4): the uint8 frame-axis transpose
    replaces the flat path's in-net f32 transpose. Bit-parity tests:
    tests/test_nhwc_gather.py."""
    import os
    if (spec.conv and mdp.n_appended_obs and not spec.is_recurrent
            and os.environ.get("SMT_NHWC_GATHER")):
        return (spec.conv[0].in_h, spec.conv[0].in_w)
    return None


def gather_minibatch(rs: rb.ReplayState, ep, t,
                     per_w: Optional[jnp.ndarray] = None,
                     n_appended: int = 0,
                     nhwc_hw: Optional[tuple] = None) -> MiniBatch:
    """nhwc_hw=(H, W): emit s_t/s_t1 as NHWC [B, H, W, k+1] conv inputs
    instead of flat rows (frame-stacked image envs only). The frame axis
    moves to channels while still uint8 (1-byte transpose), then
    standardization promotes once — the flat path's f32 reshape +
    CHW->NHWC transpose inside the net (2x the bytes, twice) disappears.
    Values are bit-identical; apply_net consumes rank-4 inputs as-is."""
    t1 = jnp.minimum(t + 1, rs.max_len)
    # ONE fused gather total when the replay packs states into the
    # record (small-dim f32 envs, buffer._ch layout notes); otherwise
    # TWO:
    #  1. states at t and t+1 fused into one gather
    #  2. the packed per-step record at t and t+1 fused into one gather
    #     (action/mu/qret/rho/value at t; reward at t+1; the slot-meta
    #     MIRROR channels give length/ep_id/terminal with no third
    #     gather — buffer._ch layout notes)
    B = ep.shape[0]
    if n_appended:
        # the t and t+1 frame stacks share k of k+1 frames: ONE gather
        # of the union window [t+1, t, ..., t-k] then slice — 37.5%
        # fewer gathered rows + conversions than two stacks.
        # Values are identical to two stacked_states calls.
        offs = jnp.arange(-1, n_appended + 1)
        tj = jnp.maximum(t[:, None] - offs[None, :], 0)   # [B, k+2]
        if nhwc_hw is not None:
            H, W = nhwc_hw
            raw = rs.states[ep[:, None], tj]              # [B, k+2, H*W]
            fr = jnp.moveaxis(raw.reshape(B, -1, H, W), 1, -1)
            frames = (fr - rs.state_mean.reshape(H, W, 1)) \
                * rs.state_scale.reshape(H, W, 1)         # [B,H,W,k+2]
            # channel j holds frame t+1-j: s_t = channels [1, k+1],
            # s_t1 = channels [0, k] (newest-first stacking order)
            s_t = frames[..., 1:]
            s_t1 = frames[..., :-1]
        else:
            frames = (rs.states[ep[:, None], tj]
                      - rs.state_mean) * rs.state_scale
            s_t = frames[:, 1:].reshape(B, -1)
            s_t1 = frames[:, :-1].reshape(B, -1)
        rows = rs.steps[jnp.concatenate([ep, ep]),
                        jnp.concatenate([t, t1])]      # [2B, R]
    elif rs.dim_state_packed:
        # the raw state row rides inside the record: ONE gather
        rows = rs.steps[jnp.concatenate([ep, ep]),
                        jnp.concatenate([t, t1])]      # [2B, R]
        st0 = rs._c[3] + 5
        s_cat = (rows[:, st0:st0 + rs.dim_state_packed]
                 - rs.state_mean) * rs.state_scale
        s_t, s_t1 = s_cat[:B], s_cat[B:]
    else:
        s_cat = stacked_states(rs, jnp.concatenate([ep, ep]),
                               jnp.concatenate([t, t1]), 0)
        s_t, s_t1 = s_cat[:B], s_cat[B:]
        rows = rs.steps[jnp.concatenate([ep, ep]),
                        jnp.concatenate([t, t1])]      # [2B, R]
    row_t, row_t1 = rows[:B], rows[B:]
    ch_act, ch_mu, ch_qret, wb0, R = rs._c
    length = row_t[:, R - 3].astype(jnp.int32)
    is_last = (t + 1) == length
    terminal = row_t[:, R - 1] > 0
    terminal_next = is_last & terminal
    truncated_next = is_last & (~terminal)
    r_next = (row_t1[:, rb.CH_REW] - rs.rew_mean) * rs.rew_scale
    if per_w is None:
        per_w = jnp.ones(ep.shape, F32)
    valid = (row_t[:, R - 2] >= 0) & (t < length)
    return MiniBatch(ep=ep, t=t, s_t=s_t, s_t1=s_t1,
                     action=row_t[:, ch_act:ch_mu],
                     mu=row_t[:, ch_mu:ch_qret],
                     qret=row_t[:, ch_qret], reward_next=r_next,
                     is_last=is_last, terminal_next=terminal_next,
                     truncated_next=truncated_next, per_w=per_w,
                     valid=valid, rho_old=row_t[:, wb0 + 0],
                     value_old=row_t[:, wb0 + 3], row_t=row_t,
                     row_t1=row_t1)


def write_back(rs: rb.ReplayState, mb: MiniBatch, rho, dkl, delta,
               value, advantage) -> rb.ReplayState:
    """MiniBatch::setMseDklImpw + setValues (MiniBatch.h:161-188).

    ONE full-row scatter into the packed record (pre-packing: 5): the
    new [rho, kl, delta, value, advantage] trailing channels are emitted
    together with the GATHERED fixed channels (reward/action/mu/qret —
    bit-identical re-writes instead of a partial-width scatter). Also
    maintains the incremental per-slot far-policy counts (Episode::updateCumulative_atomic,
    Episode.h:112-129: wasFarPol/isFarPol delta applied on every sampled
    write; the stored rho rode along in the minibatch gather as
    mb.rho_old). Rows with mb.valid == False (empty-shard samples) are
    dropped."""
    t = mb.t
    ep = jnp.where(mb.valid, mb.ep, rs.n_slots) if mb.valid is not None \
        else mb.ep
    was_far = rb.is_far_policy(mb.rho_old, rs.cmax_ret, rs.cinv_ret)
    is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
    delta_far = is_far.astype(jnp.float32) - was_far.astype(jnp.float32)
    wb0 = rs._c[3]
    rows = jnp.concatenate(
        [mb.row_t[:, :wb0],
         jnp.stack([rho, dkl, delta, value, advantage], axis=-1),
         mb.row_t[:, wb0 + 5:]],
        axis=-1)
    return rs._replace(
        steps=rs.steps.at[ep, t].set(rows, mode="drop"),
        far_count=rs.far_count.at[ep].add(delta_far, mode="drop"),
    )


def write_back_with_next(rs: rb.ReplayState, mb: MiniBatch, rho, dkl,
                         delta, value, advantage,
                         v_next) -> rb.ReplayState:
    """write_back + write_next_value: ONE [B, R] full-row scatter for
    the sampled t rows, plus the far-count add and a scalar V(s_T)
    scatter into the v_trunc side-channel (kept only for truncated
    samples, mode='drop' otherwise). The row scatter scales with row
    count, so a [2B, R] fused form — whose second half would carry a
    single useful scalar — is replaced by the [E]-scalar side-channel;
    `ReplayState.value` substitutes it at t == length, so all full-array
    consumers see identical numbers.
    Reference semantics: MiniBatch::setMseDklImpw + setValues
    (MiniBatch.h:161-188) + MB.setValues(bID, t+1, vNext)
    (RACER_train.cpp:23-27)."""
    t = mb.t
    ep = jnp.where(mb.valid, mb.ep, rs.n_slots) if mb.valid is not None \
        else mb.ep
    was_far = rb.is_far_policy(mb.rho_old, rs.cmax_ret, rs.cinv_ret)
    is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
    delta_far = is_far.astype(jnp.float32) - was_far.astype(jnp.float32)
    wb0 = rs._c[3]
    rows = jnp.concatenate(
        [mb.row_t[:, :wb0],
         jnp.stack([rho, dkl, delta, value, advantage], axis=-1),
         mb.row_t[:, wb0 + 5:]],
        axis=-1)
    ep_tr = jnp.where(mb.truncated_next, mb.ep, rs.n_slots)
    return rs._replace(
        steps=rs.steps.at[ep, t].set(rows, mode="drop"),
        far_count=rs.far_count.at[ep].add(delta_far, mode="drop"),
        v_trunc=rs.v_trunc.at[ep_tr].set(v_next, mode="drop"),
    )


def write_next_value(rs: rb.ReplayState, mb: MiniBatch,
                     v_next) -> rb.ReplayState:
    """Refresh V(s_T) for sampled pre-truncation steps
    (MB.setValues(bID, t+1, vNext), e.g. RACER_train.cpp:23-27):
    a scalar scatter into the v_trunc side-channel (see
    write_back_with_next layout note)."""
    ep_tr = jnp.where(mb.truncated_next, mb.ep, rs.n_slots)
    return rs._replace(v_trunc=rs.v_trunc.at[ep_tr].set(
        v_next, mode="drop"))


def post_step_processing(rs: rb.ReplayState, cfg, opt_step, delta_q,
                         axis_name=None) -> tuple:
    """Per-grad-step memory processing (Learner::processMemoryBuffer,
    Learner.cpp:74-100): anneal CmaxRet, ReF-ER beta fixed point,
    maxAbsError EMA. Returns (rs, frac_off_policy)."""
    n_step = opt_step.astype(F32)
    rs = rb.update_cmax(rs, n_step, cfg.clipImpWeight, cfg.epsAnneal)
    rs, frac_off = rb.update_beta_alpha(rs, cfg.batchSize, cfg.maxTotObsNum,
                                        cfg.penalTol, axis_name)
    n_stored = rs.n_stored_steps().astype(F32)
    batch_max_err = jnp.max(jnp.abs(delta_q))
    if axis_name is not None:
        n_stored = jax.lax.psum(n_stored, axis_name)
        batch_max_err = jax.lax.pmax(batch_max_err, axis_name)
    learn_r = 0.1 * cfg.batchSize / jnp.maximum(
        jnp.float32(cfg.maxTotObsNum), n_stored)
    rs = rs._replace(max_abs_error=rs.max_abs_error + learn_r *
                     (batch_max_err - rs.max_abs_error))
    return rs, frac_off


def refer_mix(grad, penal_grad, beta):
    """beta * grad + (1 - beta) * penal_grad
    (Utilities::penalizeReFER, FunctionUtilities.h:221-228)."""
    return beta * grad + (1 - beta) * penal_grad


def grad_stats(grads):
    """Gradient-moment tracking (Utils/StatsTracker.h analog): global norm
    and largest-leaf absolute value, for the metrics stream."""
    leaves = jax.tree_util.tree_leaves(grads)
    sq = sum(jnp.sum(x * x) for x in leaves)
    mx = jnp.max(jnp.stack([jnp.max(jnp.abs(x)) for x in leaves]))
    return {"grad_norm": jnp.sqrt(sq), "grad_max": mx}


def default_metrics(dkl, rho, is_far, frac_off, beta, delta_q, v_val,
                    axis_name=None):
    pmean = (partial(jax.lax.pmean, axis_name=axis_name)
             if axis_name is not None else (lambda x: x))
    return {
        "avg_dkl": pmean(jnp.mean(dkl)),
        "avg_rho": pmean(jnp.mean(rho)),
        "frac_far_batch": pmean(jnp.mean(is_far.astype(F32))),
        "frac_far_data": frac_off,
        "beta": beta,
        "rmse": jnp.sqrt(pmean(jnp.mean(delta_q * delta_q))),
        "avg_v": pmean(jnp.mean(v_val)),
    }
