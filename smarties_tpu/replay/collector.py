"""Vectorized rollout collection: acting + env stepping + episode commit.

JAX replacement of the reference's serving stack (Master reply
threads + Communicator sockets + per-agent Learner::select,
Core/Master.cpp:118-144, Core/Worker.cpp:144-186, Learner.cpp:30-45): all V
environments advance in lockstep inside one jitted lax.scan; action
selection is a single batched network forward; finished episodes are
scattered into the on-device replay ring with their Retrace estimates
computed at commit (MemoryBuffer::terminateCurrentEpisode,
MemoryBuffer.cpp:118-170).

The per-agent "in-progress episode" (MemoryBuffer::inProgress) is a set of
fixed-shape per-env arrays [V, L+1, ...] with a step cursor per lane.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from smarties_tpu.replay.buffer import ReplayState, commit_episodes

F32 = jnp.float32
I32 = jnp.int32


class InProgress(NamedTuple):
    states: jnp.ndarray    # [V, L+1, dimS_obs]
    actions: jnp.ndarray   # [V, L+1, dimA]
    mus: jnp.ndarray       # [V, L+1, dimPol]
    rewards: jnp.ndarray   # [V, L+1]
    value: jnp.ndarray     # [V, L+1] V(s_t) recorded while acting
    advantage: jnp.ndarray  # [V, L+1] A(s_t,a_t) recorded while acting
    t: jnp.ndarray         # [V] i32 cursor == steps taken so far
    cum_reward: jnp.ndarray  # [V] running return (Episode.totR)


def init_inprogress(n_envs: int, max_len: int, dim_obs: int, dim_action: int,
                    dim_policy: int, state_dtype=F32) -> InProgress:
    V, L1 = n_envs, max_len + 1
    z = lambda *s: jnp.zeros(s, F32)
    return InProgress(
        states=jnp.zeros((V, L1, dim_obs), state_dtype),
        actions=z(V, L1, dim_action),
        mus=z(V, L1, dim_policy), rewards=z(V, L1),
        value=z(V, L1), advantage=z(V, L1),
        t=jnp.zeros((V,), I32), cum_reward=jnp.zeros((V,), F32))


def _reset_lanes(ip: InProgress, mask) -> InProgress:
    m2 = mask[:, None]
    m3 = mask[:, None, None]
    z = lambda a, m: jnp.where(m, jnp.zeros_like(a), a)
    return InProgress(
        states=z(ip.states, m3), actions=z(ip.actions, m3),
        mus=z(ip.mus, m3), rewards=z(ip.rewards, m2),
        value=z(ip.value, m2), advantage=z(ip.advantage, m2),
        t=jnp.where(mask, 0, ip.t),
        cum_reward=jnp.where(mask, 0.0, ip.cum_reward))


class RolloutCarry(NamedTuple):
    replay: ReplayState
    inprog: InProgress
    env_state: object
    key: jnp.ndarray
    # per-env persistent recurrent context for acting (AgentContext analog,
    # Network/ThreadContext.h:19-100); () for feed-forward nets
    rnn: tuple = ()


def make_rollout_chunk(env_module, mdp, act_fn: Callable,
                       max_tot_obs: int, gamma: float, lam: float,
                       returns_mode: str = "retrace",
                       filter_algo: str = "oldest",
                       record_obs: bool = False):
    """Build a jittable `rollout_chunk(params, carry, n_steps)`.

    act_fn(params, obs_std, key) -> (learner_action [V,dimA],
                                     mu [V,dimPol], value [V], adv [V])
    is the algorithm's acting head (Learner::selectAction analog).

    Returns per-chunk logs: (done[k,V], length[k,V], ret[k,V]) for the
    host-side cumulative_rewards.dat writer (MemoryBuffer.cpp:491-513).

    record_obs: additionally log per-step raw observations for the
    agent_*_obs.raw stream (Agent::writeData analog, Agent.h:259-299):
    logs gain (obs[k,V,dimS], rew_in[k,V], status[k,V], obs_fin[k,V,dimS],
    rew_fin[k,V], status_fin[k,V]) where the *_fin record is valid only
    for lanes finishing at that step (status_fin > 0).
    """
    def one_step(params, carry: RolloutCarry):
        rs, ip, es, key, rnn = carry
        key, k_act, k_reset = jax.random.split(key, 3)
        V = ip.t.shape[0]
        L1 = ip.states.shape[1]

        obs_full = env_module.observe(es)
        obs = mdp.observed(obs_full)
        lane = jnp.arange(V)
        tcur = ip.t
        ip = ip._replace(states=ip.states.at[lane, tcur].set(
            obs.astype(ip.states.dtype)))
        k_app = mdp.n_appended_obs
        if k_app:
            # frame stacking from the in-progress buffer, clamped at the
            # episode start (Episode::standardizedState)
            offs = jnp.arange(k_app + 1)
            tj = jnp.maximum(tcur[:, None] - offs[None, :], 0)
            frames = (ip.states[lane[:, None], tj]
                      - rs.state_mean) * rs.state_scale
            obs_std = frames.reshape(V, -1)
        else:
            obs_std = (obs - rs.state_mean) * rs.state_scale
        act, mu, val, adv, rnn = act_fn(params, obs_std, k_act, rnn)

        ip = ip._replace(
            actions=ip.actions.at[lane, tcur].set(act),
            mus=ip.mus.at[lane, tcur].set(mu),
            value=ip.value.at[lane, tcur].set(val),
            advantage=ip.advantage.at[lane, tcur].set(adv),
        )

        env_act = mdp.learner_to_env_action(act)
        es2, reward, done, terminal = env_module.step(es, env_act)
        tnew = tcur + 1
        # force-truncate episodes hitting the storage cap (MAX_SEQ_LEN analog)
        force_trunc = tnew >= (L1 - 1)
        done = done | force_trunc
        ip = ip._replace(
            rewards=ip.rewards.at[lane, tnew].set(reward),
            cum_reward=ip.cum_reward + reward,
            t=tnew,
        )
        # store the final state for finished lanes; V(s_T) is left at 0 at
        # ingest exactly like the reference (Episode::finalize zeroes
        # stateValue; refreshed lazily by training, RACER_train.cpp:23-27)
        obs2 = mdp.observed(env_module.observe(es2))
        ip = ip._replace(
            states=jnp.where(done[:, None, None],
                             ip.states.at[lane, tnew].set(
                                 obs2.astype(ip.states.dtype)), ip.states))

        # per-lane rho template: 1 for t<T, 0 at T (Episode::finalize,
        # Episode.cpp:244-267). The at-ingest Retrace is deferred to ONE
        # batched sweep per rollout chunk (buffer.refresh_new_returns),
        # keeping the Pallas kernel out of this scan body.
        tgrid = jnp.arange(L1)[None, :]
        rho_ep = (tgrid < tnew[:, None]).astype(F32)
        qret = jnp.zeros_like(ip.value)

        rs = commit_episodes(
            rs, ip.states, ip.actions, ip.mus, ip.rewards, ip.value,
            ip.advantage, qret, rho_ep, tnew, terminal, done,
            max_tot_obs, filter_algo)

        log = (done, tnew, ip.cum_reward)
        if record_obs:
            # row for the state served this step (reward carried INTO it,
            # rewards[0]=0 convention) + a second row for lanes whose
            # successor state ended the episode (TERM=2 / LAST=3)
            rew_in = ip.rewards[lane, tcur]
            status = jnp.where(tcur == 0, 0, 1).astype(F32)
            status_fin = jnp.where(
                done, jnp.where(terminal, 2.0, 3.0), 0.0)
            log = log + (obs.astype(F32), rew_in, status,
                         obs2.astype(F32), reward.astype(F32), status_fin)
        ip = _reset_lanes(ip, done)
        es2 = env_module.reset_where(es2, done, k_reset)
        # zero the recurrent context of finished lanes (AgentContext reset)
        rnn = jax.tree_util.tree_map(
            lambda h: jnp.where(
                done.reshape((-1,) + (1,) * (h.ndim - 1)), 0.0, h), rnn)
        return RolloutCarry(rs, ip, es2, key, rnn), log

    def rollout_chunk(params, carry: RolloutCarry, n_steps: int):
        def body(c, _):
            return one_step(params, c)

        carry, logs = jax.lax.scan(body, carry, None, length=n_steps)
        return carry, logs

    return rollout_chunk
