"""Device-mesh sharding for the actor-learner stack.

JAX replacement of the reference's MPI process topology
(Settings/ExecutionInfo.cpp:209-374 figureOutWorkersPattern + the four
communicators): one mesh axis ("learners") shards BOTH the replay ring
(slot axis) and the vectorized envs (lane axis) — the analog of running K
learner ranks each owning its env workers and replay shard
(P1/P2/P3 in SURVEY.md section 2.9). Parameters and optimizer state are
replicated; gradients and ReF-ER counters cross shards via psum (the
reference's MPI_Iallreduce over learners_train_comm).

Everything is expressed with shard_map over a jax.sharding.Mesh so the same
code runs on a single chip (1-device mesh), a multi-chip slice over ICI, or
multi-host over DCN (jax.distributed + a global mesh).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

AXIS = "learners"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def replay_pspec(rs) -> "ReplayStatePSpec":
    """PartitionSpec pytree for a ReplayState: slot-axis sharded arrays
    (packed layout: states/steps/slot_meta/far_count/qret_stale/samp_cl —
    samp_cl is the per-SHARD sampling cumsum, local by construction),
    replicated scalars/stat vectors."""
    import dataclasses as _dc
    sharded = {"states", "steps", "slot_meta", "far_count", "qret_stale",
               "v_trunc", "samp_cl"}
    kw = {f.name: (P(AXIS) if f.name in sharded else P())
          for f in _dc.fields(rs) if not f.metadata.get("static")}
    return type(rs)(dim_action=rs.dim_action, dim_policy=rs.dim_policy,
                    dim_state_packed=rs.dim_state_packed, **kw)


def carry_pspec(carry) -> Tuple:
    """PartitionSpec pytree for a RolloutCarry: env/slot axes sharded,
    per-shard RNG key."""
    rs_spec = replay_pspec(carry.replay)
    ip_spec = jax.tree_util.tree_map(lambda _: P(AXIS), carry.inprog,
                                     is_leaf=lambda x: isinstance(
                                         x, jnp.ndarray))
    env_spec = jax.tree_util.tree_map(lambda _: P(AXIS), carry.env_state)
    key_spec = P(AXIS)  # [n_shards, 2] keys, one per shard
    rnn_spec = jax.tree_util.tree_map(lambda _: P(AXIS), carry.rnn)
    return type(carry)(rs_spec, ip_spec, env_spec, key_spec, rnn_spec)


def shard_carry(mesh: Mesh, carry):
    """device_put a host-built RolloutCarry with per-shard keys."""
    n = mesh.devices.size
    keys = jax.random.split(carry.key, n)
    carry = carry._replace(key=keys)
    specs = carry_pspec(carry)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), carry, specs)


def make_sharded_fns(algo, rollout_chunk_fn, rs_template, carry_template,
                     mesh: Mesh):
    """Build (train_chunk, rollout_chunk, refresh, init_stats) shard_map'd
    over the learner axis.

    - train_chunk(params, opt, rs, keys[n_shards,2], n) ->
        (params, opt, rs, metrics, new_keys)
    - rollout_chunk(params, carry, n) -> (carry, logs)
    """
    rs_sp = replay_pspec(rs_template)
    carry_sp = carry_pspec(carry_template)

    # shard_map does not take static args, so the chunk length n is closed
    # over; compiled variants are cached per n.
    _train_cache, _roll_cache = {}, {}

    can_pre = (getattr(algo, "presample", False)
               and algo.cfg.dataSamplingAlgo in ("uniform", "default"))
    n_shards = mesh.devices.size

    def train(params, opt_state, rs, keys, n):
        if n not in _train_cache:
            def train_chunk(params, opt_state, rs, keys):
                key = keys[0]
                ks = jax.random.split(key, n)
                if can_pre:
                    # hoisted per-shard uniform pre-sampling (identical
                    # key chain to the in-body path; see
                    # algos/base.presample_uniform)
                    from smarties_tpu.algos.base import presample_uniform
                    eps, ts = presample_uniform(
                        ks, rs, algo.cfg.batchSize // n_shards,
                        axis_name=AXIS)

                    def body(c, x):
                        p, o, r = c
                        k, e, t = x
                        p, o, r, m = algo.train_step(
                            p, o, r, k, axis_name=AXIS,
                            sample_override=(e, t))
                        return (p, o, r), m

                    xs = (ks, eps, ts)
                else:
                    def body(c, k):
                        p, o, r = c
                        p, o, r, m = algo.train_step(p, o, r, k,
                                                     axis_name=AXIS)
                        return (p, o, r), m

                    xs = ks
                (params, opt_state, rs), ms = jax.lax.scan(
                    body, (params, opt_state, rs), xs)
                return (params, opt_state, rs, ms,
                        jax.random.fold_in(key, n)[None])

            _train_cache[n] = jax.jit(shard_map(
                train_chunk, mesh=mesh,
                in_specs=(P(), P(), rs_sp, P(AXIS)),
                out_specs=(P(), P(), rs_sp, P(), P(AXIS)),
                check_vma=False))
        return _train_cache[n](params, opt_state, rs, keys)

    def rollout(params, carry, n):
        if n not in _roll_cache:
            def roll(params, carry):
                carry = carry._replace(key=carry.key[0])
                carry, logs = rollout_chunk_fn(params, carry, n)
                return carry._replace(key=carry.key[None]), logs

            _roll_cache[n] = jax.jit(shard_map(
                roll, mesh=mesh,
                in_specs=(P(), carry_sp),
                out_specs=(carry_sp, P(None, AXIS)),
                check_vma=False))
        return _roll_cache[n](params, carry)

    def refresh_fn(rs, n_grad):
        # cross-shard episode balancing at the refresh cadence (the
        # reference's round-robin episode sharing among workerless
        # masters, DataCoordinator.cpp:91-112)
        from smarties_tpu.replay.buffer import rebalance_shards
        rs = rebalance_shards(rs, AXIS, k_max=8,
                              max_tot_obs=algo.cfg.maxTotObsNum,
                              filter_algo=algo.cfg.ERoldSeqFilter)
        return algo.refresh(rs, n_grad, axis_name=AXIS)

    refresh = jax.jit(shard_map(refresh_fn, mesh=mesh,
                                in_specs=(rs_sp, P()),
                                out_specs=rs_sp, check_vma=False))

    def init_stats_fn(rs):
        return algo.initialize_stats(rs, axis_name=AXIS)

    init_stats = jax.jit(shard_map(init_stats_fn, mesh=mesh,
                                   in_specs=(rs_sp,),
                                   out_specs=rs_sp, check_vma=False))

    from smarties_tpu.replay.buffer import refresh_new_returns

    def fix_fn(rs):
        return refresh_new_returns(rs, algo.cfg.gamma, algo.cfg.lambda_,
                                   algo.returns_mode)

    fix_returns = jax.jit(shard_map(fix_fn, mesh=mesh, in_specs=(rs_sp,),
                                    out_specs=rs_sp, check_vma=False))

    return train, rollout, refresh, init_stats, fix_returns
