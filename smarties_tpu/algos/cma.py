"""CMA-ES learner: gradient-free policy search, diagonal covariance.

JAX re-expression of the reference CMALearner + CMA_Optimizer
(source/smarties/Learners/CMALearner.cpp, Network/CMA_Optimizer.{h,cpp}):
a population of ESpopSize weight vectors (member 0 == the mean, odd members
fresh Gaussian samples, even members mirrored, CMA_Optimizer.cpp:158-178);
each vectorized env lane runs episodes under one member's weights
(CMALearner round-robin weightID assignment -> static lane->member map
here); a generation ends after batchSize * ESpopSize episodes
(CMALearner.cpp:154-165); member losses are negative average returns
(prepareCMALoss, CMALearner.cpp:72-90); the rank-weighted mean/path/
diagonal-sigma update follows CMA_Optimizer::apply_update (:66-140) exactly
(c1cov=1e-5, c_sig=1e-3, sigma clamped to [0.01, 10]).

The reference chunk-shards the weight vector across MPI ranks with
Iallgather (P5 in SURVEY.md section 2.9); here the population axis is a
vmap and population-parallelism across devices comes from sharding the env
lanes (each lane holds its member's weights).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.models.net import NetSpec, apply_net, init_params
from smarties_tpu.ops import continuous_policy as cp
from smarties_tpu.ops import discrete_policy as dpol
from smarties_tpu.utils.config import HyperParameters, anneal_rate

F32 = jnp.float32


def pop_weights(pop_size: int) -> np.ndarray:
    """log-rank recombination weights (initializePopWeights,
    CMA_Optimizer.h:61-72): normalized by the sum of positive parts."""
    w = np.log(0.5 * (pop_size + 1)) - np.log(np.arange(1, pop_size + 1))
    return (w / np.maximum(w, 0).sum()).astype(np.float32)


class CMAState(NamedTuple):
    mean: jnp.ndarray       # flat weight vector (member 0)
    diag_cov: jnp.ndarray   # per-weight sigma S
    path_cov: jnp.ndarray   # evolution path P
    pop: jnp.ndarray        # [P, n] sampled weight vectors
    noise: jnp.ndarray      # [P, n] noise vectors Y
    gen: jnp.ndarray        # generation counter
    # running state standardization (generation-cadence updateRewardsStats)
    state_mean: jnp.ndarray
    state_scale: jnp.ndarray


class CMAES:
    """Standalone CMA trainer (drives its own rollout loop — CMA needs no
    replay/gradients, only per-member returns)."""

    def __init__(self, env_module, mdp: MDPSpec, cfg: HyperParameters,
                 n_envs: int = 48, max_len: int = 512):
        self.env = env_module
        self.mdp = mdp
        self.cfg = cfg
        self.P = cfg.ESpopSize
        assert n_envs % self.P == 0, "n_envs must be divisible by ESpopSize"
        self.n_envs = n_envs
        self.max_len = max_len
        nA = mdp.dim_action
        self.discrete = mdp.is_discrete
        if self.discrete:
            n_out = mdp.max_action_label
            bias = ()
        else:
            n_out = 2 * nA
            bias = tuple([0.0] * nA
                         + [float(cp.initial_sigma_raw(cfg.explNoise))] * nA)
        self.spec = NetSpec(
            n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
            n_out=n_out, kind="FFNN", act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac, out_bias_init=bias)
        self.bounded = (None if self.discrete
                        else np.asarray(mdp.bounded_mask))
        self.w_pop = jnp.asarray(pop_weights(self.P))
        w_pos = jnp.maximum(self.w_pop, 0.0)
        self.mu_eff = float(jnp.sum(w_pos) ** 2 / jnp.sum(w_pos * w_pos))
        self.sum_w = float(jnp.sum(self.w_pop))
        # member index per env lane (round-robin, static)
        self.lane_member = jnp.arange(n_envs) % self.P
        self.eps_per_gen = cfg.batchSize * self.P
        self._gen_fn = jax.jit(self._generation_rollout, static_argnums=3)
        self._upd_fn = jax.jit(self._cma_update)
        self.n_env_steps = 0
        self.n_generations = 0
        self._ep_returns = []

    # ------------------------------------------------------------------
    def init(self, key):
        k1, k2 = jax.random.split(key)
        params0 = init_params(k1, self.spec)
        flat, self.unravel = ravel_pytree(params0)
        n = flat.shape[0]
        st = CMAState(
            mean=flat, diag_cov=jnp.ones((n,), F32),
            path_cov=jnp.zeros((n,), F32),
            pop=jnp.tile(flat[None], (self.P, 1)),
            noise=jnp.zeros((self.P, n), F32),
            gen=jnp.int32(0),
            state_mean=jnp.zeros((self.mdp.dim_state_observed,), F32),
            state_scale=jnp.ones((self.mdp.dim_state_observed,), F32))
        return self._sample_pop(st, k2)

    def _sample_pop(self, st: CMAState, key) -> CMAState:
        """Mirrored population sampling (CMA_Optimizer.cpp:158-178):
        member 0 = mean; odd fresh; even = mirror of previous odd."""
        n = st.mean.shape[0]
        eta = anneal_rate(self.cfg.learnrate, st.gen.astype(F32),
                          self.cfg.epsAnneal)
        z = jax.random.normal(key, (self.P, n), F32)
        y = z * st.diag_cov[None, :]
        idx = jnp.arange(self.P)
        mirror = (idx % 2 == 0) & (idx > 0)
        y = jnp.where(mirror[:, None], -jnp.roll(y, 1, axis=0), y)
        y = y.at[0].set(0.0)
        pop = st.mean[None, :] + eta * y
        return st._replace(pop=pop, noise=y)

    # ------------------------------------------------------------------
    def _act(self, member_params, obs_std, key):
        out, _ = apply_net(member_params, self.spec, obs_std)
        if self.discrete:
            _, _, probs = dpol.probs_of(out)
            opt = dpol.select(key, probs, self.cfg.explNoise > 0)
            return opt[..., None].astype(F32)
        nA = self.mdp.dim_action
        mean, sraw = out[..., :nA], out[..., nA:]
        if self.cfg.explNoise > 0:
            return cp.sample(key, mean, cp.sigma_of(sraw), self.bounded)
        return cp.eff_mean(mean, self.bounded)

    def _generation_rollout(self, st: CMAState, env_state, key,
                            n_steps: int):
        """Scan n_steps env sweeps; returns per-member (sum_R, count) and
        per-step stats for the host loop."""
        lane_params = jax.tree_util.tree_map(
            lambda *_: None, ())  # placeholder
        pop_tree = jax.vmap(self.unravel)(st.pop)
        lane_tree = jax.tree_util.tree_map(
            lambda x: x[self.lane_member], pop_tree)

        def one(carry, _):
            es, cum_r, steps, rsum, rcnt, key, ssum, ssq, scnt = carry
            key, k_act, k_reset = jax.random.split(key, 3)
            obs = self.mdp.observed(self.env.observe(es))
            obs_std = (obs - st.state_mean) * st.state_scale
            a = jax.vmap(lambda p, o, k: self._act(p, o, k))(
                lane_tree, obs_std,
                jax.random.split(k_act, self.n_envs))
            es2, r, done, term = self.env.step(
                es, self.mdp.learner_to_env_action(a))
            cum_r = cum_r + r
            steps = steps + 1
            force = steps >= self.max_len
            done = done | force
            # on done: accumulate into the lane's member
            m = self.lane_member
            rsum = rsum.at[m].add(jnp.where(done, cum_r, 0.0))
            rcnt = rcnt.at[m].add(done.astype(jnp.int32))
            ssum = ssum + jnp.sum(obs, axis=0)
            ssq = ssq + jnp.sum(obs * obs, axis=0)
            scnt = scnt + obs.shape[0]
            cum_r = jnp.where(done, 0.0, cum_r)
            steps = jnp.where(done, 0, steps)
            es2 = self.env.reset_where(es2, done, k_reset)
            return (es2, cum_r, steps, rsum, rcnt, key, ssum, ssq,
                    scnt), (done, cum_r)

        V = self.n_envs
        dimS = self.mdp.dim_state_observed
        init = (env_state, jnp.zeros(V), jnp.zeros(V, jnp.int32),
                jnp.zeros(self.P), jnp.zeros(self.P, jnp.int32), key,
                jnp.zeros(dimS), jnp.zeros(dimS), jnp.int32(0))
        (es, cum_r, steps, rsum, rcnt, key, ssum, ssq, scnt), logs = \
            jax.lax.scan(one, init, None, length=n_steps)
        return es, rsum, rcnt, key, (ssum, ssq, scnt)

    # ------------------------------------------------------------------
    def _cma_update(self, st: CMAState, losses, key):
        """apply_update (CMA_Optimizer.cpp:66-140)."""
        c1cov, c_sig = 1e-5, 1e-3
        mu_eff, sum_w = self.mu_eff, self.sum_w
        order = jnp.argsort(losses)           # ascending loss = best first
        x_sorted = st.pop[order]
        y_sorted = st.noise[order]
        w = self.w_pop
        w_pos = jnp.maximum(w, 0.0)
        new_mean = jnp.sum(w_pos[:, None] * x_sorted, axis=0)
        avg_noise = jnp.sum(w_pos[:, None] * y_sorted, axis=0)
        mom_noise = jnp.sum(w[:, None] * y_sorted * y_sorted, axis=0)
        alpha = 1 - c1cov - sum_w * mu_eff * c1cov
        upd_sig = np.sqrt(c_sig * (2 - c_sig) * mu_eff)
        path = (1 - c_sig) * st.path_cov + upd_sig * avg_noise
        s2 = (alpha * st.diag_cov ** 2 + c1cov * path ** 2
              + mu_eff * c1cov * mom_noise)
        sig = jnp.clip(jnp.sqrt(jnp.maximum(s2, 0.0)), 0.01, 10.0)
        st = st._replace(mean=new_mean, path_cov=path, diag_cov=sig,
                         gen=st.gen + 1)
        return self._sample_pop(st, key)

    # ------------------------------------------------------------------
    def train(self, n_generations: int, key=None, log_every: int = 5,
              chunk: int = 128):
        """Host driver: generations of (rollout until batchSize*P episodes)
        -> CMA update. Returns the CMAState."""
        key = key if key is not None else jax.random.PRNGKey(
            self.cfg.randSeed)
        key, k_init, k_env = jax.random.split(key, 3)
        if not hasattr(self, "state"):
            self.state = self.init(k_init)
            self.env_state = self.env.init(k_env, self.n_envs)
        st = self.state
        for g in range(n_generations):
            rsum = jnp.zeros(self.P)
            rcnt = jnp.zeros(self.P, jnp.int32)
            ssum = jnp.zeros(self.mdp.dim_state_observed)
            ssq = jnp.zeros_like(ssum)
            scnt = 0
            key, k_roll = jax.random.split(key)
            while int(jnp.sum(rcnt)) < self.eps_per_gen:
                self.env_state, rs_, rc_, k_roll, (s1, s2, sc) = \
                    self._gen_fn(st, self.env_state, k_roll, chunk)
                rsum = rsum + rs_
                rcnt = rcnt + rc_
                ssum, ssq, scnt = ssum + s1, ssq + s2, scnt + int(sc)
                self.n_env_steps += chunk * self.n_envs
            losses = -rsum / jnp.maximum(rcnt, 1)
            key, k_upd = jax.random.split(key)
            st = self._upd_fn(st, losses, k_upd)
            # generation-cadence state standardization update
            m = ssum / max(scnt, 1)
            var = jnp.maximum(ssq / max(scnt, 1) - m * m, 1e-8)
            st = st._replace(state_mean=m, state_scale=1.0 / jnp.sqrt(var))
            self.n_generations += 1
            avg_ret = float(jnp.sum(rsum) / jnp.maximum(jnp.sum(rcnt), 1))
            self._ep_returns.append(avg_ret)
            if (g + 1) % log_every == 0:
                print(f"gen {self.n_generations:4d} | envstep "
                      f"{self.n_env_steps:9d} | avgR {avg_ret:8.2f} | "
                      f"best {-float(jnp.min(losses)):8.2f}", flush=True)
        self.state = st
        return st

    # ------------------------------------------------------------------
    def run_external(self, pool, n_generations: int, key=None,
                     log_every: int = 1,
                     max_wall_s: float = float("inf")):
        """Drive EXTERNAL (Communicator-API) envs with CMA.

        The reference's primary CMA use: user applications (e.g. CFD
        solvers) evaluated under population members
        (CMALearner::assignWeightID round-robin at episode start,
        CMALearner.cpp:29-52; generation barrier == batchSize * ESpopSize
        episodes, :154-165). `pool` is an EnvPool/SocketEnvPool whose
        spec must already be probed (pool.probe_spec()).
        """
        import time as _time
        import numpy as _np
        from smarties_tpu.runtime.communicator import (CONT, INIT, LAST,
                                                       TERM)
        key = key if key is not None else jax.random.PRNGKey(
            self.cfg.randSeed)
        key, k_init = jax.random.split(key)
        if not hasattr(self, "state"):
            self.state = self.init(k_init)
        st = self.state
        act_jit = jax.jit(lambda p, o, k: self._act(p, o, k))
        mdp = pool.mdp
        n_lanes = pool.n_lanes
        lane_member = _np.zeros(n_lanes, _np.int64)
        work_counter = 0
        rsum = _np.zeros(self.P)
        rcnt = _np.zeros(self.P, _np.int64)
        lane_ret = _np.zeros(n_lanes)
        gen_done = 0
        t0 = _time.time()
        obs_idx = _np.nonzero(mdp.observable_mask)[0]
        while gen_done < n_generations and _time.time() - t0 < max_wall_s:
            events, states, rewards, statuses = pool.gather_states()
            for lane, status, state, reward in events:
                if status == INIT:
                    lane_member[lane] = work_counter % self.P
                    work_counter += 1
                    lane_ret[lane] = 0.0
                else:
                    lane_ret[lane] += reward
                if status in (TERM, LAST):
                    m = lane_member[lane]
                    rsum[m] += lane_ret[lane]
                    rcnt[m] += 1
            obs = jnp.asarray(states[:, obs_idx], jnp.float32)
            obs_std = (obs - st.state_mean) * st.state_scale
            pop_tree = jax.vmap(self.unravel)(st.pop)
            lane_tree = jax.tree_util.tree_map(
                lambda x: x[jnp.asarray(lane_member)], pop_tree)
            key, k_act = jax.random.split(key)
            a = jax.vmap(act_jit, in_axes=(0, 0, 0))(
                lane_tree, obs_std, jax.random.split(k_act, n_lanes))
            env_act = _np.asarray(mdp.learner_to_env_action(a), _np.float64)
            pool.send_actions(env_act)
            if int(rcnt.sum()) >= self.eps_per_gen:
                losses = jnp.asarray(-rsum / _np.maximum(rcnt, 1))
                key, k_upd = jax.random.split(key)
                st = self._upd_fn(st, losses, k_upd)
                self.n_generations += 1
                gen_done += 1
                if gen_done % log_every == 0:
                    print(f"gen {self.n_generations:4d} | avgR "
                          f"{rsum.sum() / max(rcnt.sum(), 1):9.3f} | best "
                          f"{-float(jnp.min(losses)):9.3f}", flush=True)
                rsum[:] = 0
                rcnt[:] = 0
        self.state = st
        return st

    # ------------------------------------------------------------------
    def evaluate(self, n_episodes: int = 8, key=None, max_steps=None):
        """Roll the MEAN member deterministically."""
        key = key if key is not None else jax.random.PRNGKey(123)
        max_steps = max_steps or self.max_len
        params = self.unravel(self.state.mean)
        es = self.env.init(key, n_episodes)
        done = np.zeros(n_episodes, bool)
        rets = np.zeros(n_episodes)
        st = self.state
        for _ in range(max_steps):
            obs = self.mdp.observed(self.env.observe(es))
            obs_std = (obs - st.state_mean) * st.state_scale
            out, _ = apply_net(params, self.spec, obs_std)
            if self.discrete:
                _, _, probs = dpol.probs_of(out)
                a = jnp.argmax(probs, axis=-1)[..., None].astype(F32)
            else:
                nA = self.mdp.dim_action
                a = cp.eff_mean(out[..., :nA], self.bounded)
            es, r, d, _ = self.env.step(es, self.mdp.learner_to_env_action(a))
            rets += np.asarray(r) * (~done)
            done |= np.asarray(d)
            if done.all():
                break
        return rets
