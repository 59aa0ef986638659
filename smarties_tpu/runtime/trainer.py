"""Host-side training driver: pacing, warmup, eval, logging, checkpointing.

JAX replacement of the reference's Master/Worker/TaskQueue runtime
(Core/Worker.cpp:53-142 runTraining, Utils/TaskQueue.h): the reference's
thread pools, task state machines and socket serving loops exist to hide
CPU/MPI latency; on an accelerator the same semantics reduce to a host
loop that alternates two jitted programs — a rollout chunk over all
vectorized envs and a chunk of gradient steps — paced by the obsPerStep
invariant (Learner::blockDataAcquisition / blockGradientUpdates,
Learner.cpp:102-123).
"""
from __future__ import annotations

import os
import pickle
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.algos.vracer import VRacer
from smarties_tpu.core.mdp import MDPSpec
from smarties_tpu.replay import buffer as rb
from smarties_tpu.replay.collector import (InProgress, RolloutCarry,
                                           init_inprogress,
                                           make_rollout_chunk)
from smarties_tpu.utils.config import HyperParameters


class Trainer:
    def __init__(self, env_module, mdp: MDPSpec, cfg: HyperParameters,
                 n_envs: int = 64, n_slots: Optional[int] = None,
                 max_len: int = 512, run_dir: Optional[str] = None,
                 algo_cls=None, mesh=None, state_dtype=None,
                 obs_log: bool = False):
        """mesh: optional jax.sharding.Mesh with a "learners" axis — shards
        the replay (slot axis) and envs (lane axis) across devices with
        psum'd gradients, the analog of the reference's --nLearners K MPI
        topology (SURVEY.md section 2.9 P2/P3). n_envs and n_slots must be
        divisible by the mesh size."""
        cfg.check()
        self.mesh = mesh
        self.env = env_module
        self.mdp = mdp
        self.cfg = cfg
        self.n_envs = n_envs
        self.max_len = max_len
        n_slots = n_slots or max(256, 2 * cfg.maxTotObsNum // max(
            8, max_len // 8))
        self.n_slots = n_slots
        self.run_dir = run_dir
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._rew_file = open(
                os.path.join(run_dir, "agent_00_rank00_cumulative_rewards.dat"),
                "a")
        else:
            self._rew_file = None
        # raw obs stream + gradient-moment dump, same formats as the
        # Engine path / plot viewers (Agent::writeData + StatsTracker
        # grads_*.raw analogs)
        self.obs_log = obs_log and run_dir is not None
        self._obs_file = (open(os.path.join(
            run_dir, "agent_00_rank00_obs.raw"), "ab")
            if self.obs_log else None)
        self._grads_file = (open(os.path.join(
            run_dir, "grads_rank00.raw"), "ab") if run_dir else None)

        if algo_cls is None:
            # resolve by the settings string like the reference factory
            # (AlgoFactory.cpp:60-340); pass algo_cls to force a class
            from smarties_tpu.algos.registry import make_learner
            self.algo = make_learner(mdp, cfg)
        else:
            self.algo = algo_cls(mdp, cfg)
        key = jax.random.PRNGKey(cfg.randSeed)
        key, k_init, k_env = jax.random.split(key, 3)
        self.key = key
        self.params, self.opt_state = self.algo.init(k_init)

        import jax.numpy as _jnp
        sdt = state_dtype or _jnp.float32
        # small-dim f32 envs CAN mirror states into the packed record
        # (ONE minibatch gather; buffer._ch layout notes) — opt-in via
        # SMT_PACK_STATES=1 until measured against the two-gather layout
        # (wider record R 13->18). Exact-parity guarded either way
        # (tests/test_state_packing.py).
        pack = (sdt == _jnp.float32 and mdp.n_appended_obs == 0
                and mdp.dim_state_observed <= 64
                and bool(os.environ.get("SMT_PACK_STATES")))
        self.rs = rb.init_replay(
            n_slots, max_len, mdp.dim_state_observed, mdp.dim_action,
            mdp.dim_policy, cfg.clipImpWeight, state_dtype=sdt,
            mu_init=rb.safe_mu(mdp), pack_states=pack)
        ip = init_inprogress(n_envs, max_len, mdp.dim_state_observed,
                             mdp.dim_action, mdp.dim_policy,
                             state_dtype=sdt)
        env_state = env_module.init(k_env, n_envs)
        key, k_roll = jax.random.split(self.key)
        self.key = key
        rnn0 = (self.algo.init_rnn(n_envs)
                if hasattr(self.algo, "init_rnn") else ())
        self.carry = RolloutCarry(self.rs, ip, env_state, k_roll, rnn0)

        act_fn = self.algo.make_act_fn(train=cfg.bTrain)
        # per-shard capacity: the reference splits maxTotObsNum across
        # learner ranks (HyperParameters::defineDistributedLearning).
        # On-policy (PPO) fills a horizon then clears; give the ring slack
        # so commit-time pruning never drops fresh horizon data.
        n_shards = mesh.devices.size if mesh is not None else 1
        assert n_envs % n_shards == 0 and n_slots % n_shards == 0
        self.on_policy = getattr(self.algo, "on_policy", False)
        commit_cap = cfg.maxTotObsNum * (4 if self.on_policy else 1)
        chunk_fn = make_rollout_chunk(
            env_module, mdp, act_fn, commit_cap // n_shards,
            cfg.gamma, cfg.lambda_, self.algo.returns_mode,
            cfg.ERoldSeqFilter, record_obs=self.obs_log)

        # hoisted uniform pre-sampling: one vmapped batch of RNG draws
        # outside the scan instead of per-iteration split+randint inside
        # it, bit-identical (algos/base.py presample_uniform); PER
        # samplers depend on the in-step TD errors and keep the in-body
        # path
        self._can_presample = (
            (getattr(self.algo, "presample", False)
             or hasattr(self.algo, "presample_fn"))
            and cfg.dataSamplingAlgo in ("uniform", "default"))

        def _train_scan(params, opt_state, rs, keys):
            from smarties_tpu.algos.base import presample_uniform
            if self._can_presample:
                # algo-specific hoisted sampler (e.g. ACER's episode +
                # window-start draw) or the shared uniform one
                pre = getattr(self.algo, "presample_fn", None)
                if pre is not None:
                    eps, ts = pre(keys, rs, self.cfg.batchSize)
                else:
                    eps, ts = presample_uniform(keys, rs,
                                                self.cfg.batchSize)

                def body(c, x):
                    p, o, r = c
                    k, e, t = x
                    p, o, r, m = self.algo.train_step(
                        p, o, r, k, sample_override=(e, t))
                    return (p, o, r), m

                xs = (keys, eps, ts)
            else:
                def body(c, k):
                    p, o, r = c
                    p, o, r, m = self.algo.train_step(p, o, r, k)
                    return (p, o, r), m

                xs = keys
            return jax.lax.scan(body, (params, opt_state, rs), xs)

        if mesh is None:
            self._rollout = jax.jit(chunk_fn, static_argnums=2)

            def train_chunk(params, opt_state, rs, key, n):
                keys = jax.random.split(key, n)
                (params, opt_state, rs), ms = _train_scan(
                    params, opt_state, rs, keys)
                return params, opt_state, rs, ms

            self._train_chunk = jax.jit(train_chunk, static_argnums=4)
            self._refresh = jax.jit(self.algo.refresh)
            self._init_stats = jax.jit(self.algo.initialize_stats)
            self._fix_returns = jax.jit(partial(
                rb.refresh_new_returns, gamma=cfg.gamma, lam=cfg.lambda_,
                mode=self.algo.returns_mode))

            # fused steady-state cycle: [n_roll env sweeps + at-ingest
            # returns + n_train grad steps] as ONE XLA program — one
            # dispatch per cycle instead of one per chunk. The train keys
            # derive from carry.key INSIDE the program, so the
            # steady-state loop issues no eager ops and no device->host
            # transfers.
            def fused_cycle(params, opt_state, carry, n_roll, n_train):
                carry, logs = chunk_fn(params, carry, n_roll)
                rs2 = rb.refresh_new_returns(
                    carry.replay, cfg.gamma, cfg.lambda_,
                    self.algo.returns_mode)
                keys = jax.random.split(
                    jax.random.fold_in(carry.key, 7), n_train)
                (params, opt_state, rs2), ms = _train_scan(
                    params, opt_state, rs2, keys)
                return params, opt_state, carry._replace(replay=rs2), ms, \
                    logs

            self._fused_cycle = jax.jit(fused_cycle,
                                        static_argnums=(3, 4))
        else:
            from smarties_tpu.parallel.mesh import (make_sharded_fns,
                                                    shard_carry)
            self.carry = shard_carry(mesh, self.carry)
            (self._train_sharded, self._rollout, self._refresh,
             self._init_stats, self._fix_returns) = make_sharded_fns(
                self.algo, chunk_fn, self.carry.replay, self.carry, mesh)
            self.key, k_tr = jax.random.split(self.key)
            self._train_keys = jax.random.split(k_tr, n_shards)

        # phase profiler (Utils/Profiler analog; ROLL/TRAIN/REFRESH keys)
        from smarties_tpu.utils.profiler import Profiler
        self.profiler = Profiler()
        # counters (ReplayStatsCounters analog; host side for pacing)
        self.n_env_steps = 0          # nSeenTransitions_loc
        self.n_grad_steps = 0
        self.n_obs_b4_start = cfg.minTotObsNum  # nObsB4StartTraining
        self._initialized = False
        self._last_refresh = 0
        self._last_log = 0
        self._ep_returns = []         # recent completed-episode returns
        self._pending_logs = []       # device-side logs awaiting transfer

    # ------------------------------------------------------------------
    @property
    def replay(self) -> rb.ReplayState:
        return self.carry.replay

    @property
    def algo_is_recurrent(self) -> bool:
        return self.cfg.nnType in ("LSTM", "GRU", "RNN")

    def _roll(self, n_steps: int):
        with self.profiler("ROLL"):
            self.carry, logs = self._rollout(self.params, self.carry,
                                             n_steps)
            # at-ingest Retrace for episodes committed during the chunk
            # (one batched sweep; buffer.refresh_new_returns)
            self.carry = self.carry._replace(
                replay=self._fix_returns(self.carry.replay))
        self.n_env_steps += n_steps * self.n_envs
        # defer the device->host transfer: materializing logs forces a
        # sync per chunk; flush lazily at logging time. Counters are
        # captured at append time so deferred rows keep the grad/env-step
        # columns of when the episodes completed (MemoryBuffer.cpp:491).
        self._pending_logs.append((logs, self.n_grad_steps,
                                   self.n_env_steps))
        if len(self._pending_logs) >= getattr(self, "log_flush_threshold",
                                              32):
            self._flush_logs()

    def _flush_logs(self):
        pending, self._pending_logs = self._pending_logs, []
        if not pending:
            return
        # batch the device->host materialization: each deferred log tuple
        # is 3+ separate device arrays, each np.asarray a synchronizing
        # transfer, and a 6M-step run defers ~6k tuples. Stack them
        # on-device in chunks and read each stack with ONE transfer.
        if (len(pending) > 8
                and all(getattr(x, "is_fully_addressable", True)
                        for x in pending[0][0])):
            import jax.numpy as _jnp
            CH = 256

            def sig(logs):
                return tuple(getattr(x, "shape", None) for x in logs)

            i = 0
            while i < len(pending):
                # batch a run of same-shaped tuples (chunk lengths vary
                # between warmup/steady phases)
                j = i + 1
                s0 = sig(pending[i][0])
                while (j < len(pending) and j - i < CH
                       and sig(pending[j][0]) == s0):
                    j += 1
                chunk = pending[i:j]
                if len(chunk) > 4:
                    stacked = [np.asarray(_jnp.stack(
                        [c[0][k] for c in chunk]))
                        for k in range(len(chunk[0][0]))]
                    for k, (_logs, g, e) in enumerate(chunk):
                        self._log_episodes([s[k] for s in stacked], g, e)
                else:
                    for logs, g, e in chunk:
                        self._log_episodes(logs, g, e)
                i = j
            return
        for logs, g, e in pending:
            self._log_episodes(logs, g, e)

    @staticmethod
    def _host_local(x, axis=1):
        """np view of a possibly multi-process-sharded log array: the
        local shards concatenated along the env-lane axis. Under
        jax.distributed each host logs ITS OWN env lanes (the reference
        writes per-rank cumulative_rewards files, MemoryBuffer.cpp:491)."""
        if getattr(x, "is_fully_addressable", True):
            return np.asarray(x)
        shards = sorted(x.addressable_shards, key=lambda s: s.index[axis].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards],
                              axis=axis)

    def _log_episodes(self, logs, g=None, e=None):
        g = self.n_grad_steps if g is None else g
        e = self.n_env_steps if e is None else e
        done, length, ret = (self._host_local(x) for x in logs[:3])
        if self._obs_file is not None and len(logs) > 3:
            self._write_obs_rows(logs[3:])
        done = np.asarray(done)
        if not done.any():
            return
        length = np.asarray(length)[done]
        ret = np.asarray(ret)[done]
        agent = np.nonzero(done)[1]
        for a, l, r in zip(agent, length, ret):
            self._ep_returns.append(float(r))
            if self._rew_file:
                # [grad-step, env-step, agentID, ep-length, return]
                # byte-format of MemoryBuffer.cpp:491-513
                self._rew_file.write(f"{g} {e} {a} {l} {r}\n")
        if len(self._ep_returns) > 1000:
            self._ep_returns = self._ep_returns[-1000:]

    def _write_obs_rows(self, rec):
        """Append f32 rows [lane, status, state..., reward] in env-step
        order — the agent_*_obs.raw format shared with the Engine path
        (runtime/engine.py, Agent.h:259-299)."""
        obs, rew_in, status, obs_f, rew_f, status_f = \
            (np.asarray(x, np.float32) for x in rec)
        k, V = status.shape
        lane = np.broadcast_to(np.arange(V, dtype=np.float32), (k, V))
        row = np.concatenate(  # [k, V, 2 + dimS + 1]
            [lane[..., None], status[..., None], obs, rew_in[..., None]],
            axis=-1)
        row_f = np.concatenate(
            [lane[..., None], status_f[..., None], obs_f,
             rew_f[..., None]], axis=-1)
        out = []
        for i in range(k):  # keep per-step ordering, final rows after
            out.append(row[i])
            fin = status_f[i] > 0
            if fin.any():
                out.append(row_f[i][fin])
        self._obs_file.write(np.concatenate(out).tobytes())

    # ------------------------------------------------------------------
    def warmup(self, chunk: int = 64, adaptive: bool = True,
               blind_sweeps: Optional[int] = None):
        """Gather minTotObsNum observations before training
        (stepInit task, RACER.cpp:69-77).

        adaptive: shrink the final chunk to a single sweep so long-episode
        envs do not overshoot the start threshold by a whole chunk (the
        reference serves envs one step at a time, so its overshoot is only
        the in-flight episodes). Each distinct chunk length is a separate
        XLA compilation — pass adaptive=False to compile only one.

        blind_sweeps: run exactly this many env sweeps WITHOUT reading the
        stored-obs counter back — zero device->host transfers. Caller
        guarantees the sweep budget covers minTotObsNum; any overshoot
        matches the reference's in-flight transient."""
        if blind_sweeps is not None:
            done = 0
            while done < blind_sweeps:
                self._roll(chunk)   # fixed size: one compiled variant
                done += chunk
            self.carry = self.carry._replace(
                replay=self._init_stats(self.carry.replay))
            self._initialized = True
            return
        while int(self.replay.n_stored_steps()) < self.n_obs_b4_start:
            in_flight = int(jnp.sum(self.carry.inprog.t))
            remaining = (self.n_obs_b4_start
                         - int(self.replay.n_stored_steps()) - in_flight)
            n = max(1, min(chunk, int(np.ceil(
                max(remaining, self.n_envs) / self.n_envs))))
            n = chunk if (n >= chunk or not adaptive) else 1
            self._roll(n)
        self.carry = self.carry._replace(
            replay=self._init_stats(self.carry.replay))
        self._initialized = True

    # ------------------------------------------------------------------
    def _n_loc_train_steps(self) -> int:
        return self.n_env_steps - self.n_obs_b4_start

    def block_data(self) -> bool:
        """Learner::blockDataAcquisition (Learner.cpp:102-113)."""
        # cache the one-time startup condition to avoid a device reduction
        # (sync point) on every host-loop iteration
        if not getattr(self, "_min_stored_reached", False):
            if int(self.replay.n_stored_steps()) < self.n_obs_b4_start:
                return False
            self._min_stored_reached = True
        return (self._n_loc_train_steps()
                > (self.n_grad_steps + 1) * self.cfg.obsPerStep)

    def block_grads(self) -> bool:
        """Learner::blockGradientUpdates (Learner.cpp:115-123)."""
        return (self._n_loc_train_steps()
                < self.n_grad_steps * self.cfg.obsPerStep)

    # ------------------------------------------------------------------
    def train_fused(self, n_grad_steps: int, log_every: int = 1000,
                    max_wall_s: float = float("inf"), flush: bool = True):
        """Steady-state training with the fused cycle program: each cycle
        rolls 1 env sweep (n_envs observations) and runs the matching
        n_envs/obsPerStep grad steps, keeping the obsPerStep invariant
        exactly while paying one dispatch per cycle.

        The 1000-step refresh runs between cycles at the nearest boundary
        (cadence n_train-per-cycle instead of exactly 1000). Off-policy,
        single-mesh only; falls back to train() otherwise. A backend error
        propagates at once; `save`/`restore` is the checkpoint path."""
        if self.on_policy or self.mesh is not None:
            return self.train(n_grad_steps, log_every, max_wall_s)
        if not self._initialized:
            self.warmup()
        n_train = max(1, int(round(self.n_envs / self.cfg.obsPerStep)))
        target = self.n_grad_steps + n_grad_steps
        t0 = time.time()
        # NOTE: any warmup overshoot persists as a constant bounded offset
        # in the pacing ledger (cycles are exactly balanced); the reference
        # has the same transient from in-flight episodes at startup.
        flush_at = getattr(self, "log_flush_threshold", 32)
        while self.n_grad_steps < target and time.time() - t0 < max_wall_s:
            (self.params, self.opt_state, self.carry, metrics,
             logs) = self._fused_cycle(self.params, self.opt_state,
                                       self.carry, 1, n_train)
            self.n_env_steps += self.n_envs
            self.n_grad_steps += n_train
            self._pending_logs.append((logs, self.n_grad_steps,
                                       self.n_env_steps))
            if len(self._pending_logs) >= flush_at:
                self._flush_logs()
            self._last_metrics = metrics
            if self.cfg.debugNaN:
                self._check_nan()
            if self.n_grad_steps // 1000 > self._last_refresh // 1000:
                self._last_refresh = self.n_grad_steps
                self.carry = self.carry._replace(
                    replay=self._refresh(self.carry.replay,
                                         float(self.n_grad_steps)))
            if (self.n_grad_steps - self._last_log) >= log_every:
                self._last_log = self.n_grad_steps
                self.log_status()
        if flush:
            self._flush_logs()

    # ------------------------------------------------------------------
    def train(self, n_grad_steps: int, log_every: int = 1000,
              max_wall_s: float = float("inf")):
        """Run until n_grad_steps more gradient steps are done."""
        if self.on_policy:
            return self._train_on_policy(n_grad_steps, log_every,
                                         max_wall_s)
        if not self._initialized:
            self.warmup()
        target = self.n_grad_steps + n_grad_steps
        t0 = time.time()
        # fixed train-chunk quantum: a single static scan length avoids
        # recompiles; 100 divides the 1000-step refresh cadence
        Q = 100
        while self.n_grad_steps < target and time.time() - t0 < max_wall_s:
            # how many grad steps are allowed by the pacing invariant
            allowed = int(self._n_loc_train_steps() / self.cfg.obsPerStep
                          ) - self.n_grad_steps
            allowed = min(allowed, target - self.n_grad_steps)
            n_tr = Q if allowed >= Q else max(0, allowed)
            if n_tr > 0:
                rs = self.carry.replay
                with self.profiler("TRAIN"):
                    if self.mesh is None:
                        self.key, k = jax.random.split(self.key)
                        self.params, self.opt_state, rs, metrics = \
                            self._train_chunk(self.params, self.opt_state,
                                              rs, k, n_tr)
                    else:
                        (self.params, self.opt_state, rs, metrics,
                         self._train_keys) = self._train_sharded(
                            self.params, self.opt_state, rs,
                            self._train_keys, n_tr)
                self.carry = self.carry._replace(replay=rs)
                self.n_grad_steps += n_tr
                self._last_metrics = metrics
                if self.cfg.debugNaN:
                    self._check_nan()
            if self.n_grad_steps // 1000 > self._last_refresh // 1000:
                self._last_refresh = self.n_grad_steps
                with self.profiler("REFRESH"):
                    self.carry = self.carry._replace(
                        replay=self._refresh(self.carry.replay,
                                             float(self.n_grad_steps)))
            if not self.block_data():
                # fixed-size rollout chunk (one compiled variant): enough
                # sweeps to allow ~Q more grad steps
                roll_n = max(1, min(64, int(np.ceil(
                    Q * self.cfg.obsPerStep / self.n_envs))))
                self._roll(roll_n)
            if (self.n_grad_steps - self._last_log) >= log_every:
                self._last_log = self.n_grad_steps
                self.log_status()
            # periodic checkpoint (saveFreq, Learner.cpp:146)
            if (self.run_dir and self.n_grad_steps //
                    self.cfg.saveFreq > getattr(self, "_last_save", 0)
                    // self.cfg.saveFreq):
                self._last_save = self.n_grad_steps
                self.save(os.path.join(self.run_dir, "checkpoint.pkl"))
        self._flush_logs()

    # ------------------------------------------------------------------
    def _train_on_policy(self, n_grad_steps: int, log_every: int = 1000,
                         max_wall_s: float = float("inf")):
        """PPO-style horizon cycle (PPO.cpp:44-115): fill nHorizon fresh
        transitions -> nEpochs of minibatch updates (reward-stats refresh
        once per data pass) -> clear the buffer -> repeat."""
        from smarties_tpu.replay.buffer import clear_all
        algo = self.algo
        horizon = algo.n_horizon
        updates_per_cycle = algo.n_epochs * horizon // self.cfg.batchSize
        per_epoch = max(1, horizon // self.cfg.batchSize)
        target = self.n_grad_steps + n_grad_steps
        t0 = time.time()
        while self.n_grad_steps < target and time.time() - t0 < max_wall_s:
            # ---- fill the horizon with fresh on-policy data ----
            while int(self.replay.n_stored_steps()) < horizon:
                self._roll(max(1, min(64, (horizon // 8) // self.n_envs
                                      or 1)))
            if not self._initialized:
                self.carry = self.carry._replace(
                    replay=self._init_stats(self.carry.replay))
                self._initialized = True
            # ---- nEpochs of updates over the frozen horizon ----
            done_in_cycle = 0
            while done_in_cycle < updates_per_cycle:
                n_tr = min(per_epoch, updates_per_cycle - done_in_cycle)
                rs = self.carry.replay
                if self.mesh is None:
                    self.key, k = jax.random.split(self.key)
                    self.params, self.opt_state, rs, metrics = \
                        self._train_chunk(self.params, self.opt_state, rs,
                                          k, n_tr)
                else:
                    (self.params, self.opt_state, rs, metrics,
                     self._train_keys) = self._train_sharded(
                        self.params, self.opt_state, rs,
                        self._train_keys, n_tr)
                self.carry = self.carry._replace(replay=rs)
                self.n_grad_steps += n_tr
                done_in_cycle += n_tr
                self._last_metrics = metrics
                if self.cfg.debugNaN:
                    self._check_nan()
            # once per data pass: reward/state stats (PPO.cpp:100-104)
            self.carry = self.carry._replace(
                replay=self._refresh(self.carry.replay,
                                     float(self.n_grad_steps)))
            if (self.n_grad_steps - self._last_log) >= log_every:
                self._last_log = self.n_grad_steps
                self.log_status()
            # ---- epoch over: discard data (PPO.cpp:105-112) ----
            self.carry = self.carry._replace(
                replay=clear_all(self.carry.replay))

    # ------------------------------------------------------------------
    def _check_nan(self):
        """Training-path NaN guard: raise on non-finite training metrics
        (host analog of the reference's per-message NaN checks,
        Agent.h:301-313; run per-chunk when cfg.debugNaN, and always at
        the logging cadence)."""
        m = getattr(self, "_last_metrics", {})
        for k in ("rmse", "grad_norm", "beta"):
            if k in m:
                v = np.asarray(m[k])
                if not np.isfinite(v).all():
                    raise FloatingPointError(
                        f"non-finite training metric '{k}' at grad step "
                        f"{self.n_grad_steps} — training diverged "
                        f"(reference analog: Agent::checkNanOrInf)")

    # ------------------------------------------------------------------
    def log_status(self, full: bool = False):
        self._flush_logs()
        self._check_nan()
        rs = self.replay
        avg_r = (np.mean(self._ep_returns[-100:])
                 if self._ep_returns else float("nan"))
        m = getattr(self, "_last_metrics", {})
        get = lambda k: float(np.asarray(m[k])[-1]) if k in m else float("nan")
        print(f"step {self.n_grad_steps:>8d} | envstep {self.n_env_steps:>9d}"
              f" | avgR {avg_r:8.2f} | beta {float(rs.beta):.3f}"
              f" | dkl {get('avg_dkl'):.4f} | rmse {get('rmse'):.3f}"
              f" | nEp {int(rs.n_stored_eps())}"
              f" | nObs {int(rs.n_stored_steps())}", flush=True)
        if self._grads_file is not None and "grad_norm" in m:
            # gradient-moment dump (StatsTracker grads_*.raw analog):
            # f32 rows [grad_step, grad_norm, grad_max]
            self._grads_file.write(np.asarray(
                [self.n_grad_steps, get("grad_norm"), get("grad_max")],
                np.float32).tobytes())
            self._grads_file.flush()
        if full:
            from smarties_tpu.utils.stats import (iw_histogram,
                                                  stats_header, stats_row)
            print(stats_header())
            print(stats_row(rs, self.n_grad_steps))
            print(iw_histogram(rs))
            print("profiler:\n" + self.profiler.table(), flush=True)

    # ------------------------------------------------------------------
    def evaluate(self, n_episodes: int = 10, max_steps: int = 1000,
                 materialize: bool = True):
        """Deterministic-policy evaluation episodes (bTrain=0 serving path,
        Worker.cpp:91-111 isOverTesting). One jitted scan instead of an
        eager dispatch per env step.

        materialize=False returns the on-device returns array without
        forcing a transfer (dispatch-only; the caller reads it later and
        performs the NaN guard) — lets benches overlap eval compute with
        other waits."""
        act = self.algo.make_act_fn(False)
        env, mdp = self.env, self.mdp
        k_app = mdp.n_appended_obs
        rs = self.replay
        rnn0 = (self.algo.init_rnn(n_episodes)
                if hasattr(self.algo, "init_rnn") else ())

        def run(params, state_mean, state_scale, k_env, k_act, max_steps):
            es = env.init(k_env, n_episodes)
            obs0 = mdp.observed(env.observe(es))
            hist0 = jnp.tile(obs0[:, None, :], (1, k_app + 1, 1))

            def body(carry, k):
                es, hist, rnn, rets, done = carry
                obs = mdp.observed(env.observe(es))
                hist = jnp.concatenate([obs[:, None, :], hist[:, :k_app]],
                                       axis=1)
                obs_std = ((hist - state_mean) * state_scale
                           ).reshape(obs.shape[0], -1)
                a, _, _, _, rnn = act(params, obs_std, k, rnn)
                es, r, d, _ = env.step(es, mdp.learner_to_env_action(a))
                rets = rets + r * (~done)
                done = done | d
                return (es, hist, rnn, rets, done), None

            init = (es, hist0, rnn0, jnp.zeros(n_episodes),
                    jnp.zeros(n_episodes, bool))
            (es, _, _, rets, done), _ = jax.lax.scan(
                body, init, jax.random.split(k_act, max_steps))
            return rets

        if not hasattr(self, "_eval_fns"):
            self._eval_fns = {}
        fkey = (n_episodes, max_steps)
        if fkey not in self._eval_fns:
            self._eval_fns[fkey] = jax.jit(partial(run,
                                                   max_steps=max_steps))
        self.key, k_env, k_act = jax.random.split(self.key, 3)
        rets_dev = self._eval_fns[fkey](
            self.params, rs.state_mean, rs.state_scale, k_env, k_act)
        if not materialize:
            return rets_dev
        rets = np.asarray(rets_dev)
        # NaN guard (reference: Agent::checkNanOrInf, Agent.h:301-313)
        assert np.isfinite(rets).all(), \
            "non-finite returns during evaluation — training diverged"
        return rets

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Checkpoint params/opt/replay/counters — includes the full replay
        buffer like the reference (MemoryBuffer.cpp:172-324)."""
        self._flush_logs()
        state = {
            "params": jax.device_get(self.params),
            "opt_state": jax.device_get(self.opt_state),
            "replay": jax.device_get(self.carry.replay),
            "inprog": jax.device_get(self.carry.inprog),
            "env_state": jax.device_get(self.carry.env_state),
            "key": jax.device_get(self.carry.key),
            "rnn": jax.device_get(self.carry.rnn),
            "host_key": jax.device_get(self.key),
            "n_env_steps": self.n_env_steps,
            "n_grad_steps": self.n_grad_steps,
            "last_refresh": self._last_refresh,
            "initialized": self._initialized,
            "cfg": self.cfg.to_dict(),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)  # write-then-rename atomicity

    def restore(self, path: str):
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.params = jax.device_put(state["params"])
        self.opt_state = jax.tree_util.tree_map(
            jnp.asarray, state["opt_state"])
        rnn = state.get("rnn", self.carry.rnn)  # zero carry for old ckpts
        self.carry = RolloutCarry(
            jax.tree_util.tree_map(jnp.asarray, state["replay"]),
            jax.tree_util.tree_map(jnp.asarray, state["inprog"]),
            jax.tree_util.tree_map(jnp.asarray, state["env_state"]),
            jnp.asarray(state["key"]),
            jax.tree_util.tree_map(jnp.asarray, rnn))
        self.key = jnp.asarray(state["host_key"])
        self.n_env_steps = state["n_env_steps"]
        self.n_grad_steps = state["n_grad_steps"]
        self._last_refresh = state.get("last_refresh", 0)
        self._initialized = state["initialized"]

    def close(self):
        """Flush pending logs and close the run-dir files."""
        self._flush_logs()
        for f in (self._rew_file, self._obs_file, self._grads_file):
            if f is not None:
                f.close()
