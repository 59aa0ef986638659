"""Engine: public entry point for external (user-application) envs.

Re-implements the reference's Engine + master serving loop
(source/smarties/Engine.{h,cpp}, Core/Master.cpp, Core/Worker.cpp) for the
device runtime: env apps run in worker processes behind the Communicator API
(runtime/communicator.py); the learner batches all pending agent states
into one jitted action-selection call, assembles episodes host-side, and
commits them to the on-device replay; training interleaves under the
obsPerStep pacing invariant (Learner.cpp:102-123).

Capabilities matching the reference serving stack:
- multiple learners per session when the app declares per-agent MDPs
  (Communicator::agentsDefineDifferentMDP, Environment.h:84-97;
  lane -> learners[localID] routing, Worker.cpp:148,188);
- per-agent persistent recurrent contexts so LSTM/GRU policies serve
  external envs (AgentContext, Network/ThreadContext.h:19-100,
  Approximator.h:89-96);
- env throttling: action replies are withheld until training catches up
  with the obsPerStep ratio (learnersBlockingDataAcquisition,
  Core/Master.cpp:118-144);
- FAIL-status / env-crash handling: the agent's in-progress episode is
  dropped and its recurrent context reset (Agent.h:83-86); crashed apps
  are respawned by the EnvPool (vs Worker.cpp:146's die());
- periodic checkpoints every saveFreq grad steps (Learner.cpp:146).

Usage (mirrors README.rst:104-133 / smarties_pybind11.cpp):

    import smarties_tpu
    def app_main(comm):
        comm.setStateActionDims(6, 1)
        comm.setActionScales([10.], [-10.], True)
        while True:
            comm.sendInitState(env.reset())
            while True:
                act = comm.recvAction()
                ...
                comm.sendState(s, r) / sendTermState / sendLastState

    e = smarties_tpu.Engine(sys.argv)
    e.setNEnvironments(8)
    e.run(app_main)
"""
from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from smarties_tpu.replay import buffer as rb
from smarties_tpu.runtime.communicator import CONT, FAIL, INIT, LAST, TERM
from smarties_tpu.runtime.env_pool import EnvPool
from smarties_tpu.utils.config import HyperParameters


class _EpisodeAssembler:
    """Host-side in-progress episode for one agent lane
    (MemoryBuffer::inProgress analog)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.obs, self.acts, self.mus, self.rewards = [], [], [], []
        self.values, self.advs = [], []

    def add_state(self, obs, reward):
        self.obs.append(obs)
        self.rewards.append(reward)

    def add_action(self, act, mu, value, adv):
        self.acts.append(act)
        self.mus.append(mu)
        self.values.append(value)
        self.advs.append(adv)

    def finalize(self, terminal: bool, max_len: int):
        """-> (padded numpy arrays, length, terminal) for device commit."""
        T = len(self.acts)
        T = min(T, max_len)
        L1 = max_len + 1

        def pad(rows, dim):
            out = np.zeros((L1, dim), np.float32)
            k = min(len(rows), L1)
            if k:
                out[:k] = np.asarray(rows[:k], np.float32).reshape(k, dim)
            return out

        n_obs = len(self.obs[0])
        states = pad(self.obs, n_obs)
        acts = pad(self.acts, len(self.acts[0]) if self.acts else 1)
        mus = pad(self.mus, len(self.mus[0]) if self.mus else 1)
        rewards = np.zeros(L1, np.float32)
        rewards[:min(len(self.rewards), L1)] = self.rewards[:L1]
        value = np.zeros(L1, np.float32)
        value[:min(len(self.values), L1)] = self.values[:L1]
        adv = np.zeros(L1, np.float32)
        adv[:min(len(self.advs), L1)] = self.advs[:L1]
        ret = float(np.sum(self.rewards))
        self.reset()
        return states, acts, mus, rewards, value, adv, T, terminal, ret


class _LearnerBundle:
    """One learner + its replay + jitted programs + pacing counters — the
    reference's learners vector entry (Worker.cpp:144-186: each incoming
    agent state routes to learners[getLearnerID(localID)])."""

    def __init__(self, learner_id: int, mdp, cfg: HyperParameters,
                 lanes: List[int], max_ep_len: int):
        from smarties_tpu.algos.registry import make_learner
        self.learner_id = learner_id
        self.mdp = mdp
        self.cfg = cfg
        self.lanes = list(lanes)
        self.lane_slot = {lane: i for i, lane in enumerate(self.lanes)}
        self.max_ep_len = max_ep_len
        self.algo = make_learner(mdp, cfg)
        self.obs_idx = np.nonzero(mdp.observable_mask)[0]

        key = jax.random.PRNGKey(cfg.randSeed)
        key = jax.random.fold_in(key, learner_id)
        self.key, k_init = jax.random.split(key)
        self.params, self.opt_state = self.algo.init(k_init)
        n_slots = max(64, 2 * cfg.maxTotObsNum // max(8, max_ep_len // 8))
        self.rs = rb.init_replay(n_slots, max_ep_len,
                                 mdp.dim_state_observed, mdp.dim_action,
                                 mdp.dim_policy, cfg.clipImpWeight,
                                 mu_init=rb.safe_mu(mdp))
        # user-provided state box seeds the standardization stats until
        # the online estimates initialize (setStateScales,
        # Communicator.cpp:98-122, StateAction.h:181-203)
        ss = mdp.state_stats_init
        if ss is not None:
            mean, std = ss
            self.rs = self.rs._replace(
                state_mean=jnp.asarray(mean), state_std=jnp.asarray(std),
                state_scale=jnp.asarray(1.0 / std))
        self.act_jit = jax.jit(self.algo.make_act_fn(train=cfg.bTrain))
        # per-agent persistent recurrent context for acting
        # (AgentContext analog); () for feed-forward nets
        self.rnn = (self.algo.init_rnn(len(self.lanes))
                    if hasattr(self.algo, "init_rnn") else ())

        algo = self.algo

        def commit_one(rs, states, acts, mus, rewards, value, adv, length,
                       terminal):
            """Ingest one finished host-assembled episode
            (MemoryBuffer::terminateCurrentEpisode, :118-170)."""
            from smarties_tpu.ops.returns import batched_return_estimate
            L1 = rs.max_len + 1
            rho = (jnp.arange(L1)[None, :]
                   < length[:, None]).astype(jnp.float32)
            r_scaled = (rewards - rs.rew_mean) * rs.rew_scale
            mode = algo.returns_mode
            qret = (batched_return_estimate(
                r_scaled, value, adv, rho, length, terminal,
                cfg.gamma, cfg.lambda_, mode,
                err_baseline=rs.max_abs_error)
                if mode != "none" else jnp.zeros_like(value))
            return rb.commit_episodes(
                rs, states, acts, mus, rewards, value, adv, qret, rho,
                length, terminal, jnp.ones((1,), bool),
                cfg.maxTotObsNum, cfg.ERoldSeqFilter)

        self.commit_jit = jax.jit(commit_one)

        can_pre = (getattr(algo, "presample", False)
                   and cfg.dataSamplingAlgo in ("uniform", "default"))

        def train_chunk(params, opt_state, rs, key, n):
            ks = jax.random.split(key, n)
            if can_pre:
                # hoisted uniform pre-sampling (base.presample_uniform)
                from smarties_tpu.algos.base import presample_uniform
                eps, ts = presample_uniform(ks, rs, cfg.batchSize)

                def body(c, x):
                    p, o, r = c
                    k, e, t = x
                    p, o, r, m = algo.train_step(
                        p, o, r, k, sample_override=(e, t))
                    return (p, o, r), m

                xs = (ks, eps, ts)
            else:
                def body(c, k):
                    p, o, r = c
                    p, o, r, m = algo.train_step(p, o, r, k)
                    return (p, o, r), m

                xs = ks
            (params, opt_state, rs), ms = jax.lax.scan(
                body, (params, opt_state, rs), xs)
            return params, opt_state, rs, ms

        self.train_jit = jax.jit(train_chunk, static_argnums=4)
        self.refresh_jit = jax.jit(algo.refresh)
        self.init_stats_jit = jax.jit(algo.initialize_stats)

        # counters (per-learner, like Learner.h's nGradSteps/nLocTimeSteps)
        self.n_env_steps = 0
        self.n_grad = 0
        self.start_env_steps = 0
        self.initialized = False
        self.last_refresh = 0

    # ------------------------------------------------------------------
    def reset_rnn_lane(self, lane: int):
        """Zero the recurrent context of one agent lane (AgentContext
        reset at episode start / FAIL)."""
        if self.rnn == ():
            return
        i = self.lane_slot[lane]
        self.rnn = jax.tree_util.tree_map(
            lambda h: h.at[i].set(0.0), self.rnn)

    def commit(self, ep_arrays, T, terminal):
        self.rs = self.commit_jit(
            self.rs, *[jnp.asarray(a)[None] for a in ep_arrays],
            jnp.asarray([T], jnp.int32), jnp.asarray([terminal]))

    # pacing (Learner::blockDataAcquisition, Learner.cpp:102-113)
    def allowed_grad_steps(self, target: int) -> int:
        allowed = int((self.n_env_steps - self.start_env_steps)
                      / self.cfg.obsPerStep) - self.n_grad
        return min(allowed, target - self.n_grad)

    def blocking_data(self, target: int) -> bool:
        """learnersBlockingDataAcquisition (Master.cpp:129): replies are
        withheld while the learner is behind on grad steps."""
        return self.initialized and self.allowed_grad_steps(target) > 0

    def maybe_init_stats(self):
        if (not self.initialized and
                int(self.rs.n_stored_steps()) >= self.cfg.minTotObsNum):
            self.rs = self.init_stats_jit(self.rs)
            self.initialized = True
            self.start_env_steps = self.n_env_steps

    def train_to_pace(self, target: int, quantum: int = 100):
        """Run grad steps until the obsPerStep invariant is restored —
        called BEFORE replying to envs, so envs stall exactly like the
        reference's withheld replies (Master.cpp:118-144)."""
        self.maybe_init_stats()
        if not self.initialized:
            return
        while True:
            n_tr = min(quantum, self.allowed_grad_steps(target))
            if n_tr <= 0:
                return
            self.key, k_tr = jax.random.split(self.key)
            self.params, self.opt_state, self.rs, _ = self.train_jit(
                self.params, self.opt_state, self.rs, k_tr, n_tr)
            self.n_grad += n_tr
            if self.n_grad // 1000 > self.last_refresh // 1000:
                self.last_refresh = self.n_grad
                self.rs = self.refresh_jit(self.rs, float(self.n_grad))

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {"params": jax.device_get(self.params),
                "opt_state": jax.device_get(self.opt_state),
                "replay": jax.device_get(self.rs),
                "n_grad_steps": self.n_grad,
                "n_env_steps": self.n_env_steps,
                "initialized": self.initialized,
                "start_env_steps": self.start_env_steps}

    def restore(self, snap: dict):
        self.params = jax.tree_util.tree_map(jnp.asarray, snap["params"])
        self.opt_state = jax.tree_util.tree_map(jnp.asarray,
                                                snap["opt_state"])
        self.rs = jax.tree_util.tree_map(jnp.asarray, snap["replay"])
        self.n_grad = snap.get("n_grad_steps", 0)
        self.n_env_steps = snap.get("n_env_steps", 0)
        self.initialized = snap.get("initialized", True)
        self.start_env_steps = snap.get(
            "start_env_steps", max(0, self.n_env_steps - self.n_grad))


class Engine:
    def __init__(self, argv: Optional[List[str]] = None):
        self.argv = argv or []
        self.cfg = HyperParameters()
        self.n_envs = 1
        self.train_steps = 10_000_000
        self.run_dir = None
        self.restart_path = None
        self.max_ep_len = 1024
        self.n_eval_episodes = 32   # --nEvalEpisodes when bTrain == 0
        self.workers_per_env = 1    # Engine::setNworkersPerEnvironment
        self._parsed = False

    # ---------------- CLI (ExecutionInfo::parse, :95-170) ---------------
    def parse(self) -> bool:
        p = argparse.ArgumentParser(prog="smarties_tpu", add_help=True)
        p.add_argument("--nEnvironments", type=int, default=1)
        p.add_argument("--nTrainSteps", type=int, default=10_000_000)
        p.add_argument("--settings", type=str, default=None)
        p.add_argument("--runDir", type=str, default=None)
        p.add_argument("--restart", type=str, default=None)
        p.add_argument("--randSeed", type=int, default=0)
        p.add_argument("--maxEpisodeLength", type=int, default=1024)
        p.add_argument("--workersPerEnvironment", type=int, default=1)
        # eval-mode flags (ExecutionInfo.cpp:95-170: --bTrain /
        # --nEvalEpisodes; eval implies restart from "." by default,
        # Engine.cpp:92-95)
        p.add_argument("--bTrain", type=int, default=1)
        p.add_argument("--nEvalEpisodes", type=int, default=0)
        try:
            args, _ = p.parse_known_args(self.argv[1:])
        except SystemExit:
            return True
        if args.settings:
            self.cfg = HyperParameters.from_json(args.settings)
        self.cfg.randSeed = args.randSeed
        self.n_envs = args.nEnvironments
        self.train_steps = args.nTrainSteps
        self.run_dir = args.runDir
        self.restart_path = args.restart
        self.max_ep_len = args.maxEpisodeLength
        self.workers_per_env = args.workersPerEnvironment
        if args.nEvalEpisodes > 0:
            args.bTrain = 0
            self.n_eval_episodes = args.nEvalEpisodes
        if not args.bTrain:
            self.cfg.bTrain = 0
            if self.restart_path is None:    # Engine.cpp:92-95
                self.restart_path = os.path.join(
                    self.run_dir or ".", "checkpoint.pkl")
        self._parsed = True
        return False

    # ---------------- setters (Engine.cpp:33-85) ------------------------
    def setNEnvironments(self, n: int):
        self.n_envs = n

    def setNTrainSteps(self, n: int):
        self.train_steps = n

    def setRandSeed(self, seed: int):
        self.cfg.randSeed = seed

    def setSettings(self, cfg: HyperParameters):
        self.cfg = cfg

    def setLearnerSettings(self, learner_id: int, cfg: HyperParameters):
        """Per-learner hyperparameters/algorithm override for competing
        agents — the programmatic form of the reference's per-learner
        `settings_%02u.json` lookup (AlgoFactory::findSettingsFile,
        AlgoFactory.cpp:37-58): each learner may train with a different
        algorithm and recipe (e.g. V-RACER predator vs DPG prey)."""
        if not hasattr(self, "learner_cfgs"):
            self.learner_cfgs = {}
        self.learner_cfgs[int(learner_id)] = cfg

    def _resolve_learner_cfg(self, learner_id: int) -> HyperParameters:
        """Settings for learner `learner_id`: programmatic override
        first, then `settings_%02u.json` in the run dir, then the shared
        settings (the reference falls back to `settings.json`,
        AlgoFactory.cpp:37-58)."""
        cfgs = getattr(self, "learner_cfgs", {})
        if learner_id in cfgs:
            return cfgs[learner_id]
        if self.run_dir:
            path = os.path.join(self.run_dir,
                                f"settings_{learner_id:02d}.json")
            if os.path.exists(path):
                cfg = HyperParameters.from_json(path)
                cfg.randSeed = self.cfg.randSeed
                return cfg
        return self.cfg

    def setRestartFolderPath(self, path: str):
        self.restart_path = path

    def setMaxEpisodeLength(self, n: int):
        self.max_ep_len = n

    def setNumEvaluationEpisodes(self, n: int):
        self.n_eval_episodes = n

    def setNworkersPerEnvironment(self, n: int):
        """Each env app is a team of n processes sharing a TeamComm — the
        environment_app_comm analog for multi-process simulations
        (Engine.cpp:51-55, ExecutionInfo.cpp:315-332; SURVEY §2.9 P6).
        app_main is then called as app_main(comm, team)."""
        self.workers_per_env = int(n)

    def setSimulationArgumentsFilePath(self, app_settings: str,
                                       n_step_per_file: str = ""):
        """Comma-separated staged app arg-files + per-stage step budgets
        (Engine::setSimulationArgumentsFilePath, Engine.cpp:63;
        Launcher::initArgumentFileNames, Launcher.cpp:122-151). Stage k
        activates once the env's own step counter passes the cumulative
        budget; the last stage runs forever."""
        files = [f for f in app_settings.split(",") if f]
        steps = [int(s) for s in n_step_per_file.split(",") if s] \
            if n_step_per_file else [0] * len(files)
        assert len(steps) == len(files), \
            "appSettings and nStepPappSett length mismatch"
        limits = [0]
        for s in steps[:-1]:
            limits.append(limits[-1] + s)
        self._launch_opts = dict(getattr(self, "_launch_opts", {}) or {},
                                 app_settings=files,
                                 arg_step_limits=limits)

    def setSimulationSetupFolderPath(self, folder: str):
        """Folder whose contents are copied into every per-sim run dir
        (Engine.cpp:67, Launcher::createGoRunDir setupFolder copy)."""
        self._launch_opts = dict(getattr(self, "_launch_opts", {}) or {},
                                 setup_folder=folder, sim_dirs=True)

    def setUseSimulationDirectories(self, enable: bool = True):
        """Each launch of every env app runs in its own
        simulation_%03u_%05u directory under run_dir
        (Launcher::createGoRunDir, Launcher.cpp:154-186)."""
        self._launch_opts = dict(getattr(self, "_launch_opts", {}) or {},
                                 sim_dirs=bool(enable))

    # ---------------- main loop (Engine::run, Master/Worker) ------------
    def run(self, app_main: Callable, max_wall_s: float = float("inf"),
            pool=None, serving: Optional[str] = None):
        """app_main: python callable run in forked workers; OR pass a
        ready-made pool (e.g. runtime.socket_pool.SocketEnvPool for native
        C++/Fortran apps) and app_main is ignored.

        serving: "event" (default when the pool supports it) answers each
        env the moment its state lands — nonblocking round-robin like the
        reference's master (Master::waitForStateActionCallers,
        Core/Master.cpp:118-144), so one slow env app does not rate-limit
        the rest; "lockstep" waits for every lane each round."""
        cfg = self.cfg
        if pool is None:
            opts = dict(getattr(self, "_launch_opts", {}) or {})
            if opts and "run_dir" not in opts:
                opts["run_dir"] = self.run_dir or "."
            pool = EnvPool(app_main, self.n_envs, seed=cfg.randSeed,
                           launch_opts=opts or None,
                           workers_per_env=self.workers_per_env)
        mdp = pool.probe_spec()
        self.mdp = mdp
        n_agents = pool.n_agents
        n_lanes = pool.n_lanes
        mdps = getattr(pool, "mdps", [mdp])
        n_learners = len(mdps)

        # lane -> learner routing (Worker::getLearnerID, Worker.cpp:188:
        # learnerID == localID iff multiple learners, else 0)
        lane_learner = [(lane % n_agents) if n_learners > 1 else 0
                        for lane in range(n_lanes)]
        bundles = [_LearnerBundle(
            l, mdps[l],
            self._resolve_learner_cfg(l),
            [lane for lane in range(n_lanes) if lane_learner[lane] == l],
            self.max_ep_len) for l in range(n_learners)]
        self.learners = bundles
        self.algo = bundles[0].algo

        lanes = [_EpisodeAssembler() for _ in range(n_lanes)]
        # per-lane obs history for acting (frame stacking clamped at the
        # episode start, Episode::standardizedState)
        hist: List[list] = [[] for _ in range(n_lanes)]
        # cached per-lane stacked-frame row, refreshed only when a state
        # event arrives — the act-batch build below then stacks cached
        # rows instead of re-concatenating every lane's frames each
        # partial round (ADVICE r3 #4: per-poll host work stays
        # O(events), not O(n_lanes x frames))
        obs_cat: List = [None] * n_lanes
        untracked = set(pool.spec.get("untracked_agents", ()))

        # eval mode (bTrain == 0, --nEvalEpisodes): serve deterministic
        # actions, no training (Engine.cpp:92-95, Worker.cpp:91-111)
        eval_mode = not cfg.bTrain
        eval_episodes_done = 0
        n_env_steps_total = 0
        obs_file = rew_file = None
        if self.run_dir:
            os.makedirs(self.run_dir, exist_ok=True)
            # raw obs logging (Agent::writeData analog, Agent.h:259-299):
            # f32 rows [lane, status, state..., reward]
            obs_file = open(os.path.join(self.run_dir,
                                         "agent_00_rank00_obs.raw"), "ab")
            rew_file = open(os.path.join(
                self.run_dir, "agent_00_rank00_cumulative_rewards.dat"), "a")

        # restart from a checkpoint (Engine::setRestartFolderPath)
        if self.restart_path and os.path.exists(self.restart_path):
            with open(self.restart_path, "rb") as f:
                snap = pickle.load(f)
            if "learners" in snap:
                for b, s in zip(bundles, snap["learners"]):
                    b.restore(s)
            else:   # single-learner snapshot format
                bundles[0].restore(snap)

        def save_checkpoint():
            snap = {"learners": [b.snapshot() for b in bundles],
                    "n_grad_steps": bundles[0].n_grad,
                    "n_env_steps": bundles[0].n_env_steps,
                    "cfg": cfg.to_dict()}
            tmp = os.path.join(self.run_dir, "checkpoint.pkl.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(snap, f)
            os.replace(tmp, os.path.join(self.run_dir, "checkpoint.pkl"))

        if serving is None:
            serving = "event" if hasattr(pool, "poll_states") else \
                "lockstep"
        last_save = 0
        t0 = time.time()
        try:
            while (any(b.n_grad < self.train_steps for b in bundles)
                   and time.time() - t0 < max_wall_s):
                if eval_mode and eval_episodes_done >= self.n_eval_episodes:
                    break
                # ---- serve pending envs one round ----
                if serving == "event":
                    events, ready_lanes = pool.poll_states(timeout=0.05)
                    ready = set(ready_lanes)
                else:
                    events, states, rewards, statuses = \
                        pool.gather_states()
                    ready = None    # every lane is served each round
                for lane, status, state, reward in events:
                    b = bundles[lane_learner[lane]]
                    if status == FAIL:
                        # env crashed: drop the in-progress episode and
                        # reset the agent context (Agent.h:83-86)
                        lanes[lane].reset()
                        hist[lane] = []
                        obs_cat[lane] = None
                        b.reset_rnn_lane(lane)
                        continue
                    # per-message NaN guard (Agent::checkNanOrInf,
                    # Agent.h:301-313; Communicator.cpp:267-270)
                    if not (np.isfinite(state).all()
                            and np.isfinite(reward)):
                        raise FloatingPointError(
                            f"env lane {lane} sent non-finite "
                            f"state/reward (status {status})")
                    obs = state[b.obs_idx]
                    if status == INIT:
                        hist[lane] = [obs]
                        b.reset_rnn_lane(lane)
                    else:
                        hist[lane].append(obs)
                        if len(hist[lane]) > b.mdp.n_appended_obs + 1:
                            hist[lane] = hist[lane][-(b.mdp.n_appended_obs
                                                      + 1):]
                    k_app = b.mdp.n_appended_obs
                    if k_app:
                        h = hist[lane]
                        obs_cat[lane] = np.concatenate(
                            [h[max(len(h) - 1 - j, 0)]
                             for j in range(k_app + 1)])
                    else:
                        obs_cat[lane] = obs
                    if (lane % n_agents) in untracked:
                        # acting-only agents: serve actions, store nothing
                        # (trackEpisodes=false, MemoryBuffer.cpp:50-98)
                        continue
                    if obs_file is not None:
                        row = np.concatenate([[lane, status], state,
                                              [reward]]).astype(np.float32)
                        obs_file.write(row.tobytes())
                    if eval_mode and status in (TERM, LAST):
                        eval_episodes_done += 1
                    if status == INIT:
                        lanes[lane].reset()
                        lanes[lane].add_state(obs, 0.0)
                    else:
                        lanes[lane].add_state(obs, reward)
                        b.n_env_steps += 1
                        n_env_steps_total += 1
                    if status in (TERM, LAST):
                        arrs = lanes[lane].finalize(status == TERM,
                                                    self.max_ep_len)
                        *ep_arrays, T, term, ret = arrs
                        b.commit(ep_arrays, T, term)
                        if rew_file:
                            rew_file.write(
                                f"{b.n_grad} {n_env_steps_total} "
                                f"{lane} {T} {ret}\n")

                # ---- training BEFORE replying: envs stall while the
                # learner is behind (Master.cpp:118-144 withheld replies)
                if not eval_mode:
                    for b in bundles:
                        b.train_to_pace(self.train_steps)
                    # periodic checkpoint (saveFreq, Learner.cpp:146)
                    if (self.run_dir and bundles[0].n_grad // cfg.saveFreq
                            > last_save // cfg.saveFreq):
                        last_save = bundles[0].n_grad
                        save_checkpoint()

                # ---- act on pending requests (batched per learner; the
                # batch always covers ALL of the learner's lanes so one
                # compiled shape serves every partial round — replies and
                # recurrent-state updates apply only to ready lanes) ----
                env_act: List = [None] * n_lanes
                for b in bundles:
                    b_ready = b.lanes if ready is None else \
                        [ln for ln in b.lanes if ln in ready]
                    if not b_ready:
                        continue
                    k_app = b.mdp.n_appended_obs
                    zero_row = np.zeros(len(b.obs_idx) * (k_app + 1))
                    obs = jnp.asarray(np.stack(
                        [obs_cat[lane] if obs_cat[lane] is not None
                         else zero_row for lane in b.lanes]), jnp.float32)
                    obs_std = ((obs.reshape(len(b.lanes), k_app + 1, -1)
                                - b.rs.state_mean) * b.rs.state_scale
                               ).reshape(len(b.lanes), -1)
                    b.key, k_act = jax.random.split(b.key)
                    a, mu, val, adv, new_rnn = b.act_jit(
                        b.params, obs_std, k_act, b.rnn)
                    if b.rnn != () and ready is not None:
                        # recurrent contexts advance ONLY for served
                        # lanes (AgentContext moves one step per reply)
                        sel = np.asarray([ln in ready for ln in b.lanes])
                        idx = jnp.asarray(np.nonzero(sel)[0])
                        b.rnn = jax.tree_util.tree_map(
                            lambda old, new: old.at[idx].set(new[idx]),
                            b.rnn, new_rnn)
                    else:
                        b.rnn = new_rnn
                    acts_env = np.asarray(
                        b.mdp.learner_to_env_action(a), np.float64)
                    if not np.isfinite(acts_env).all():
                        raise FloatingPointError(
                            "learning algorithm picked a nan or inf "
                            "action (Worker.cpp:151-154)")
                    a_np, mu_np = np.asarray(a), np.asarray(mu)
                    v_np, adv_np = np.asarray(val), np.asarray(adv)
                    for i, lane in enumerate(b.lanes):
                        if ready is not None and lane not in ready:
                            continue
                        env_act[lane] = acts_env[i]
                        if (lane % n_agents) in untracked:
                            lanes[lane].reset()
                            continue
                        lanes[lane].add_action(a_np[i], mu_np[i],
                                               v_np[i], adv_np[i])
                pool.send_actions(env_act)
        finally:
            pool.kill()
            if rew_file:
                rew_file.close()
            if obs_file:
                obs_file.close()
        # backward-compatible single-learner accessors
        self.params = bundles[0].params
        self.opt_state = bundles[0].opt_state
        self.replay = bundles[0].rs
        self.n_grad_steps = bundles[0].n_grad
        self.n_env_steps = n_env_steps_total if n_learners == 1 \
            else bundles[0].n_env_steps
        if self.run_dir and not eval_mode:
            save_checkpoint()
        return self.params
