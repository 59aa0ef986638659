"""Setups, float64 references and card queries shared by `bench.py`,
`chip_smoke.py` and the tests.

  build_trainer              the benchmark's V-RACER cart-pole learner
  build_atari                the Atari-scale RACER conv train step
  grad_parity                one V-RACER step on 1 device vs K mesh shards
  reference_return_estimate  float64 NumPy Retrace/GAE backward recursion
  card_info                  the card's name and power limit (nvidia-smi)
"""
from __future__ import annotations

import subprocess

import numpy as np


def card_info() -> str:
    """Name and power limit as nvidia-smi reports them (a child process
    that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_trainer(seed=0, n_envs=1024, n_slots=4096, batch=256,
                  layers=(128, 128), max_tot=262144, min_tot=16384):
    """V-RACER cart-pole learner: [128,128] SoftSign MLP, batch 256, 1024
    env lanes, 4096 replay slots of L=500."""
    from smarties_tpu.envs import cartpole
    from smarties_tpu.runtime.trainer import Trainer
    from smarties_tpu.utils.config import HyperParameters
    cfg = HyperParameters(minTotObsNum=min_tot, maxTotObsNum=max_tot,
                          batchSize=batch, obsPerStep=1.0,
                          nnLayerSizes=list(layers), randSeed=seed)
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=n_envs,
                 n_slots=n_slots, max_len=cartpole.MAX_STEPS)
    tr.log_flush_threshold = 10 ** 9   # defer all episode-log transfers
    return tr


def build_atari(Q=1024, E=512, L=128, batch=128, image=84):
    """Atari-scale RACER setup (reference RACER_atari.json recipe: batch
    128, layers [512], conv preprocessing; Mnih et al. 84x84x4 stack),
    uint8 image replay of E x (L+1) frames, full ReF-ER pipeline on
    synthetic data. Returns (algo, jitted Q-step chunk, args)."""
    import jax
    import jax.numpy as jnp
    from smarties_tpu.algos.base import presample_uniform
    from smarties_tpu.algos.vracer import VRacer
    from smarties_tpu.core.mdp import MDPSpec
    from smarties_tpu.replay import buffer as rb
    from smarties_tpu.utils.config import HyperParameters

    c1 = (image - 8) // 4 + 1
    c2 = (c1 - 4) // 2 + 1
    mdp = MDPSpec(dim_state=image * image, dim_action=1,
                  discrete_values=(6,), n_appended_obs=3,
                  conv_layers=((image, image, 4, 32, 8, 4),
                               (c1, c1, 32, 64, 4, 2),
                               (c2, c2, 64, 64, 3, 1)))
    cfg = HyperParameters(batchSize=batch, nnLayerSizes=[512], gamma=0.99,
                          minTotObsNum=16384, maxTotObsNum=262144)
    algo = VRacer(mdp, cfg)   # discrete -> RACER rewrite
    params, opt = algo.init(jax.random.PRNGKey(0))
    rs = rb.init_replay(E, L, mdp.dim_state_observed, mdp.dim_action,
                        mdp.dim_policy, cfg.clipImpWeight,
                        state_dtype=jnp.uint8, mu_init=rb.safe_mu(mdp))
    rs = rs._replace(
        ep_id=jnp.arange(E, dtype=jnp.int32),
        length=jnp.full((E,), L, jnp.int32),
        states=jax.random.randint(jax.random.PRNGKey(1),
                                  (E, L + 1, mdp.dim_state_observed),
                                  0, 256, jnp.uint8),
        rho=jnp.ones((E, L + 1)))

    def chunk(p, o, r, k):
        ks = jax.random.split(k, Q)
        eps, ts = presample_uniform(ks, r, cfg.batchSize)

        def body(c, x):
            pp, oo, rr = c
            kk, e, t = x
            pp, oo, rr, _ = algo.train_step(pp, oo, rr, kk,
                                            sample_override=(e, t))
            return (pp, oo, rr), None
        c, _ = jax.lax.scan(body, (p, o, r), (ks, eps, ts))
        return c

    return algo, jax.jit(chunk), (params, opt, rs, jax.random.PRNGKey(2))


def grad_parity(K=4, B=32):
    """Updated params of one V-RACER step on a pinned global batch: on one
    device holding every episode, and split over K devices whose replay
    shards hold the owning episodes (psum of shard-local gradient sums).
    Returns (leaves_1dev, leaves_Kdev) as NumPy arrays."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from smarties_tpu.algos.vracer import VRacer
    from smarties_tpu.envs import cartpole
    from smarties_tpu.parallel.mesh import AXIS, make_mesh, replay_pspec
    from smarties_tpu.replay import buffer as rb
    from smarties_tpu.utils.config import HyperParameters

    cfg = HyperParameters(minTotObsNum=512, maxTotObsNum=2048, batchSize=B,
                          obsPerStep=1.0, nnLayerSizes=[32, 32], randSeed=7)
    algo = VRacer(cartpole.MDP, cfg)
    key = jax.random.PRNGKey(0)
    params, opt = algo.init(key)

    # one replay holding 16 short random episodes (16/K per future shard)
    n_slots, max_len, dimS = 16, 32, cartpole.MDP.dim_state_observed
    rs = rb.init_replay(n_slots, max_len, dimS, 1, 2, cfg.clipImpWeight,
                        mu_init=rb.safe_mu(cartpole.MDP))
    ks = jax.random.split(key, 5)
    L1 = max_len + 1
    rs = rs._replace(
        ep_id=jnp.arange(n_slots, dtype=jnp.int32),
        length=jnp.full((n_slots,), 20, jnp.int32),
        states=jax.random.normal(ks[0], (n_slots, L1, dimS)) * 0.3,
        actions=jax.random.normal(ks[1], (n_slots, L1, 1)) * 0.5,
        mus=jnp.concatenate([
            jax.random.normal(ks[2], (n_slots, L1, 1)) * 0.3,
            jnp.ones((n_slots, L1, 1))], -1),
        rewards=jax.random.normal(ks[3], (n_slots, L1)) * 0.1,
        rho=jnp.ones((n_slots, L1)),
        qret=jax.random.normal(ks[4], (n_slots, L1)) * 0.2)

    # pinned global batch: B/K samples in each shard's slot range
    k_ep, k_t = jax.random.split(jax.random.PRNGKey(42))
    ep_local = jax.random.randint(k_ep, (K, B // K), 0, n_slots // K)
    t_pin = jax.random.randint(k_t, (K, B // K), 0, 19)
    ep_global = (ep_local + jnp.arange(K, dtype=jnp.int32)[:, None]
                 * (n_slots // K)).reshape(-1)
    key_step = jax.random.PRNGKey(99)

    def sharded(p, o, r, epl, tl):
        p, o, r, _ = algo.train_step(
            p, o, r, key_step, axis_name=AXIS,
            sample_override=(epl.reshape(-1), tl.reshape(-1)))
        return p, o

    mesh = make_mesh(K)
    f = jax.jit(shard_map(
        sharded, mesh=mesh,
        in_specs=(P(), P(), replay_pspec(rs), P(AXIS), P(AXIS)),
        out_specs=(P(), P()), check_vma=False))
    with jax.default_matmul_precision("highest"):
        p1, _, _, _ = jax.jit(lambda p, o, r: algo.train_step(
            p, o, r, key_step,
            sample_override=(ep_global, t_pin.reshape(-1))))(params, opt, rs)
        p4, _ = f(params, opt, rs, ep_local.reshape(K, 1, B // K),
                  t_pin.reshape(K, 1, B // K))
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(p1)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(p4)])


def reference_return_estimate(r, v, a, rho, length, terminal, gamma, lam,
                              mode="retrace", err_baseline=0.0):
    """float64 backward recursion of the reference (computeRetrace,
    computeRetraceExplBonus, computeGAE: MemoryProcessing.cpp:391-416),
    all [E, L+1] episodes at once; zero beyond each episode's end."""
    r, v, a, rho = (np.asarray(x, np.float64) for x in (r, v, a, rho))
    length = np.asarray(length)
    E, L1 = r.shape
    rows = np.arange(E)
    q = np.zeros((E, L1))
    q[rows, length] = np.where(terminal, 0.0, v[rows, length])
    for t in range(L1 - 2, -1, -1):
        if mode == "GAE":
            qt = r[:, t + 1] + gamma * (v[:, t + 1] + lam * (
                q[:, t + 1] - v[:, t + 1]))
        else:
            c = np.minimum(rho[:, t + 1], 1.0)
            adv = q[:, t + 1] - a[:, t + 1] - v[:, t + 1]
            qt = r[:, t + 1] + gamma * (v[:, t + 1] + lam * c * adv)
            if mode == "retraceExplore":
                qt = qt + (1 - gamma) * (np.abs(adv) - err_baseline)
        q[:, t] = np.where(t < length, qt, q[:, t])
    return q
