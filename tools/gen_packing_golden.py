"""Generate golden training traces guarding the replay-packing refactor.

Run from the PRE-change revision to capture reference trajectories; then
`tests/test_packing_parity.py` re-runs the same scenarios on the current
code and asserts identical results. Covers every write-back flavor:
fused V-RACER (scatter write_back + write_next_value + commit +
refresh), interleaved DQN (train() path), ACER (windowed write-back),
PPO (on-policy horizon + clear_all), LSTM V-RACER (BPTT window gathers),
and Gaussian-advantage RACER.

CPU-only: JAX_PLATFORMS=cpu python tools/gen_packing_golden.py
Writes tests/golden/packing_golden.npz
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden",
                   "packing_golden.npz")


def leaves_vec(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def capture(tr):
    """Comparison record: final params + replay-state invariants."""
    rs = tr.replay
    vs = rs.valid_steps()
    return {
        "params": leaves_vec(tr.params),
        "beta": np.asarray(rs.beta),
        "n_far": np.asarray(jnp.sum(rs.far_count)),
        "n_stored": np.asarray(rs.n_stored_steps()),
        "qret_sum": np.asarray(jnp.sum(jnp.where(vs, rs.qret, 0.0))),
        "rho_sum": np.asarray(jnp.sum(jnp.where(vs, rs.rho, 0.0))),
        "value_sum": np.asarray(jnp.sum(jnp.where(vs, rs.value, 0.0))),
    }


def build(env, mdp, algo_cls=None, **cfg_extra):
    from smarties_tpu.runtime.trainer import Trainer
    from smarties_tpu.utils.config import HyperParameters
    d = dict(minTotObsNum=256, maxTotObsNum=1024, batchSize=24,
             nnLayerSizes=[24], encoderLayerSizes=[24], explNoise=0.3,
             targetDelay=1e-3, randSeed=3)
    d.update(cfg_extra)
    cfg = HyperParameters(**d)
    return Trainer(env, mdp, cfg, n_envs=8, n_slots=64, max_len=128,
                   algo_cls=algo_cls)


def _vracer_fused():
    from smarties_tpu.envs import cartpole
    tr = build(cartpole, cartpole.MDP)
    tr.warmup(chunk=16)
    tr.train_fused(96, log_every=10 ** 9)
    return tr


def _dqn_train():
    from smarties_tpu.algos.dqn import DQN
    from smarties_tpu.envs import cartpole
    tr = build(cartpole.discrete, cartpole.discrete.MDP, DQN,
               learner="DQN", clipImpWeight=4.0,
               returnsEstimator="retrace")
    tr.warmup(chunk=16)
    tr.train(80, log_every=10 ** 9)
    return tr


def _acer():
    from smarties_tpu.algos.acer import ACER
    from smarties_tpu.envs import pendulum
    tr = build(pendulum, pendulum.MDP, ACER, learner="ACER",
               clipImpWeight=5.0)
    tr.warmup(chunk=16)
    tr.train(24, log_every=10 ** 9)
    return tr


def _ppo():
    from smarties_tpu.algos.ppo import PPO
    from smarties_tpu.envs import cartpole
    tr = build(cartpole, cartpole.MDP, PPO, learner="PPO",
               clipImpWeight=0.2, maxTotObsNum=512, obsPerStep=6.4)
    tr.train(48, log_every=10 ** 9)
    return tr


def _vracer_rnn():
    from smarties_tpu.envs import cartpole
    tr = build(cartpole, cartpole.MDP, nnType="LSTM", nnBPTTseq=8,
               nnLayerSizes=[16])
    tr.warmup(chunk=16)
    tr.train_fused(48, log_every=10 ** 9)
    return tr


def _racer_gauss():
    from smarties_tpu.algos.vracer import Racer
    from smarties_tpu.envs import cartpole
    tr = build(cartpole, cartpole.MDP, Racer)
    tr.warmup(chunk=16)
    tr.train_fused(48, log_every=10 ** 9)
    return tr


SCENARIOS = {
    "vracer_fused": _vracer_fused,
    "dqn_train": _dqn_train,
    "acer": _acer,
    "ppo": _ppo,
    "vracer_rnn": _vracer_rnn,
    "racer_gauss": _racer_gauss,
}


def main():
    rec = {}
    for name, fn in SCENARIOS.items():
        tr = SCENARIOS[name]()
        for k, v in capture(tr).items():
            rec[f"{name}/{k}"] = v
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **rec)
    print(f"wrote {OUT}: {len(rec)} entries")
    for k in sorted(rec):
        v = rec[k]
        print(f"  {k}: shape {v.shape} sum {float(np.sum(v)):.6g}")


if __name__ == "__main__":
    main()
