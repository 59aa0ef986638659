"""External-env serving throughput (states served per second).

Measures the Engine-side serving stack alone — EnvPool worker processes
+ event-driven poll_states + batched act + partial replies — with
trivially fast env apps, so the number is the serving ceiling (the
reference's analog hot loop is Master::waitForStateActionCallers,
Core/Master.cpp:118-144). Run CPU-only (the serving loop is
host-dominated; the act call is one small batched forward):

  JAX_PLATFORMS=cpu python tools/serving_bench.py \
      [n_envs] [seconds]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def fast_app(comm):
    comm.setStateActionDims(6, 1)
    comm.setActionScales([1.0], [-1.0], True)
    t = 0
    state = np.zeros(6)
    comm.sendInitState(state)
    while True:
        comm.recvAction()
        t += 1
        if t % 200 == 0:
            comm.sendTermState(state, 1.0)
            comm.sendInitState(state)
        else:
            comm.sendState(state, 0.1)


def main():
    n_envs = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 5.0
    import jax
    import jax.numpy as jnp
    from smarties_tpu.algos.vracer import VRacer
    from smarties_tpu.core.mdp import MDPSpec
    from smarties_tpu.runtime.env_pool import EnvPool
    from smarties_tpu.utils.config import HyperParameters

    pool = EnvPool(fast_app, n_envs, seed=0)
    mdp = pool.probe_spec()
    algo = VRacer(mdp, HyperParameters(nnLayerSizes=[128, 128],
                                       minTotObsNum=64,
                                       maxTotObsNum=1024))
    params, _ = algo.init(jax.random.PRNGKey(0))
    act = jax.jit(algo.make_act_fn(True))
    key = jax.random.PRNGKey(1)
    served = 0
    # warm the act compile
    obs = jnp.zeros((pool.n_lanes, mdp.dim_net_input))
    act(params, obs, key, ())
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        events, ready = pool.poll_states(timeout=0.05)
        served += len(events)
        if not ready:
            continue
        key, k = jax.random.split(key)
        a, mu, v, adv, _ = act(params, obs, k, ())
        acts = np.asarray(mdp.learner_to_env_action(a), np.float64)
        replies = [acts[i] if lane in set(ready) else None
                   for i, lane in enumerate(range(pool.n_lanes))]
        pool.send_actions(replies)
    dt = time.monotonic() - t0
    pool.kill()
    print(f"served {served} states in {dt:.1f}s with {n_envs} envs "
          f"-> {served / dt:,.0f} states/s")


if __name__ == "__main__":
    main()
