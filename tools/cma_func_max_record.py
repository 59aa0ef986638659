"""CMA convergence record on the func_maximization app (VERDICT r3 #7).

Reference analog: apps/func_maximization + settings/CMA.json — CMA over
an external Communicator app using the optimization-interface sugar.
Runs CPU-only (the CMA update is tiny; run while the chip is busy):

  JAX_PLATFORMS=cpu python tools/cma_func_max_record.py

Writes docs/curves/runs/cma_func_max/summary.json + curve.json.
Solved = |mean_action - 0.4| small => objective < 1e-3 (optimum 0).
"""
import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "..", "docs", "curves",
                   "runs", "cma_func_max")


def main():
    import jax
    from apps.func_maximization.exec import DIM, app_main, objective
    from smarties_tpu.algos.cma import CMAES
    from smarties_tpu.runtime.env_pool import EnvPool
    from smarties_tpu.utils.config import HyperParameters

    # reference CMA.json scaled to the toy problem: popsize 8, lr 0.05
    cfg = HyperParameters(learner="CMA", ESpopSize=8, batchSize=4,
                          explNoise=0.0, nnLayerSizes=[8], learnrate=0.05,
                          randSeed=1)
    pool = EnvPool(app_main, n_envs=8)
    mdp = pool.probe_spec()
    cma = CMAES(None, mdp, cfg, n_envs=8, max_len=4)
    buf = io.StringIO()
    with redirect_stdout(buf):
        cma.run_external(pool, n_generations=60, log_every=1)
    pool.kill()
    log = buf.getvalue()
    curve = [[int(g), float(r)] for g, r in
             re.findall(r"gen\s+(\d+) \| avgR\s+([-\d.eE+]+)", log)]

    # evaluate the converged CMA MEAN policy's action on the objective:
    # the policy net maps the dummy state to the proposed parameters
    st = cma.state
    mean_tree = cma.unravel(st.mean)
    obs = np.zeros((1, mdp.dim_state), np.float32)
    obs_std = (obs - np.asarray(st.state_mean)) * np.asarray(
        st.state_scale)
    a = cma._act(mean_tree, jax.numpy.asarray(obs_std),
                 jax.random.PRNGKey(0))
    x = np.asarray(mdp.learner_to_env_action(a))[0]
    final_obj = objective(x)

    os.makedirs(OUT, exist_ok=True)
    summary = {
        "name": "cma_func_max", "recipe": "CMA",
        "app": "apps/func_maximization", "dim": DIM,
        "generations": len(curve),
        "final_avg_return": curve[-1][1] if curve else None,
        "final_objective": round(final_obj, 6),
        "proposed_x": [round(float(v), 4) for v in x],
        "optimum_x": 0.4,
        "solved": bool(final_obj < 1e-3),
    }
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(OUT, "curve.json"), "w") as f:
        json.dump(curve, f)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
