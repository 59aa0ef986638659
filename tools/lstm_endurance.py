"""6M-step LSTM POMDP endurance run (VERDICT r4 #6 'done' criterion).

Runs the RACER_RNN recipe on the no-velocity cart-pole POMDP for 6M
grad steps of Trainer.train_fused unattended and reports wall time and
the final deterministic eval.

Run on the GPU as the only JAX process on the card.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

BUDGET = int(os.environ.get("LSTM_BUDGET", 6_000_000))


def main():
    import jax
    from smarties_tpu.envs.cartpole import pomdp
    from smarties_tpu.runtime.trainer import Trainer
    from smarties_tpu.utils import recipes

    d = dict(recipes.RECIPES["RACER_RNN"])
    d.update({"minTotObsNum": 65536, "maxTotObsNum": 262144})
    cfg = recipes.HyperParameters.from_dict(d)
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "curves", "runs",
        "racer_rnn_endurance")
    os.makedirs(out_dir, exist_ok=True)
    rew = os.path.join(out_dir, "agent_00_rank00_cumulative_rewards.dat")
    if os.path.exists(rew):
        os.remove(rew)
    tr = Trainer(pomdp, pomdp.MDP, cfg, n_envs=1024,
                 max_len=pomdp.MAX_STEPS, run_dir=out_dir)
    tr.log_flush_threshold = 10 ** 9
    print("built", flush=True)
    t0 = time.time()
    tr.warmup(chunk=16, blind_sweeps=max(16, cfg.minTotObsNum // 1024))

    def fence():
        np.asarray(jax.tree_util.tree_leaves(tr.params)[0].ravel()[0])

    while tr.n_grad_steps < BUDGET:
        step = min(BUDGET - tr.n_grad_steps, 262144)
        tr.train_fused(step, log_every=10 ** 9, flush=False)
        fence()
        print(f"{tr.n_grad_steps}/{BUDGET} ({time.time() - t0:.0f}s)",
              flush=True)
    wall = time.time() - t0
    tr._flush_logs()
    tr._rew_file.flush()
    ev = tr.evaluate(16, max_steps=pomdp.MAX_STEPS)
    summary = {
        "name": "racer_rnn_endurance", "recipe": "RACER_RNN",
        "env": "cartpole.pomdp", "grad_steps": tr.n_grad_steps,
        "env_steps": tr.n_env_steps, "wall_s": round(wall, 1),
        "episodes": sum(1 for _ in open(rew)) if os.path.exists(rew)
        else 0,
        "eval_mean": round(float(np.mean(ev)), 2),
        "eval_std": round(float(np.std(ev)), 2),
        "completed_unattended": True,
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
