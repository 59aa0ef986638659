"""Learning-curve parity artifacts (VERDICT r1 #7, r2 #5/#7/#8).

Runs recipe x env combos to convergence on one card, ALL IN ONE PROCESS
(one JAX process per card). Combos run sequentially: train, then flush +
eval, then the next combo.

Timing: train_combo ends with a device->host fence BEFORE stopping the
wall clock, so summary.json `wall_s` is real device execution time. The
per-combo `wall` cap gates on dispatch progress (it exists only to bound
runaway loops; the true bound is the grad-step budget).

Each run writes a reference-format agent_00_rank00_cumulative_rewards.dat
under docs/curves/runs/<name>/ and a JSON summary; `render` turns the
.dat files into docs/curves/<name>.png (raw episode returns at low alpha
+ trailing-mean line) plus a combined docs/curves/summary.png.

Reference analog: the learning curves of Novati & Koumoutsakos ICML'19
reproduced by the repo recipes (BASELINE.md comparison procedure); the
.dat format is MemoryBuffer.cpp:491-513.

Usage:
  python tools/learning_curves.py                 # run all + render
  python tools/learning_curves.py run A B ...     # subset + render
  python tools/learning_curves.py render          # re-render PNGs only
"""
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "curves")

# name -> dict(env, recipe, overrides, budget (grad steps), wall (s),
#              n_envs, [uint8] for pixel replays)
#
# Budgets are sized in env-steps-per-lane: at obsPerStep=1 each lane sees
# grad_steps/n_envs env steps.
COMBOS = {
    "vracer_pendulum": dict(
        env="pendulum", recipe="VRACER",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=2_000_000, wall=900, n_envs=1024),
    # DPG.json keeps lr 1e-5: pendulum needs a long horizon at that rate
    # (r3's 2M-step run plateaued at -574; solved needs ~3x the budget)
    "dpg_pendulum": dict(
        env="pendulum", recipe="DPG",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=6_000_000, wall=1800, n_envs=1024),
    # PPO.json horizon (maxTotObsNum) is 2048: min must come down with it.
    # Honest r4 note: the reference-faithful PPO (surrogate quirks of
    # PPO_train.cpp kept, see algos/ppo.py docstring) does NOT solve
    # pendulum at this budget (~-950 after 4M env steps; the r3 RESULTS
    # table's -479 was a stale row, its committed artifact said -982);
    # ppo_cartpole below is the implementation's solved record.
    "ppo_pendulum": dict(
        env="pendulum", recipe="PPO",
        over={"gamma": 0.99, "minTotObsNum": 2048},
        budget=120_000, wall=1800, n_envs=64),
    "ppo_cartpole": dict(
        env="cartpole", recipe="PPO",
        over={"minTotObsNum": 2048},
        budget=60_000, wall=1800, n_envs=64),
    # r5: faithful glider (ground-contact termination, goal |x-100|,
    # terminal bump reward — envs/glider.py). Episodes run ~120-500
    # steps; 4M grad steps = ~3900 env steps/lane = ~20+ episodes/lane
    "racer_glider": dict(
        env="glider", recipe="RACER_glider",
        over={"minTotObsNum": 65536},
        budget=4_000_000, wall=1800, n_envs=1024),
    # ---- r3: solved-threshold records for the weak algos (VERDICT #7) --
    "dqn_cartpole": dict(
        env="cartpole.discrete", recipe="DQN",
        over={"clipImpWeight": 4.0, "returnsEstimator": "retrace",
              "minTotObsNum": 65536, "maxTotObsNum": 262144},
        budget=1_500_000, wall=900, n_envs=1024),
    # ACER's whole-episode window step is far costlier than a 1-step
    # algo's: a smaller budget, which still solves cart-pole
    "acer_cartpole": dict(
        env="cartpole", recipe="ACER",
        over={"minTotObsNum": 65536, "maxTotObsNum": 131072},
        budget=250_000, wall=900, n_envs=1024),
    # NAF's quadratic advantage is a weak fit for bang-bang cart-pole
    # (reference-known); r3 at explNoise 0.4 / 3M steps evaluated 101.
    # r4 retune: milder OU noise so the greedy mean can stabilize, and
    # double the budget.
    "naf_cartpole": dict(
        env="cartpole", recipe="NAF",
        over={"explNoise": 0.2, "minTotObsNum": 65536,
              "maxTotObsNum": 262144},
        budget=6_000_000, wall=1800, n_envs=1024),
    # ---- r5: NAF Gaussian-advantage cross-check (VERDICT r4 #9): if
    # the bump advantage clears the quadratic variant's ~217 cap on
    # bang-bang cart-pole, the unimodal-advantage explanation holds ----
    "naf_gauss_cartpole": dict(
        env="cartpole", recipe="NAF",
        over={"nafAdvGaussian": True, "explNoise": 0.2,
              "minTotObsNum": 65536, "maxTotObsNum": 262144},
        budget=6_000_000, wall=1800, n_envs=1024),
    # ---- r5: standard-PPO mode records (VERDICT r4 #5): symmetric
    # advantage-sign clip + batch advantage normalization (ppoStandard;
    # the reference-faithful surrogate stays the default and its honest
    # non-learning records above stay committed) ----
    "ppo_std_cartpole": dict(
        env="cartpole", recipe="PPO",
        over={"minTotObsNum": 2048, "ppoStandard": True},
        budget=60_000, wall=1800, n_envs=64),
    "ppo_std_pendulum": dict(
        env="pendulum", recipe="PPO",
        over={"gamma": 0.99, "minTotObsNum": 2048,
              "ppoStandard": True},
        budget=240_000, wall=1800, n_envs=64),
    # ---- r5: second ACER record (VERDICT r4 #7) ----
    "acer_pendulum": dict(
        env="pendulum", recipe="ACER",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=250_000, wall=1200, n_envs=1024),
    "mixedpg_pendulum": dict(
        env="pendulum", recipe="VRACER",
        over={"learner": "MixedPG", "gamma": 0.99,
              "minTotObsNum": 65536, "maxTotObsNum": 131072},
        budget=2_000_000, wall=900, n_envs=1024),
    # ---- r3: classic-control coverage (VERDICT #8), 2 algos per env ----
    "vracer_acrobot": dict(
        env="acrobot", recipe="VRACER",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=1_000_000, wall=900, n_envs=1024),
    # acrobot is exploration-bound and defeats the reference's COMPILED
    # DQN default (Boltzmann softmax-over-Q: exploration collapses as
    # |Q| grows — training episodes do reach the goal, the near-greedy
    # policy never consolidates; r3+r4 runs at temperatures 1.0/2.0 all
    # evaluated -500). The reference's OTHER compile branch (the paper's
    # eps-greedy, DQN.cpp:71-81) solves it: constant eps = 0.3 with the
    # classic double-Q greedy bootstrap (dqnEpsGreedy).
    "dqn_acrobot": dict(
        env="acrobot", recipe="DQN",
        over={"dqnEpsGreedy": True, "explNoise": 0.3,
              "clipImpWeight": 0.0, "returnsEstimator": "none",
              "gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 262144},
        budget=2_000_000, wall=1200, n_envs=1024),
    "vracer_mountaincar": dict(
        env="mountaincar", recipe="VRACER",
        over={"gamma": 0.995, "explNoise": 0.8, "minTotObsNum": 65536,
              "maxTotObsNum": 262144},
        budget=1_500_000, wall=900, n_envs=1024),
    "dpg_mountaincar": dict(
        env="mountaincar", recipe="DPG",
        over={"gamma": 0.995, "explNoise": 0.6, "minTotObsNum": 65536,
              "maxTotObsNum": 262144},
        budget=1_500_000, wall=900, n_envs=1024),
    # ---- r3: conv learning proof (VERDICT #5): pixel Catch with the
    # RACER_atari-style recipe (Mnih conv stack, uint8 replay, bf16) ----
    "racer_catch": dict(
        env="catch", recipe="RACER_atari",
        over={"minTotObsNum": 8192, "maxTotObsNum": 65536,
              "nnBf16": True},
        budget=120_000, wall=900, n_envs=256, uint8=True,
        n_slots=2048),
    # ---- r4: recurrent POMDP record (VERDICT r3 #5): LSTM V-RACER on
    # no-velocity cart-pole under the reference RNN recipe
    # (settings/RACER_RNN.json: LSTM [32,32], nnBPTTseq 16) ----
    "racer_rnn_cartpole": dict(
        env="cartpole.pomdp", recipe="RACER_RNN",
        over={"minTotObsNum": 65536, "maxTotObsNum": 262144},
        budget=800_000, wall=1200, n_envs=1024),
    # ---- r4: RACER with Gaussian advantage (the full-RACER
    # instantiation, VERDICT r3 #7) ----
    "racer_pendulum": dict(
        env="pendulum", recipe="RACER",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=2_000_000, wall=1200, n_envs=1024),
    # ---- r4: RACER-ES (derivative-free VRACER_CMA path, VERDICT r3 #7;
    # population forwards make each grad step ~popsize x costlier) ----
    "vracer_cma_cartpole": dict(
        env="cartpole", recipe="VRACER_CMA",
        over={"minTotObsNum": 16384, "maxTotObsNum": 65536},
        budget=250_000, wall=1800, n_envs=1024),
}


def _import_env(name):
    if "." in name:
        mod, attr = name.split(".", 1)
        return getattr(importlib.import_module(
            f"smarties_tpu.envs.{mod}"), attr)
    return importlib.import_module(f"smarties_tpu.envs.{name}")


def train_combo(name):
    """Phase 1: build + train one combo with ZERO device->host
    transfers. Returns the live Trainer for the later flush/eval."""
    import jax.numpy as jnp
    from smarties_tpu.runtime.trainer import Trainer
    from smarties_tpu.utils import recipes

    c = COMBOS[name]
    env = _import_env(c["env"])
    d = dict(recipes.RECIPES[c["recipe"]])
    d.update(c["over"])
    cfg = recipes.HyperParameters.from_dict(d)
    run_dir = os.path.join(OUT, "runs", name)
    os.makedirs(run_dir, exist_ok=True)
    # truncate a previous run's rewards file (Trainer appends)
    rew = os.path.join(run_dir, "agent_00_rank00_cumulative_rewards.dat")
    if os.path.exists(rew):
        os.remove(rew)
    tr = Trainer(env, env.MDP, cfg, n_envs=c["n_envs"],
                 n_slots=c.get("n_slots"),
                 max_len=env.MAX_STEPS, run_dir=run_dir,
                 state_dtype=jnp.uint8 if c.get("uint8") else None)
    print(f"  [{name}] built ({time.strftime('%H:%M:%S')})", flush=True)
    import numpy as np

    def fence():
        np.asarray(__import__("jax").tree_util.tree_leaves(
            tr.params)[0].ravel()[0])

    t0 = time.time()
    if getattr(tr.algo, "on_policy", False):
        tr.train(c["budget"], log_every=10 ** 9, max_wall_s=c["wall"])
        fence()
    else:
        tr.log_flush_threshold = 10 ** 9   # transfer-free steady state
        tr.warmup(chunk=16,
                  blind_sweeps=max(16, cfg.minTotObsNum // c["n_envs"]))
        # dispatch in fenced slices so the wall cap gates REAL device
        # time (a pure-dispatch cap never fires: enqueue takes seconds)
        while (tr.n_grad_steps < c["budget"]
               and time.time() - t0 < c["wall"]):
            step = min(c["budget"] - tr.n_grad_steps, 131072)
            tr.train_fused(step, log_every=10 ** 9, flush=False)
            fence()
            print(f"  [{name}] {tr.n_grad_steps}/{c['budget']} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    tr._wall_s = time.time() - t0
    print(f"  [{name}] trained {tr.n_grad_steps} grad steps in "
          f"{tr._wall_s:.1f}s", flush=True)
    return tr


def finish_combo(name, tr):
    """Phase 2: flush deferred logs + deterministic eval (transfers)."""
    import numpy as np
    c = COMBOS[name]
    env = _import_env(c["env"])
    run_dir = os.path.join(OUT, "runs", name)
    rew = os.path.join(run_dir, "agent_00_rank00_cumulative_rewards.dat")
    tr._flush_logs()
    tr._rew_file.flush()
    ev = tr.evaluate(16, max_steps=env.MAX_STEPS)
    summary = {
        "name": name, "recipe": c["recipe"], "env": c["env"],
        "grad_steps": tr.n_grad_steps, "env_steps": tr.n_env_steps,
        "episodes": sum(1 for _ in open(rew)) if os.path.exists(rew)
        else 0,
        "wall_s": round(tr._wall_s, 1),
        "eval_mean": round(float(np.mean(ev)), 2),
        "eval_std": round(float(np.std(ev)), 2),
    }
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


def render():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    HUE = "#3056d3"      # one hue per panel: same entity, two weights
    def has_rows(n):
        p = os.path.join(OUT, "runs", n,
                         "agent_00_rank00_cumulative_rewards.dat")
        return os.path.exists(p) and os.path.getsize(p) > 0

    runs = [n for n in COMBOS if has_rows(n)]
    if not runs:
        print("no runs to render")
        return
    ncol = min(4, len(runs))
    nrow = (len(runs) + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol,
                             figsize=(4.2 * ncol, 3.4 * nrow),
                             squeeze=False)
    for k, name in enumerate(runs):
        ax = axes[k // ncol][k % ncol]
        dat = np.loadtxt(os.path.join(
            OUT, "runs", name, "agent_00_rank00_cumulative_rewards.dat"))
        x, r = dat[:, 1], dat[:, 4]
        o = np.argsort(x, kind="stable")
        x, r = x[o], r[o]
        w = max(1, len(r) // 200)
        mean = np.convolve(r, np.ones(w) / w, mode="valid")
        ax.plot(x, r, ".", ms=2, color=HUE, alpha=0.12,
                rasterized=True)
        ax.plot(x[w - 1:], mean, color=HUE, lw=2)
        s = json.load(open(os.path.join(OUT, "runs", name,
                                        "summary.json")))
        ax.set_title(f"{name}  (eval {s['eval_mean']:+.0f}"
                     f"±{s['eval_std']:.0f})", fontsize=10)
        ax.set_xlabel("env steps")
        ax.grid(alpha=0.25, lw=0.5)
        ax.spines[["top", "right"]].set_visible(False)
        fig2, ax2 = plt.subplots(figsize=(4.6, 3.4))
        ax2.plot(x, r, ".", ms=2, color=HUE, alpha=0.12, rasterized=True)
        ax2.plot(x[w - 1:], mean, color=HUE, lw=2)
        ax2.set_title(name, fontsize=11)
        ax2.set_xlabel("env steps")
        ax2.set_ylabel("episode return")
        ax2.grid(alpha=0.25, lw=0.5)
        ax2.spines[["top", "right"]].set_visible(False)
        fig2.tight_layout()
        fig2.savefig(os.path.join(OUT, f"{name}.png"), dpi=130)
        plt.close(fig2)
    for k in range(len(runs), nrow * ncol):
        axes[k // ncol][k % ncol].axis("off")
    axes[0][0].set_ylabel("episode return")
    fig.tight_layout()
    fig.savefig(os.path.join(OUT, "summary.png"), dpi=130)
    print("rendered", [f"{n}.png" for n in runs], "+ summary.png")


def main():
    if len(sys.argv) >= 2 and sys.argv[1] == "render":
        render()
        return
    names = (sys.argv[2:] if len(sys.argv) >= 3 and sys.argv[1] == "run"
             else list(COMBOS))
    os.makedirs(os.path.join(OUT, "runs"), exist_ok=True)
    for name in names:
        print(f"=== {name} ===", flush=True)
        try:
            tr = train_combo(name)
            finish_combo(name, tr)
            del tr
        except Exception as e:
            print(f"{name}: FAILED {e!r}", flush=True)
    render()


if __name__ == "__main__":
    main()
