#!/usr/bin/env python3
"""Run-directory launcher CLI.

Re-implements the workflow of the reference's bin/smarties.py (run-dir
setup, settings staging, app selection, process math — README.rst:296-371):
creates a run directory, snapshots the resolved hyperparameters and git
provenance (gitlog.log analog, README.rst:404), and launches either a
built-in pure-JAX env recipe or a user app script through the Engine.

Examples:
    bin/smarties_tpu_launch.py cartpole --recipe VRACER --runname r0 \
        --nEnvironments 64 --nTrainSteps 100000
    bin/smarties_tpu_launch.py apps/cart_pole_py/exec.py --recipe VRACER \
        --runname ext0 --nEnvironments 8
"""
import argparse
import json
import os
import runpy
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


BUILTIN_ENVS = {"cartpole", "cartpole_discrete", "pendulum",
                "predator_prey", "glider", "catch", "acrobot",
                "mountaincar"}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("app", help="built-in env name or path to an app script")
    p.add_argument("--recipe", default="VRACER",
                   help="recipe name (utils/recipes.py) or settings json")
    p.add_argument("--runname", default="run00")
    p.add_argument("--runprefix", default="runs")
    p.add_argument("--nEnvironments", type=int, default=64)
    p.add_argument("--nTrainSteps", type=int, default=1_000_000)
    p.add_argument("--nLearners", type=int, default=1,
                   help="device-mesh learner shards")
    p.add_argument("--randSeed", type=int, default=0)
    p.add_argument("--maxEpisodeLength", type=int, default=1024)
    p.add_argument("--logAllSamples", action="store_true",
                   help="write agent_*_obs.raw raw-observation stream "
                        "(reference --logAllSamples analog)")
    p.add_argument("--appSettings", default="",
                   help="comma-separated staged app arg-files "
                        "(reference --appSettings)")
    p.add_argument("--nStepPappSett", default="",
                   help="comma-separated step budget per arg-file stage")
    p.add_argument("--setupFolder", default="",
                   help="folder copied into each per-sim run dir")
    p.add_argument("--simDirs", action="store_true",
                   help="run each env app launch in its own "
                        "simulation_%%03u_%%05u directory")
    args = p.parse_args(argv)

    run_dir = os.path.join(args.runprefix, args.runname)
    os.makedirs(run_dir, exist_ok=True)

    from smarties_tpu.utils.compile_cache import enable_compile_cache
    from smarties_tpu.utils.config import HyperParameters
    from smarties_tpu.utils.recipes import RECIPES
    enable_compile_cache()
    if args.recipe in RECIPES:
        cfg = HyperParameters.from_dict(RECIPES[args.recipe])
    else:
        cfg = HyperParameters.from_json(args.recipe)
    cfg.randSeed = args.randSeed

    # provenance snapshot (reference writes gitlog.log/gitdiff.log)
    with open(os.path.join(run_dir, "settings.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
    for cmd, fname in ((["git", "log", "-1", "--oneline"], "gitlog.log"),
                       (["git", "diff", "--stat"], "gitdiff.log")):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=10).stdout
            with open(os.path.join(run_dir, fname), "w") as f:
                f.write(out)
        except Exception:
            pass

    if args.app in BUILTIN_ENVS:
        from smarties_tpu.envs import (acrobot, cartpole, catch,
                                       glider, mountaincar, pendulum,
                                       predator_prey)
        from smarties_tpu.runtime.trainer import Trainer
        env = {"cartpole": cartpole,
               "cartpole_discrete": cartpole.discrete,
               "pendulum": pendulum,
               "predator_prey": predator_prey,
               "glider": glider,
               "catch": catch,
               "acrobot": acrobot,
               "mountaincar": mountaincar}[args.app]
        mesh = None
        if args.nLearners > 1:
            from smarties_tpu.parallel.mesh import make_mesh
            mesh = make_mesh(args.nLearners)
        if cfg.learner == "CMA":
            from smarties_tpu.algos.cma import CMAES
            cma = CMAES(env, env.MDP, cfg, n_envs=args.nEnvironments)
            cma.train(args.nTrainSteps)
            return
        import jax.numpy as jnp
        sdt = jnp.uint8 if args.app == "catch" else None
        tr = Trainer(env, env.MDP, cfg, n_envs=args.nEnvironments,
                     run_dir=run_dir, mesh=mesh, state_dtype=sdt,
                     max_len=min(args.maxEpisodeLength, env.MAX_STEPS),
                     obs_log=args.logAllSamples)
        tr.train(args.nTrainSteps)
        tr.save(os.path.join(run_dir, "checkpoint.pkl"))
        tr.close()
    else:
        # external app script: must define app_main(comm)
        mod = runpy.run_path(args.app)
        import smarties_tpu
        e = smarties_tpu.Engine([])
        e.setSettings(cfg)
        e.setNEnvironments(args.nEnvironments)
        e.setNTrainSteps(args.nTrainSteps)
        e.setMaxEpisodeLength(args.maxEpisodeLength)
        e.run_dir = run_dir
        if args.appSettings:
            e.setSimulationArgumentsFilePath(args.appSettings,
                                             args.nStepPappSett)
        if args.setupFolder:
            e.setSimulationSetupFolderPath(args.setupFolder)
        if args.simDirs:
            e.setUseSimulationDirectories(True)
        e.run(mod["app_main"])


if __name__ == "__main__":
    main()
