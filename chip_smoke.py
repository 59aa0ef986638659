#!/usr/bin/env python3
"""Proof that the main path runs on the GPU, through the user entry points.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: only the sharded learners

One-card phases, all in this one process (a JAX process reserves most of
the card's memory, so no phase starts a second one):

  device     platform, device kind and count, JAX version, the card's name
             and power limit, the matmul precision in effect
  fused      V-RACER cart-pole at bench.py's width: Trainer.warmup, then
             Trainer.train_fused for 4 cycles of 1024 grad steps
  launcher   bin/smarties_tpu_launch.py's main() for cartpole/VRACER with
             1024 env lanes, past the warmup's transient: the unfused
             Trainer.train path, rollouts alternating with train chunks,
             with its at-ingest and refresh Retrace sweeps
  retrace    the full-buffer Retrace/GAE sweep at [4096, 501] against a
             float64 NumPy recursion, and its time
  atari      the Atari-scale conv train step, its forward against the CPU
             backend, and one V-RACER grad step against the CPU backend
  engine     smarties_tpu.Engine serving apps/cart_pole_py/exec.py from 8
             forked env workers, under its own time limit

Any failed phase or comparison exits non-zero. The last line of standard
output is one JSON object naming the device.
"""
import argparse
import json
import os
import signal
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402


def log(*a):
    print(*a, flush=True)


def _finite(tree) -> bool:
    import jax
    return all(bool(np.isfinite(np.asarray(x)).all())
               for x in jax.tree_util.tree_leaves(tree))


def _check_close(name, got, want, rtol, atol, precision):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    worst = float((err / (atol + rtol * np.abs(want))).max())
    log(f"  {name}: max|diff| {float(err.max()):.3e}, "
        f"tolerance rtol {rtol:g} atol {atol:g}, precision {precision}, "
        f"worst ratio to tolerance {worst:.3f}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


def _ms(fn, *args, reps=5):
    """Median wall ms of fn(*args), each call ended by block_until_ready
    (one untimed call first)."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


# ----------------------------------------------------------------------
def phase_device(n_cards):
    import jax
    from smarties_tpu.utils.harness import card_info
    devs = jax.devices()
    d = devs[0]
    log(f"device: platform {d.platform}, kind {d.device_kind}, "
        f"count {len(devs)}, jax {jax.__version__}")
    if d.platform != "gpu" or len(devs) < n_cards:
        raise RuntimeError(f"needs {n_cards} GPU(s); JAX found "
                           f"{len(devs)} {d.platform} device(s)")
    log(f"card: {card_info()}")
    prec = jax.config.jax_default_matmul_precision
    log(f"matmul precision: {prec or 'default (TF32 for f32 on this card)'}")


def phase_fused(n_envs=1024, n_slots=4096, batch=256, min_tot=16384,
                max_tot=262144, cycles=4):
    import jax
    from smarties_tpu.utils.harness import build_trainer
    tr = build_trainer(n_envs=n_envs, n_slots=n_slots, batch=batch,
                       max_tot=max_tot, min_tot=min_tot)
    t0 = time.time()
    tr.warmup()
    g0, e0 = tr.n_grad_steps, tr.n_env_steps
    tr.train_fused(cycles * n_envs, log_every=10 ** 9)
    jax.block_until_ready(tr.params)
    dt = time.time() - t0
    rs = tr.replay
    valid = np.asarray(rs.valid_slots())
    qret = np.asarray(rs.qret)[valid]
    log(f"  warmup + {cycles} fused cycles in {dt:.1f} s (compile "
        f"included); grad steps {g0} -> {tr.n_grad_steps}, env steps "
        f"{e0} -> {tr.n_env_steps}, episodes stored {int(valid.sum())}")
    if tr.n_grad_steps - g0 != cycles * n_envs:
        raise AssertionError("grad-step ledger did not advance by "
                             f"{cycles} cycles")
    if tr.n_env_steps - e0 != cycles * n_envs:
        raise AssertionError("env-step ledger did not advance by "
                             f"{cycles} sweeps")
    if not valid.any():
        raise AssertionError("no episode was stored")
    for name, x in (("params", tr.params), ("metrics", tr._last_metrics),
                    ("qret", qret)):
        if not _finite(x):
            raise AssertionError(f"non-finite {name}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    return tr


def phase_launcher(n_envs=1024, steps=24000, runprefix=None,
                   recipe="VRACER"):
    """The launcher's unfused Trainer.train loop. At 1024 lanes the warmup
    overshoots minTotObsNum by the in-flight episodes (18,432 env steps
    for the VRACER recipe), and the pacing ledger spends that on grad
    steps before the next sweep; `steps` runs past it, so rollouts and
    train chunks alternate, and an episode logged after the first grad
    step shows that they did."""
    import runpy
    launch = runpy.run_path(os.path.join(HERE, "bin",
                                         "smarties_tpu_launch.py"))["main"]
    runprefix = runprefix or os.path.join(HERE, "runs")
    run_dir = os.path.join(runprefix, "chip_smoke_launcher")
    rew = os.path.join(run_dir, "agent_00_rank00_cumulative_rewards.dat")
    if os.path.exists(rew):
        os.remove(rew)
    t0 = time.time()
    launch(
        ["cartpole", "--recipe", recipe, "--nEnvironments", str(n_envs),
         "--nTrainSteps", str(steps), "--runprefix", runprefix,
         "--runname", "chip_smoke_launcher"])
    # rows: [grad-step, env-step, agent, length, return] per episode
    rows = np.loadtxt(rew, ndmin=2)
    if not os.path.exists(os.path.join(run_dir, "settings.json")):
        raise AssertionError("settings.json missing from the run dir")
    if not len(rows) or not np.isfinite(rows).all():
        raise AssertionError("empty or non-finite cumulative rewards")
    warm = rows[rows[:, 0] == 0]
    live = rows[rows[:, 0] > 0]
    log(f"  launcher ran {steps} grad steps in {time.time() - t0:.1f} s; "
        f"{len(warm)} episodes logged in warmup (to env step "
        f"{int(warm[:, 1].max()) if len(warm) else 0}), {len(live)} while "
        f"training (grad steps {int(live[:, 0].min()) if len(live) else 0}"
        f"..{int(rows[-1, 0])}, to env step {int(rows[-1, 1])})")
    if not len(live) or live[:, 1].max() <= warm[:, 1].max(initial=0):
        raise AssertionError("no env steps were collected after warmup: "
                             "the rollout/train alternation never ran")


def retrace_inputs(E, L, seed=0):
    """Random full-buffer inputs: lengths in [1, L], half terminal."""
    rng = np.random.RandomState(seed)
    L1 = L + 1
    r = rng.randn(E, L1).astype(np.float32)
    v = rng.randn(E, L1).astype(np.float32)
    a = rng.randn(E, L1).astype(np.float32)
    rho = np.exp(0.5 * rng.randn(E, L1)).astype(np.float32)
    length = rng.randint(1, L + 1, E).astype(np.int32)
    length[0] = L
    terminal = rng.rand(E) < 0.5
    return r, v, a, rho, length, terminal


def phase_retrace(E=4096, L=500, tr=None, gamma=0.995, lam=0.95):
    import jax
    import jax.numpy as jnp
    from functools import partial
    from smarties_tpu.ops.returns import batched_return_estimate
    from smarties_tpu.utils.harness import reference_return_estimate
    inputs = retrace_inputs(E, L)
    dev_in = [jnp.asarray(x) for x in inputs]
    for mode in ("retrace", "GAE"):
        f = jax.jit(partial(batched_return_estimate, gamma=gamma, lam=lam,
                            mode=mode))
        got = f(*dev_in)
        want = reference_return_estimate(*inputs, gamma, lam, mode)
        _check_close(f"{mode} [{E}, {L + 1}] vs float64 recursion", got,
                     want, 1e-4, 1e-4, "float32 elementwise")
        log(f"  {mode} sweep alone: {_ms(f, *dev_in):.3f} ms")
    if tr is not None:
        # one 1024-step fused cycle followed by the full refresh, the
        # cadence train_fused runs them at
        def cycle_refresh(p, o, c):
            p, o, c, _, _ = tr._fused_cycle(p, o, c, 1, tr.n_envs)
            return p, o, c._replace(replay=tr._refresh(c.replay, 1e3))
        f = jax.jit(cycle_refresh)
        args = (tr.params, tr.opt_state, tr.carry)
        log(f"  refresh alone at [{tr.n_slots}, {tr.max_len + 1}]: "
            f"{_ms(jax.jit(tr.algo.refresh), tr.carry.replay, 1e3):.3f} ms; "
            f"fused cycle + refresh: {_ms(f, *args):.3f} ms")


def phase_atari(tr=None, Q=4, E=512, L=128, image=84, batch=128):
    import jax
    import jax.numpy as jnp
    from smarties_tpu.models.net import apply_net
    from smarties_tpu.utils.harness import build_atari
    algo, jf, args = build_atari(Q, E=E, L=L, batch=batch, image=image)
    compiled = jf.lower(*args).compile()
    log(f"  atari step memory_analysis: {compiled.memory_analysis()}")
    params, _, _ = compiled(*args)
    jax.block_until_ready(params)
    if not _finite(params):
        raise AssertionError("atari params non-finite after "
                             f"{Q} scanned steps")
    log(f"  atari: {Q} scanned steps, params finite")

    cpu = jax.devices("cpu")[0]
    x = jax.random.uniform(jax.random.PRNGKey(3),
                           (batch, algo.spec.n_in), jnp.float32, -2, 2)

    def fwd(p, x):
        return apply_net(p, algo.spec, x)[0]

    with jax.default_matmul_precision("highest"):
        y_dev = jax.jit(fwd)(params, x)
        y_cpu = jax.jit(fwd)(jax.device_put(params, cpu),
                             jax.device_put(x, cpu))
    _check_close("conv forward, card vs CPU", y_dev, y_cpu, 1e-4, 1e-5,
                 "highest")
    y_tf32 = jax.jit(fwd)(params, x)
    log(f"  conv forward at default precision: max|diff| vs CPU "
        f"{float(np.abs(np.asarray(y_tf32) - np.asarray(y_cpu)).max()):.3e}"
        f" (not gated)")

    if tr is not None:
        # one V-RACER grad step on the trained state, same minibatch
        from smarties_tpu.algos.base import presample_uniform
        ks = jax.random.split(jax.random.PRNGKey(4), 1)
        eps, ts = presample_uniform(ks, tr.replay, tr.cfg.batchSize)

        def step(p, o, r, k, e, t):
            return tr.algo.train_step(p, o, r, k,
                                      sample_override=(e, t))[0]

        state = (tr.params, tr.opt_state, tr.replay, ks[0], eps[0], ts[0])
        with jax.default_matmul_precision("highest"):
            p_dev = jax.jit(step)(*state)
            p_cpu = jax.jit(step)(*jax.device_put(state, cpu))
        for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(p_dev),
                                       jax.tree_util.tree_leaves(p_cpu))):
            _check_close(f"V-RACER grad step, param leaf {i}", a, b,
                         1e-4, 1e-6, "highest")


class _PhaseTimeout(Exception):
    pass


def phase_engine(n_workers=8, steps=300, limit_s=600, run_dir=None):
    """The Engine forks its env workers after this process has started
    the CUDA backend; SIGALRM bounds the phase so a hang fails it (the
    Engine's finally kills the workers)."""
    import runpy
    import smarties_tpu
    from smarties_tpu.utils.config import HyperParameters
    app = runpy.run_path(os.path.join(HERE, "apps", "cart_pole_py",
                                      "exec.py"))["app_main"]
    run_dir = run_dir or os.path.join(HERE, "runs", "chip_smoke_engine")
    rew = os.path.join(run_dir, "agent_00_rank00_cumulative_rewards.dat")
    if os.path.exists(rew):
        os.remove(rew)
    e = smarties_tpu.Engine([])
    e.setSettings(HyperParameters(
        learner="VRACER", nnLayerSizes=[128, 128], batchSize=256,
        minTotObsNum=1024, maxTotObsNum=16384, obsPerStep=1.0))
    e.setNEnvironments(n_workers)
    e.setNTrainSteps(steps)
    e.setMaxEpisodeLength(500)
    e.run_dir = run_dir

    def on_alarm(signum, frame):
        raise _PhaseTimeout(f"engine phase exceeded {limit_s} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(limit_s)
    t0 = time.time()
    try:
        e.run(app)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    b = e.learners[0]
    rows = np.loadtxt(rew, ndmin=2) if os.path.exists(rew) else []
    log(f"  engine: {n_workers} forked workers, {b.n_grad} grad steps, "
        f"{b.n_env_steps} env steps, {len(rows)} episodes in "
        f"{time.time() - t0:.1f} s")
    if b.n_grad < steps:
        raise AssertionError(f"engine stopped at {b.n_grad} grad steps")
    if not len(rows) or not _finite(b.params):
        raise AssertionError("engine logged no episode or params non-finite")


def phase_four(n_envs=1024, n_slots=4096, steps=2000, n_cards=4,
               batch=256, min_tot=16384, max_tot=262144):
    """Data-parallel learners over a 1-D `learners` mesh of n_cards."""
    import jax
    from smarties_tpu.parallel.mesh import make_mesh
    from smarties_tpu.runtime.trainer import Trainer
    from smarties_tpu.utils.harness import build_trainer, grad_parity
    mesh = make_mesh(n_cards)
    ref = build_trainer(n_envs=n_envs, n_slots=n_slots, batch=batch,
                        min_tot=min_tot, max_tot=max_tot)
    tr = Trainer(ref.env, ref.mdp, ref.cfg, n_envs=n_envs, n_slots=n_slots,
                 max_len=ref.max_len, mesh=mesh)
    del ref
    t0 = time.time()
    tr.warmup()
    tr.train(steps, log_every=10 ** 9)
    jax.block_until_ready(tr.params)
    log(f"  sharded trainer: {tr.n_grad_steps} grad steps, "
        f"{tr.n_env_steps} env steps, last refresh at {tr._last_refresh} "
        f"in {time.time() - t0:.1f} s")
    if tr._last_refresh < 1000 or not _finite(tr.params):
        raise AssertionError("no refresh ran, or params non-finite")
    env_leaf = jax.tree_util.tree_leaves(tr.carry.env_state)[0]
    for name, x in (("replay.steps", tr.replay.steps),
                    ("env state", env_leaf)):
        devs = {s.device for s in x.addressable_shards}
        rows = {s.data.shape[0] for s in x.addressable_shards}
        log(f"  {name}: {len(devs)} shards on {sorted(map(str, devs))}, "
            f"rows per shard {sorted(rows)} of {x.shape[0]}")
        if len(devs) != n_cards or rows != {x.shape[0] // n_cards}:
            raise AssertionError(f"{name} is not split over {n_cards} "
                                 "distinct devices")
    p1, p4 = grad_parity(n_cards)
    for i, (a, b) in enumerate(zip(p1, p4)):
        _check_close(f"1 vs {n_cards} devices, param leaf {i}", b, a,
                     1e-5, 1e-6, "highest")


# ----------------------------------------------------------------------
def _run(name, fn, *args, **kw):
    log(f"[{name}]")
    t0 = time.time()
    out = fn(*args, **kw)
    log(f"[{name}] ok in {time.time() - t0:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the data-parallel path on four cards")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1

    from smarties_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"compile cache: {cache} ({n_cached} entries at start)")
    import jax
    t0 = time.time()
    _run("device", phase_device, n_cards)
    if args.four:
        _run("four", phase_four, n_cards=n_cards)
    else:
        tr = _run("fused", phase_fused)
        _run("retrace", phase_retrace, tr=tr)
        _run("atari", phase_atari, tr=tr)
        del tr
        _run("launcher", phase_launcher)
        _run("engine", phase_engine)
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"compile cache: {n_cached} entries at end; all phases passed in "
        f"{time.time() - t0:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
