"""Single-card benchmark: V-RACER on vectorized JAX cart-pole, plus the
Atari-scale conv train step.

Phases:
  fused     headline combined env+grad steps/s: one dispatch of K fused
            cycles (each an env sweep of 1024 obs, the at-ingest Retrace
            and 1024 ReF-ER grad steps at the reference's obsPerStep=1)
  steady    decoupled rollout sweep + standalone jitted train chunk
  atari     Atari-scale RACER train step (batch 128, Mnih 84x84x4 conv
            -> 512 dense, uint8 replay) + model TFLOP/s from the net's
            shapes
  quality   episodes-to-threshold on cart-pole, reference-default recipe,
            3 seeds (BASELINE.md primary gate: trailing-20-episode mean
            NOISY training return >= THRESHOLD) + a noise-free 32-episode
            eval of the deterministic policy

Every timed region ends in `jax.block_until_ready`. Run on the GPU:

    python bench.py

Prints ONE json line naming the device; exits non-zero if no GPU is found,
if the device is missing from PEAKS, or if any phase failed.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from smarties_tpu.utils.harness import (  # noqa: E402
    build_atari, build_trainer, card_info)

# quality gate: trailing-TRAIL-episode mean of NOISY training returns
# (explNoise 0.447 caps those near ~250 on cart-pole even when the
# deterministic policy scores 500/500 — "balancing under noise");
# the deterministic claim is proven by the separate noise-free eval,
# and the observed ceiling is emitted as noisy_return_ceiling.
THRESHOLD, TRAIL = 150.0, 20

# Published dense peaks per device_kind (NVIDIA H100 SXM data sheet, at
# the full 700 W power limit): FLOP/s in bf16 and TF32, HBM bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12,
                              "hbm": 3.35e12},
}


def device_summary() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def peaks_for(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       f"add them to bench.PEAKS with their source")
    return PEAKS[kind]


def make_macro(tr, K):
    """ONE compiled program of K fused cycles (env sweep + 1024 grad
    steps each)."""
    import jax
    import jax.numpy as jnp

    def macro(params, opt, carry):
        def body(c, i):
            p, o, cr = c
            p, o, cr, _ms, _logs = tr._fused_cycle(p, o, cr, 1,
                                                   tr.n_envs)
            return (p, o, cr), None
        return jax.lax.scan(body, (params, opt, carry),
                            jnp.arange(K, dtype=jnp.float32))[0]
    return jax.jit(macro)


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ======================================================================
# phases
# ======================================================================

def phase_fused(K=64):
    tr = build_trainer()
    tr.warmup(chunk=16, blind_sweeps=16)
    jm = make_macro(tr, K)
    state, compile_s = _timed(jm, tr.params, tr.opt_state, tr.carry)
    state, dt = _timed(jm, *state)
    tr.params, tr.opt_state, tr.carry = state
    tr._pending_logs.clear()
    steps = K * tr.n_envs
    return tr, {"combined_env_steps_per_s": steps / dt,
                "combined_grad_steps_per_s": steps / dt,
                "fused_cycle_ms": dt * 1e3 / K,
                "fused_first_call_s": compile_s}


def phase_steady(tr):
    import jax
    SW, NT = 64, 500      # rollout sweeps / train steps per dispatch
    (carry, _), _ = _timed(tr._rollout, tr.params, tr.carry, SW)
    (carry, _), dt_roll = _timed(tr._rollout, tr.params, carry, SW)
    tr.carry = carry
    key = jax.random.PRNGKey(1)
    args = (tr.params, tr.opt_state, tr.carry.replay, key, NT)
    _timed(tr._train_chunk, *args)
    _, dt_train = _timed(tr._train_chunk, *args)
    tr._pending_logs.clear()
    return {"rollout_env_steps_per_s": SW * tr.n_envs / dt_roll,
            "train_chunk_grad_steps_per_s": NT / dt_train}


def atari_flops_per_step(spec, batch):
    """Model FLOPs of one train step from the net's shapes: the forward
    runs over [s_t; s_t1] (2*batch rows), the backward over the batch's
    s_t rows only, with a weight gradient for every layer and an input
    gradient for every layer but the first conv (the frames need none):
    2*MACs*2B + 4*MACs*B - 2*MACs_conv1*B. (XLA's GPU cost analysis does
    not count the cuDNN convolutions, so it is not used.)"""
    from smarties_tpu.models.net import _mlp_in_dim
    conv = [c.out_h * c.out_w * c.filter ** 2 * c.in_c * c.out_c
            for c in spec.conv]
    sizes = [_mlp_in_dim(spec)] + list(spec.hidden) + [spec.n_out]
    macs = sum(conv) + sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return (8 * macs - 2 * (conv[0] if conv else 0)) * batch


def phase_atari(peaks, Q=1024):
    import jax
    algo, jf, args = build_atari(Q)
    _timed(jf, *args)
    best = min(_timed(jf, *args)[1] for _ in range(2))
    step_s = best / Q
    flops = atari_flops_per_step(algo.spec, algo.cfg.batchSize)
    # memory floor: EVERY train step streams the full f32 adam state
    # (read p/m/v/grad + write p/m/v = 28 B/param; models/optim.py)
    n_par = sum(int(x.size) for x in jax.tree_util.tree_leaves(args[0]))
    floor_s = n_par * 28 / peaks["hbm"]
    return {"atari_train_step_ms": step_s * 1e3,
            "atari_grad_steps_per_s": 1 / step_s,
            "atari_model_flops_per_step_g": flops / 1e9,
            "atari_model_tflops": flops / step_s / 1e12,
            # f32 convs/matmuls run on the tensor cores in TF32 at the
            # default precision, so TF32 is this step's FLOP roofline
            "atari_frac_of_tf32_peak": flops / step_s / peaks["tf32"],
            "atari_adam_hbm_floor_ms": floor_s * 1e3,
            "atari_adam_hbm_floor_frac": floor_s / step_s}


def phase_quality(seed, K=256, KC=16, TOPK=128):
    """Trains K fused cycles (K*1024 grad steps) in KC-cycle jitted
    chunks with the reference's every-1000-grad-steps refresh, tracking
    the trailing-TRAIL mean training return on device.

    Reference-default recipe except minTotObsNum 131072->65536 (the
    4096-slot ring cannot hold 131k obs of short random-policy warmup
    episodes)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax
    tr = build_trainer(seed)
    tr.cfg.minTotObsNum = tr.n_obs_b4_start = 65536
    tr.warmup(chunk=16, blind_sweeps=65536 // tr.n_envs)
    n_train = tr.n_envs                   # obsPerStep == 1 pacing

    def fold(trk, done, ret):
        # completed lanes first; at most TOPK completions per 1-step
        # sweep; completions beyond TOPK are counted, not dropped
        order = jnp.argsort(~done)
        d, r = done[order][:TOPK], ret[order][:TOPK]
        ovf = jnp.maximum(done.sum() - TOPK, 0)

        def push(t, dr):
            ring, cnt = t
            dd, rr = dr
            ring2 = jnp.where(dd, ring.at[cnt % TRAIL].set(rr), ring)
            return (ring2, cnt + dd.astype(jnp.int32)), None

        return lax.scan(push, trk, (d, r))[0], ovf

    def macro(params, opt, carry, trk, base):
        def body(c, i):
            p, o, cr, t = c
            p, o, cr, _ms, logs = tr._fused_cycle(p, o, cr, 1, n_train)
            t, ovf = fold(t, logs[0].reshape(-1), logs[2].reshape(-1))
            cr = cr._replace(replay=tr._refresh(
                cr.replay, (base + i + 1.0) * n_train))
            return (p, o, cr, t), (t[1], t[0].mean(), ovf)

        return lax.scan(body, (params, opt, carry, trk),
                        jnp.arange(KC, dtype=jnp.float32))

    jm = jax.jit(macro)
    trk = (jnp.zeros(TRAIL), jnp.zeros((), jnp.int32))
    p, o, carry = tr.params, tr.opt_state, tr.carry
    outs = []
    for c0 in range(0, K, KC):
        (p, o, carry, trk), out = jm(p, o, carry, trk, float(c0))
        outs.append(out)
    tr.params, tr.opt_state, tr.carry = p, o, carry
    tr._pending_logs.clear()
    cnts = np.concatenate([np.asarray(c) for c, _, _ in outs])
    means = np.concatenate([np.asarray(m) for _, m, _ in outs])
    ok = (cnts >= TRAIL) & (means >= THRESHOLD)
    ev = tr.evaluate(32)
    return {"seed": seed,
            "episodes_to_threshold": int(cnts[np.argmax(ok)])
            if ok.any() else None,
            "final_trail_mean": float(means[-1]),
            "noisy_return_ceiling": float(means.max()),
            "tracker_overflow_episodes": int(sum(
                int(np.asarray(v).sum()) for _, _, v in outs)),
            "eval_mean_deterministic": float(np.mean(ev))}


# ======================================================================
# main
# ======================================================================

def main():
    from smarties_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = device_summary()
    if dev["platform"] != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev['platform']}")
    peaks = peaks_for(dev["kind"])
    t_start = time.time()
    extras = {"card": card_info(), "n_envs": 1024, "batch_size": 256}
    errors = []
    value = None
    tr = None
    try:
        tr, head = phase_fused()
        extras.update(head)
        value = head["combined_env_steps_per_s"]
        extras.update(phase_steady(tr))
    except Exception as e:  # noqa: BLE001 — reported, exit code non-zero
        errors.append(f"fused/steady: {e!r}"[:300])
    del tr
    try:
        extras.update(phase_atari(peaks))
    except Exception as e:  # noqa: BLE001
        errors.append(f"atari: {e!r}"[:300])
    quality = []
    for seed in (0, 1, 2):
        try:
            quality.append(phase_quality(seed))
        except Exception as e:  # noqa: BLE001
            errors.append(f"quality{seed}: {e!r}"[:300])
    if quality:
        extras["episodes_to_threshold"] = [
            q["episodes_to_threshold"] for q in quality]
        extras["eval_mean_deterministic"] = [
            q["eval_mean_deterministic"] for q in quality]
        extras["final_trail_mean"] = [q["final_trail_mean"] for q in quality]
    extras["wall_s"] = time.time() - t_start
    if errors:
        extras["errors"] = errors
    print(json.dumps({"metric": "combined_env_steps_per_s", "value": value,
                      "unit": "env-steps/s/card", "device": dev,
                      "extras": extras}))
    if errors:
        sys.exit(1)


if __name__ == "__main__":
    main()
