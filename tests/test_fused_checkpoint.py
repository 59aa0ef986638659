"""Trainer.train_fused failure and checkpoint behaviour.

A backend error inside the fused cycle propagates at once (no retry, no
sleep); Trainer.save/restore is the checkpoint path, and resuming from it
reproduces the uninterrupted run bitwise (cycle keys derive from the
carry, and the refresh cadence is part of the checkpoint).
"""
import jax
import numpy as np
import pytest

from smarties_tpu.envs import cartpole
from smarties_tpu.runtime.trainer import Trainer
from smarties_tpu.utils.config import HyperParameters

N_ENVS = 64


def _trainer():
    cfg = HyperParameters(minTotObsNum=512, maxTotObsNum=8192,
                          batchSize=32, obsPerStep=1.0,
                          nnLayerSizes=[16], randSeed=0)
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=N_ENVS, n_slots=256,
                 max_len=cartpole.MAX_STEPS)
    tr.log_flush_threshold = 10 ** 9
    tr.warmup(chunk=8, blind_sweeps=8)
    return tr


class _DeviceLost(RuntimeError):
    pass


def test_backend_error_propagates_without_sleep(monkeypatch):
    tr = _trainer()
    calls = {"n": 0}

    def lost(*a, **kw):
        calls["n"] += 1
        raise _DeviceLost("INTERNAL: device lost")

    def no_sleep(s):
        raise AssertionError("train_fused must not sleep on an error")

    tr._fused_cycle = lost
    monkeypatch.setattr("time.sleep", no_sleep)
    with pytest.raises(_DeviceLost):
        tr.train_fused(N_ENVS * 4, log_every=10 ** 9)
    assert calls["n"] == 1
    assert tr.n_grad_steps == 0


def test_save_restore_matches_uninterrupted_run(tmp_path):
    """N fused cycles, save, restore into a fresh Trainer, M more cycles
    == N+M uninterrupted cycles, bitwise. N crosses the 1000-step refresh
    cadence, so a restore that forgot the last refresh step would run an
    extra refresh and diverge."""
    n, m = 20, 4
    ref = _trainer()
    ref.train_fused(N_ENVS * (n + m), log_every=10 ** 9)

    first = _trainer()
    first.train_fused(N_ENVS * n, log_every=10 ** 9)
    path = str(tmp_path / "ckpt.pkl")
    first.save(path)
    resumed = _trainer()
    resumed.restore(path)
    resumed.train_fused(N_ENVS * m, log_every=10 ** 9)

    assert resumed.n_grad_steps == ref.n_grad_steps
    assert resumed.n_env_steps == ref.n_env_steps
    assert resumed._last_refresh == ref._last_refresh
    for a, b in zip(jax.tree_util.tree_leaves(
                        (ref.params, ref.opt_state, ref.carry)),
                    jax.tree_util.tree_leaves(
                        (resumed.params, resumed.opt_state,
                         resumed.carry))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
